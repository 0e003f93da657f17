"""idle_unattributed_pct.css (device trace): the share of the card's idle
time in the traced span of CSS scans that no span of the program names,
in %: the seconds of the idle gaps (``breakdown.idle_gaps``, each named by
the innermost host activity at its middle) named by the benchmark's own
scan range or by no host activity at all, over the span's idle seconds.
The gap list holds the ten largest names; a name below them is smaller
than each of them."""

UNNAMED = ("gpubench.scan", "host (no range)")


def read(run):
    tr = run.trace
    if run.traffic["scan"] != "css" or tr is None or not tr.idle_gaps:
        return None
    idle = tr.window_s - tr.busy_s
    if idle <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * sum(s for name, s in tr.idle_gaps if name in UNNAMED) / idle
