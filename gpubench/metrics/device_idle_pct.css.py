"""device_idle_pct.css (device trace): the share of the traced span of CSS
scans in which no kernel, copy or memset ran on the card, in %."""


def read(run):
    tr = run.trace
    if run.traffic["scan"] != "css" or tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
