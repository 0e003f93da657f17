"""css_plan_ms (program span): the mean per scan of the CSS engine's
``css_plan`` span (each chromosome's window plan, valid mask and
restart key, on the host), in ms."""


def read(run):
    if run.traffic["scan"] != "css" or not run.scans:
        return None
    total = sum(s.timings_s.get("css_plan", 0.0) for s in run.scans)
    return total / len(run.scans) * 1e3 if total > 0 else None
