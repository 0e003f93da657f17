"""css_mc_ms (program span): the mean per scan of the CSS engine's
``css_mc`` stage (the permutation MC of every valid window), in ms."""


def read(run):
    if run.traffic["scan"] != "css" or not run.scans:
        return None
    return sum(s.timings_s.get("css_mc", 0.0) for s in run.scans) / len(run.scans) * 1e3
