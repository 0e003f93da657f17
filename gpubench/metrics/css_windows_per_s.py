"""css_windows_per_s (host clock): CSS windows scored, each with its
p-value, over the whole window's seconds.  A scan's windows are counted
from its group's checked answers (slots with p > 0,
``gpubench.scans.group_work``), not from the program's counters."""


def read(run):
    if run.traffic["scan"] != "css":
        return None
    return sum(w["scored"] for w in run.work) / run.window_s
