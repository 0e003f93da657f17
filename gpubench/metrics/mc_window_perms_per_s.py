"""mc_window_perms_per_s (program span): the window permutations the MC
consumed, over the seconds of the ``css_mc`` stage, summed over the
window's scans.  The permutations are counted from each group's checked
p-values (``gpubench.scans.group_work``), the seconds are the engine's."""


def read(run):
    if run.traffic["scan"] != "css":
        return None
    secs = sum(s.timings_s.get("css_mc", 0.0) for s in run.scans)
    perms = sum(w["permutations"] for w in run.work)
    return perms / secs if secs > 0 and perms > 0 else None
