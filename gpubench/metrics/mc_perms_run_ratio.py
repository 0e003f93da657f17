"""mc_perms_run_ratio (program counter): the permutations the MC's
product computed (the ``mc_perms_run`` counter: running windows x chunks
x chunk, summed over its ranges) over those the windows consumed, counted
from the checked p-values (``gpubench.scans.group_work``), summed over the
window's scans: near 1 where windows run to the cap, above it where
windows stop inside a range."""


def read(run):
    if run.traffic["scan"] != "css" or not run.scans:
        return None
    ran = sum(s.counters.get("mc_perms_run", 0) for s in run.scans)
    used = sum(w.get("permutations", 0) for w in run.work)
    return ran / used if ran > 0 and used > 0 else None
