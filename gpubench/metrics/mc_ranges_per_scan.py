"""mc_ranges_per_scan (program counter): the ranges of chunks the MC ran
(the ``mc_ranges`` counter; each range ends in one host sync), per scan
of the window."""


def read(run):
    if run.traffic["scan"] != "css" or not run.scans:
        return None
    total = sum(s.counters.get("mc_ranges", 0) for s in run.scans)
    return total / len(run.scans) if total > 0 else None
