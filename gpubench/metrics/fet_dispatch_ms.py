"""fet_dispatch_ms (program span): the mean per genome scan of the FET
engine's ``fet_dispatch`` stage (window plans, uploads and every
chromosome's kernels enqueued), in ms."""


def read(run):
    if run.traffic["scan"] != "fet" or not run.scans:
        return None
    return sum(s.timings_s.get("fet_dispatch", 0.0) for s in run.scans) / len(run.scans) * 1e3
