"""css_phase1_ms (program span): the mean per scan of phase 1's stages of
the CSS engine's RunSummary (css_dispatch + css_phase1_sync + css_collect:
the upload, K3 and K5 enqueued, the host sync for the scores, the valid
windows' distances gathered), in ms."""

STAGES = ("css_dispatch", "css_phase1_sync", "css_collect")


def read(run):
    if run.traffic["scan"] != "css" or not run.scans:
        return None
    return sum(s.timings_s.get(k, 0.0) for s in run.scans for k in STAGES) / len(run.scans) * 1e3
