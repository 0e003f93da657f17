"""scan_p95_ms.css (host clock, per layer): the 95th percentile (linear
interpolation) of the wall of every CSS scan in the window, in ms: the
tail of the engine's calls, read where a window holds some hundreds of
scans.  A per-layer metric: on a shared host the tail of a call that the
host holds for a quarter of its time spreads too widely between runs to
carry an end-to-end bound."""

import numpy as np


def read(run):
    if run.traffic["scan"] != "css" or not run.scans:
        return None
    return float(np.percentile([s.wall_s for s in run.scans], 95)) * 1e3
