"""cmds_roofline (device trace): the share of its roofline that the CMDS
step (fill, centring, the top two eigenpairs, the embedding's distances and
score of every window phase 1 scores) reaches in the traced span, in %.

Its least time is ``chip_smoke.py``'s reckoning for K5: the (4/3) m^3
operations of a tridiagonal reduction a window at the precision's rate, or
the bytes of the dissimilarities in and the distances, score and flag out,
whichever is longer.  Its windows are every window with SNPs of the
traced groups (the engine sends each to CMDS).  Its device time is that of the kernels that fill the
role today: K5 (``css_cmds``) and K5 large (``css_cmds_block``).
"""

from gpubench.roofline import bound_s

KERNELS = ("css_cmds", "css_cmds_block")


def read(run):
    tr = run.trace
    if run.traffic["scan"] != "css" or tr is None or not tr.complete:
        return None
    dev_s = tr.kernel_seconds(KERNELS)
    windows = sum(run.group_work[g]["windows"] for g in tr.order)
    if dev_s <= 0 or windows <= 0:
        return None
    m = run.config["asize"] + run.config["bsize"]
    esize, rate = (4, "f32") if run.config["precision"] == "fast" else (8, "f64")
    nbytes = windows * (2 * m * m * esize + 8 + esize + 1)
    return 100.0 * bound_s(nbytes, {rate: windows * 4 * m ** 3 // 3})[0] / dev_s
