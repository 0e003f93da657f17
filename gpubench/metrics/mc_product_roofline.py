"""mc_product_roofline (device trace): the share of its roofline that the
MC's shared-stream product reaches in the traced span, in %.

The role: every permutation a window consumed scored against the window's
m x m distances, the hits tested and the stop found.  Its least time
follows ``chip_smoke.py``'s reckoning for K7 (``k7_case``), from the
inputs, with the work of a permutation counted as the a*b + m - 2 nonzero
terms of its coefficients (``kernels/perm.py:nonzero_walk``; the dense
product K7 runs multiplies all m^2): a multiply-add a term and consumed
permutation at the float32 peak (the scores are full float32), or the
bytes of the distances in, three values a window out and the coefficients
of the permutations consumed, whichever is longer.  The windows and
permutations are counted from each traced group's checked p-values
(``gpubench.scans.group_work``).  Its device time is that of the kernels
that fill the role today: K7's coefficient, product and scan kernels.
"""

from gpubench.roofline import bound_s

KERNELS = ("css_mc_coeff", "css_mc_coeff_rank", "css_mc_coeff_write", "css_mc_shared_tile",
           "css_mc_scan")


def read(run):
    tr = run.trace
    if run.traffic["scan"] != "css" or tr is None or not tr.complete:
        return None
    dev_s = tr.kernel_seconds(KERNELS)
    work = [run.group_work[g] for g in tr.order]
    perms = sum(w["permutations"] for w in work)
    windows = sum(w["scored"] for w in work)
    if dev_s <= 0 or perms <= 0 or windows <= 0:
        return None
    a, b = run.config["asize"], run.config["bsize"]
    m = a + b
    nbytes = windows * (m * m * 4 + 16) + m * m * 4 * perms / windows
    return 100.0 * bound_s(nbytes, {"f32": 2 * (a * b + m - 2) * perms})[0] / dev_s
