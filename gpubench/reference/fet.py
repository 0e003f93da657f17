"""Plain reference of the FET scan: each SNP's two-tailed Fisher exact test
on its 2x2 table of homozygote counts (the Zar shortcut of the reference
tools, ``statistics/fisher/cFisher.c:405-455``), each window's
interpolated percentile of -log10 p, and the stddev of ``nsamples``
bootstrap percentiles drawn by the Renyi order-statistic recursion on the
window's threefry stream.

The arithmetic follows ``divergence_tpu_torch/kernels/fet.py``
(``fet_two_tailed``, ``_interp_ranks``, ``_order_stat_uniforms``,
``_aggregate_sorted``), copied into plain torch: values in float64, and,
where the configuration states float32, the discrete choices that its
stream makes in float32 (the interpolation rank, the bootstrap's ranks
from float32 uniforms), so that the same stream picks the same order
statistics.  ``prec="bf16"`` is the control: every value rounded to
bfloat16 where it is made.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference import rng
from gpubench.reference.windows import WindowPlan

WINDOW_BATCH = 32_768


def rounder(prec: str):
    """The value rounding of a precision: none for the reference, to
    bfloat16 for the control."""
    if prec == "f64":
        return lambda x: x
    if prec == "bf16":
        return lambda x: x.to(torch.bfloat16).to(torch.float64)
    raise ValueError(f"prec must be 'f64' or 'bf16', got {prec!r}")


def _lchoose(lf, n, k):
    nmax = lf.shape[0] - 1
    ok = (k >= 0) & (k <= n) & (n >= 0)
    kc, nc = k.clamp(0, nmax), n.clamp(0, nmax)
    val = lf[nc] - lf[kc] - lf[(nc - kc).clamp(0, nmax)]
    return torch.where(ok, val, float("-inf"))


def two_tailed(tables: torch.Tensor, m: int, tie_rtol: float) -> torch.Tensor:
    """Two-tailed p [...] float64 of integer tables [..., 4] (f0..f3 =
    A major, A minor, B major, B minor homozygotes): the first tail from
    the observed minimum cell down, the second from the other extreme
    inward while strictly less probable (``tie_rtol``), doubled where the
    margins are equal, snapped to 1 within ``tie_rtol``."""
    dev = tables.device
    maxs = m // 2 + 2
    lf = torch.lgamma(torch.arange(m + 3, dtype=torch.float64, device=dev) + 1.0)
    f = tables.to(torch.int64)
    equal_margins = ((f[..., 0] + f[..., 1]) == (f[..., 2] + f[..., 3])) | (
        (f[..., 0] + f[..., 2]) == (f[..., 1] + f[..., 3]))
    # rotate clockwise so that the minimum cell leads (first minimum)
    cw = torch.stack([f[..., 0], f[..., 1], f[..., 3], f[..., 2]], dim=-1)
    offs = (torch.argmin(cw, dim=-1)[..., None] + torch.arange(4, device=dev)) % 4
    rot = torch.gather(cw, -1, offs)
    s = torch.stack([rot[..., 0], rot[..., 1], rot[..., 3], rot[..., 2]], dim=-1)
    a0 = s[..., 0]
    r1, r2, c1 = s[..., 0] + s[..., 1], s[..., 2] + s[..., 3], s[..., 0] + s[..., 2]
    n = r1 + r2
    hi = torch.minimum(r1, c1)
    x = torch.arange(maxs, device=dev).reshape((1,) * a0.ndim + (maxs,))
    r1e, r2e, c1e, ne = (t[..., None] for t in (r1, r2, c1, n))
    logp = _lchoose(lf, r1e, x) + _lchoose(lf, r2e, c1e - x) - _lchoose(lf, ne, c1e)
    valid = x <= hi[..., None]
    p = torch.where(valid, torch.exp(logp), 0.0)
    a0e = a0[..., None]
    p0 = torch.gather(p, -1, a0e.clamp(max=maxs - 1))
    t1 = torch.where(x <= a0e, p, 0.0).sum(-1)
    bad = (p >= p0 * (1.0 - tie_rtol)) & valid
    blocked = bad.flip(-1).to(torch.int32).cumsum(-1).flip(-1)
    t2 = torch.where((blocked == 0) & valid & (x > a0e), p, 0.0).sum(-1)
    total = torch.where(equal_margins, 2.0 * t1, t1 + t2)
    return torch.where(total > 1.0 - tie_rtol, 1.0, total)


def snp_scores(avals: np.ndarray, bvals: np.ndarray, device, tie_rtol: float,
               prec: str = "f64") -> torch.Tensor:
    """-log10 p [N] float64 of every SNP, on ``device``."""
    rnd = rounder(prec)
    a = torch.as_tensor(avals, device=device)
    b = torch.as_tensor(bvals, device=device)
    m = a.shape[1] + b.shape[1]
    tables = torch.stack([(a == 3).sum(1), (a == -3).sum(1), (b == 3).sum(1),
                          (b == -3).sum(1)], dim=1)
    return rnd(-torch.log10(two_tailed(tables, m, tie_rtol)))


def window_scores(per_snp: torch.Tensor, plan: WindowPlan, perc: float, nsamples: int,
                  chrom_key: torch.Tensor, ids: np.ndarray, rank_dtype: torch.dtype,
                  prec: str = "f64") -> tuple[torch.Tensor, torch.Tensor]:
    """(score, stddev) float64 of windows ``ids`` of ``plan``: the
    interpolated ``perc`` percentile of the window's per-SNP scores and the
    population stddev of ``nsamples`` bootstrap percentiles.  Resample j's
    order statistics come from the Renyi recursion U_(n) = V^(1/n), U_(k) =
    U_(k+1) V^(1/k) on ``uniform(fold_in(fold_in(chrom_key, slot), step),
    (nsamples,))``, in ``rank_dtype`` as the configuration states."""
    rnd = rounder(prec)
    dev = per_snp.device
    scores, stddev = [], []
    for s in range(0, len(ids), WINDOW_BATCH):
        w = ids[s:s + WINDOW_BATCH]
        lo = torch.as_tensor(plan.lo[w], device=dev)
        npos = torch.as_tensor(plan.npos[w], device=dev)
        slot = torch.as_tensor(plan.slot[w], device=dev)
        P = max(int(npos.max()), 1)
        offs = torch.arange(P, device=dev)[None, :]
        inside = offs < npos[:, None]
        vals = torch.where(inside, per_snp[torch.where(inside, lo[:, None] + offs, 0)],
                           float("-inf"))
        srt = torch.sort(vals, dim=1).values          # the n values last

        def pick(rank):                              # ascending order statistic
            return torch.gather(srt, 1, (P - npos[:, None] + rank).clamp(0, P - 1))

        nf = npos.to(rank_dtype)
        xpos = (nf - 1.0) * torch.tensor(perc, dtype=rank_dtype)
        idx = torch.floor(xpos).to(torch.int64)
        delta = (xpos - idx.to(rank_dtype)).to(torch.float64)
        hi_idx = torch.minimum(idx + 1, (npos - 1).clamp(min=0))
        delta = rnd(delta)
        score = rnd((1.0 - delta) * pick(idx[:, None])[:, 0]
                    + rnd(delta * pick(hi_idx[:, None])[:, 0]))

        nfc = nf[:, None]
        t1 = torch.clamp(nfc - 1.0 - idx.to(rank_dtype)[:, None], min=0.0)
        t2 = nfc - 1.0 - hi_idx.to(rank_dtype)[:, None]
        wkeys = rng.fold_in(chrom_key.to(dev), slot)
        u = torch.ones((len(w), nsamples), dtype=rank_dtype, device=dev)
        u1 = u2 = u
        for j in range(int(t1.max()) + 1 if len(w) else 0):
            v = rng.uniform(rng.fold_in(wkeys, j), nsamples, rank_dtype)
            factor = v ** (torch.ones_like(nfc) / torch.clamp(nfc - float(j), min=1.0))
            u = torch.where(float(j) <= t1, u * factor, u)
            u2 = torch.where(float(j) == t2, u, u2)
            u1 = torch.where(float(j) == t1, u, u1)

        def rank_of(uu):
            r = torch.ceil(nfc * uu) - 1.0
            r = torch.minimum(torch.clamp(r, min=0.0), torch.clamp(nfc - 1.0, min=0.0))
            return r.to(torch.int64)

        x1 = pick(rank_of(u1))
        x2 = torch.where((hi_idx == idx)[:, None], x1, pick(rank_of(u2)))
        reps = rnd((1.0 - delta[:, None]) * x1 + rnd(delta[:, None] * x2))
        sd = rnd(torch.sqrt(((reps - reps.mean(1, keepdim=True)) ** 2).mean(1)))
        scores.append(score)
        stddev.append(sd)
    if not scores:
        z = torch.zeros(0, dtype=torch.float64, device=dev)
        return z, z
    return torch.cat(scores), torch.cat(stddev)


def chromosome_key(seed: int, seqid: str) -> torch.Tensor:
    """The stream of a chromosome's bootstrap: ``fold_in(PRNGKey(seed),
    chrom_hash(seqid))``."""
    return rng.fold_in(rng.prng_key(seed), rng.chrom_hash(seqid))


def tie_rtol(precision: str) -> float:
    """The near-tie and snap band a precision states (fast: 1e-5, exact:
    1e-12)."""
    return 1e-5 if precision == "fast" else 1e-12


def rank_dtype(precision: str) -> torch.dtype:
    return torch.float32 if precision == "fast" else torch.float64

