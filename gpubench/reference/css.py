"""Plain reference of CSS phase 1: each window's dissimilarities (the
number of SNPs at which two individuals are opposite homozygotes,
``statistics/css/css.c:277-327``), the fill-averages and discard rule
(``css.c:337-366``), classical MDS to two dimensions (``css.c:505-560``),
the embedding's distances and the Cluster Separation Score (``css.c:608-647``),
after ``divergence_tpu_torch/kernels/css.py`` (``fill_averages``,
``double_centre``, ``cmds``, ``calc_dist``, ``css_from_dist``), in float64
with ``torch.linalg.eigh``.  ``prec="bf16"`` is the control: the same steps
with every value rounded to bfloat16 where it is made (the eigen step in
float32 on the rounded matrix).
"""

from __future__ import annotations

import numpy as np
import torch

BATCH = 4_096


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def dissimilarity(codes: torch.Tensor, lo: torch.Tensor, npos: torch.Tensor) -> torch.Tensor:
    """[b, m, m] float64 counts of windows (lo, npos) of the joint codes
    [N, m]."""
    P = max(int(npos.max()), 1)
    offs = torch.arange(P, device=codes.device)[None, :]
    inside = offs < npos[:, None]
    v = codes[torch.where(inside, lo[:, None] + offs, 0)]          # [b, P, m]
    maj = ((v == 3) & inside[..., None]).to(torch.float64)
    mnr = ((v == -3) & inside[..., None]).to(torch.float64)
    d = torch.einsum("bpi,bpj->bij", maj, mnr)
    return d + d.transpose(1, 2)


def kept(codes: torch.Tensor, lo: np.ndarray, npos: np.ndarray, m: int) -> np.ndarray:
    """The discard rule of every window (lo, npos): False where more than
    half the m x m cells are under 1e-5."""
    dev = codes.device
    out = [(dissimilarity(codes, torch.as_tensor(lo[s:s + BATCH], device=dev),
                          torch.as_tensor(npos[s:s + BATCH], device=dev)) < 0.00001
            ).sum(dim=(-1, -2)) <= m * m // 2 for s in range(0, len(lo), BATCH)]
    return torch.cat(out).cpu().numpy() if out else np.zeros(0, dtype=bool)


def score_windows(dis: torch.Tensor, asize: int, bsize: int, prec: str = "f64"):
    """(score [b], dist [b, m, m], keep [b], gap [b]) of the windows'
    dissimilarities: ``keep`` False where more than half the cells are
    under 1e-5 (discarded); ``gap`` = (lambda2 - lambda3) / |lambda1| of
    the centred matrix, the conditioning of the 2-D embedding."""
    m = asize + bsize
    rnd = _bf if prec == "bf16" else (lambda x: x)
    work = torch.float32 if prec == "bf16" else torch.float64
    dis = rnd(dis.to(work))
    unval = dis < 0.00001
    total = m * m
    avg = torch.where(unval, 0.0, dis).sum(dim=(-1, -2)) / total
    keep = unval.sum(dim=(-1, -2)) <= total // 2
    filled = rnd(torch.where(unval, avg[:, None, None], dis))
    d2 = filled * filled
    B = rnd(-0.5 * (d2 - d2.mean(-1, keepdim=True) - d2.mean(-2, keepdim=True)
                    + d2.mean(dim=(-1, -2), keepdim=True)))
    lam, vec = torch.linalg.eigh(B)                   # ascending
    lam = rnd(lam.flip(-1))
    vec = rnd(vec.flip(-1))
    top = lam[:, :2]
    # the dust clamp of the configured float32 precision (kernels/css.py:cmds)
    scale = torch.clamp(top[:, :1].abs(), min=1.0)
    top = torch.where((top < 0) & (top > -1e-5 * scale), 0.0, top)
    x = rnd(vec[:, :, :2] * torch.sqrt(top)[:, None, :])
    diff = x[:, :, None, :] - x[:, None, :, :]
    dist = rnd(torch.sqrt((diff * diff).sum(-1)))
    w = np.zeros(m - 1)
    if asize > 1:
        w[: asize - 1] = 1.0 / (asize * asize * (asize - 1))
    if bsize > 1:
        w[asize:] = 1.0 / (bsize * bsize * (bsize - 1))
    w = torch.as_tensor(w, dtype=work, device=dis.device)
    bet = dist[:, :asize, asize:].mean(dim=(-1, -2))
    chain = (torch.diagonal(dist, offset=1, dim1=-2, dim2=-1) * w).sum(-1)
    score = rnd(bet - m * chain)
    gap = (lam[:, 1] - lam[:, 2]) / torch.clamp(lam[:, 0].abs(), min=1e-300)
    return (score.to(torch.float64), dist.to(torch.float64), keep,
            gap.to(torch.float64))


def phase1(codes: torch.Tensor, lo: np.ndarray, npos: np.ndarray, asize: int, bsize: int,
           prec: str = "f64"):
    """:func:`score_windows` of the windows (lo, npos) over the joint codes
    [N, m] on their device, in batches: (score, dist, keep, gap)."""
    dev = codes.device
    parts = []
    for s in range(0, len(lo), BATCH):
        lo_b = torch.as_tensor(lo[s:s + BATCH], device=dev)
        np_b = torch.as_tensor(npos[s:s + BATCH], device=dev)
        parts.append(score_windows(dissimilarity(codes, lo_b, np_b), asize, bsize, prec))
    return tuple(torch.cat(c) for c in zip(*parts))
