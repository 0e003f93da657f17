"""Batched Cluster Separation Score, phase 1: window dissimilarities
(K3/K4) and CMDS scoring (K5).

Port of ``divergence_tpu/kernels/css.py`` for the CMDS (``mds=0``)
stickleback path; every function keeps its JAX name and semantics:

* dissimilarity counting (reference statistics/css/css.c:277-327): the
  number of SNPs at which individuals i and j are opposite homozygotes;
* fill-averages + discard rule (css.c:337-366), quirks preserved: the
  average divides by all m^2 cells, the diagonal is filled too, and a
  window with more than m*m//2 near-zero cells is discarded;
* classical MDS (css.c:505-560): double centring, top-2 eigenpairs,
  X = Q sqrt(L) with the JAX package's dust clamp;
* the CSS score (css.c:608-647): between-group mean minus the weighted
  adjacent-chain terms.

Two wrappers launch hand-written CUDA kernels when their tensors lie on a
CUDA device, and run the plain torch version on the CPU:

* :func:`css_dissim` — ``csrc/css_dissim.cu``: every window's counts
  straight from the joint int16 codes (K3, and K4's gather form: the
  same integer counts);
* :func:`css_cmds`   — ``csrc/css_cmds.cu``: fill, centring, Jacobi
  eigensolver, embedding, distances and score per window (K5).

There is no fallback: on a CUDA tensor the kernel runs or the call
raises.  Each launch adds one to :data:`LAUNCHES`.  Not ported here: the
drosophila frequency metric (``dissimilarity_freq``, P8) and SMACOF (K6,
P7).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from divergence_tpu_torch import compute_dtype
from divergence_tpu_torch.kernels._cuda import dtype_suffix, is_cpu, launch, ptr
from divergence_tpu_torch.kernels.fet import _window_pad
from divergence_tpu_torch.kernels.linalg import top2_eig

# the JAX engine's memory guardrail for the prefix form
# (divergence_tpu/engine/css_engine.py:31): above it the plain version
# counts per window batch
PREFIX_MAX_ELEMS = 1 << 28
_COUNT_BATCH_ELEMS = 1 << 24   # [b, P, m] elements per step of the counts form
# windows per step of the plain CMDS: cuSOLVER's batched eigh refuses
# batches of 65 536 21x21 matrices on the card (CUSOLVER_STATUS_INVALID_VALUE)
_CMDS_BATCH = 16_384
CMDS_MAX_M = 64                # css_cmds keeps a window's Jacobi in shared memory
_SMEM_LIMIT = 232_448          # bytes of shared memory a Hopper block may use
_DISSIM_WORDS = 8              # css_dissim packs 8 x 32 SNPs per pass

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES = {"css_dissim": 0, "css_cmds": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --------------------------------------------------------------------------
# K3 / K4: window dissimilarity counts
# --------------------------------------------------------------------------

def dissimilarity_counts(vals: torch.Tensor, snp_mask: torch.Tensor) -> torch.Tensor:
    """Pairwise genotype-mismatch counts.

    ``vals``: [B, P, m] genotype codes of all m individuals (groups
    concatenated), ``snp_mask``: [B, P] validity.  Returns [B, m, m]
    float64 counts with zero diagonal.  The 0/1 products accumulate in
    float32, exact below 2**24."""
    mask = snp_mask[..., None]
    maj = ((vals == 3) & mask).to(torch.float32)
    mnr = ((vals == -3) & mask).to(torch.float32)
    d = torch.einsum("bpi,bpj->bij", maj, mnr)
    return (d + d.transpose(-1, -2)).to(torch.float64)


def dissimilarity_prefix(vals: torch.Tensor) -> torch.Tensor:
    """Chromosome-wide prefix sums of the per-SNP mismatch indicators:
    [N+1, m, m], ``prefix[n] = sum_{k<n} M_k`` (float32 below 2**24 SNPs,
    float64 above, so window differences are exact counts)."""
    N, m = vals.shape
    maj = vals == 3
    mnr = vals == -3
    mk = (maj[:, :, None] & mnr[:, None, :]) | (mnr[:, :, None] & maj[:, None, :])
    acc = torch.float32 if N < (1 << 24) else torch.float64
    pref = torch.cumsum(mk.to(acc), dim=0)
    return torch.cat([torch.zeros((1, m, m), dtype=acc, device=vals.device), pref])


def dissimilarity_from_prefix(
    prefix: torch.Tensor, lo: torch.Tensor, npos: torch.Tensor
) -> torch.Tensor:
    """Per-window dissimilarity counts from the chromosome prefix."""
    return (prefix[lo + npos] - prefix[lo]).to(torch.float64)


def dissimilarity_plain(
    vals: torch.Tensor, lo: torch.Tensor, npos: torch.Tensor
) -> torch.Tensor:
    """Plain torch version of :func:`css_dissim`, float64 counts.

    Within the JAX engine's element budget it takes the prefix form, above
    it the counts form over window batches (``css_engine.py:93-96``), so
    memory stays bounded at any chromosome length.  Both give the same
    integer counts."""
    dev = vals.device
    lo, npos = lo.to(dev, torch.int64), npos.to(dev, torch.int64)
    N, m = vals.shape
    B = lo.shape[0]
    if B == 0:
        return torch.zeros((0, m, m), dtype=torch.float64, device=dev)
    if (N + 1) * m * m <= PREFIX_MAX_ELEMS:
        return dissimilarity_from_prefix(dissimilarity_prefix(vals), lo, npos)
    P = _window_pad(int(npos.max()))
    step = max(1, _COUNT_BATCH_ELEMS // (P * m))
    offs = torch.arange(P, device=dev)[None, :]
    out = torch.empty((B, m, m), dtype=torch.float64, device=dev)
    for s in range(0, B, step):
        sl = slice(s, min(s + step, B))
        mask = offs < npos[sl, None]
        idx = torch.where(mask, lo[sl, None] + offs, 0)
        out[sl] = dissimilarity_counts(vals[idx], mask)
    return out


def css_dissim(
    vals: torch.Tensor,   # [N, m] joint genotype codes (SnpPair.to_device)
    lo: torch.Tensor,     # [B] first SNP of each window
    npos: torch.Tensor,   # [B] SNPs per window
    dtype: torch.dtype,
) -> torch.Tensor:
    """Opposite-homozygote pair counts of every window, [B, m, m] in
    ``dtype`` (``divergence_tpu/kernels/css.py:dissimilarity_prefix`` +
    ``dissimilarity_from_prefix``, and ``dissimilarity_counts``).  On a
    CUDA ``vals`` the descriptors may lie on the host or the card."""
    if is_cpu(vals):
        return dissimilarity_plain(vals, lo, npos).to(dtype)
    if vals.dtype != torch.int16:
        raise TypeError(f"css_dissim kernel takes int16 genotype codes, got {vals.dtype}")
    if vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError("css_dissim kernel takes a contiguous [N, m] tensor")
    dev = vals.device
    m = vals.shape[1]
    B = lo.shape[0]
    out = torch.empty((B, m, m), dtype=dtype, device=dev)
    if B == 0:
        return out
    smem = 4 * m * m + 2 * 4 * m * _DISSIM_WORDS
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"css_dissim needs {smem} B of shared memory at m={m}; a block "
            f"has {_SMEM_LIMIT}"
        )
    lo_d, npos_d = (t.to(dev, torch.int64).contiguous() for t in (lo, npos))
    launch(
        LAUNCHES, "css_dissim", f"css_dissim_{dtype_suffix(dtype)}", dev,
        ptr(vals), ptr(lo_d), ptr(npos_d), B, m, ptr(out),
    )
    return out


# --------------------------------------------------------------------------
# K5: fill-averages, CMDS, distances, score
# --------------------------------------------------------------------------

def fill_averages(dis: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Average-fill + discard rule (reference statistics/css/css.c:337-366).
    Returns (filled [B, m, m], keep [B] bool)."""
    m = dis.shape[-1]
    unval = dis < 0.00001
    total = m * m
    avg = torch.where(unval, 0.0, dis).sum(dim=(-1, -2)) / total
    n_unval = unval.sum(dim=(-1, -2))
    keep = n_unval <= total // 2
    filled = torch.where(unval, avg[..., None, None], dis)
    return filled, keep


def double_centre(dis: torch.Tensor) -> torch.Tensor:
    """B = -1/2 J D^2 J as row / column / grand mean subtraction."""
    d2 = dis * dis
    row = d2.mean(dim=-1, keepdim=True)
    col = d2.mean(dim=-2, keepdim=True)
    grand = d2.mean(dim=(-1, -2), keepdim=True)
    return -0.5 * (d2 - row - col + grand)


def cmds(dis: torch.Tensor) -> torch.Tensor:
    """Classical MDS to 2 dimensions (reference statistics/css/css.c:505-560):
    [B, m, m] -> [B, m, 2].  Negative eigenvalues within the dtype's
    dust bound are zeroed; a truly negative retained eigenvalue gives NaN
    coordinates, like the reference's sqrt."""
    vals, vecs = top2_eig(double_centre(dis))
    dust = 1e-5 if vals.dtype == torch.float32 else 1e-9
    scale = torch.clamp(vals[..., :1].abs(), min=1.0)
    vals = torch.where((vals < 0) & (vals > -dust * scale), 0.0, vals)
    return vecs * torch.sqrt(vals)[..., None, :]


def calc_dist(x: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distances of the embedding
    (reference statistics/css/css.c:573-587): [B, m, 2] -> [B, m, m]."""
    diff = x[..., :, None, :] - x[..., None, :, :]
    return torch.sqrt((diff * diff).sum(dim=-1))


def chain_weights_host(asize: int, bsize: int) -> np.ndarray:
    """Static [m-1] weights of the within-group adjacent-chain terms in
    track order (reference statistics/css/css.c:627-642): 1/(a^2(a-1))
    for the a-chain, 1/(b^2(b-1)) for the b-chain, 0 at the group
    boundary and for singleton groups."""
    m = asize + bsize
    w = np.zeros(m - 1)
    if asize > 1:
        w[: asize - 1] = 1.0 / (asize * asize * (asize - 1))
    if bsize > 1:
        w[asize:] = 1.0 / (bsize * bsize * (bsize - 1))
    return w


def css_from_dist(dist: torch.Tensor, asize: int, bsize: int) -> torch.Tensor:
    """CSS with identity track order (reference statistics/css/css.c:608-647):
    mean(between-block) - (a+b) * (a-chain + b-chain).  The weights are
    float64, as in the JAX package, so a float32 ``dist`` scores in
    float64."""
    m = asize + bsize
    bet = dist[..., :asize, asize:].mean(dim=(-1, -2))
    diag1 = torch.diagonal(dist, offset=1, dim1=-2, dim2=-1)
    w = torch.as_tensor(chain_weights_host(asize, bsize), device=dist.device)
    return bet - m * (diag1 * w).sum(dim=-1)


def css_cmds_plain(
    dis: torch.Tensor, npos: torch.Tensor, asize: int, bsize: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`css_cmds`
    (``divergence_tpu/kernels/css.py:_score_pipeline`` with ``mds=0``),
    over window batches of ``_CMDS_BATCH``."""
    B = dis.shape[0]
    npos = npos.to(dis.device)
    scores, dists, valids = [], [], []
    for s in range(0, B, _CMDS_BATCH):
        sl = slice(s, min(s + _CMDS_BATCH, B))
        filled, keep = fill_averages(dis[sl])
        dist = calc_dist(cmds(filled))
        sc = css_from_dist(dist, asize, bsize)
        valid = keep & (npos[sl] > 0)
        scores.append(torch.where(valid, sc, 0.0))
        dists.append(dist)
        valids.append(valid)
    if B == 0:
        m = dis.shape[-1]
        return (torch.zeros(0, dtype=torch.float64, device=dis.device),
                torch.zeros((0, m, m), dtype=dis.dtype, device=dis.device),
                torch.zeros(0, dtype=torch.bool, device=dis.device))
    return torch.cat(scores), torch.cat(dists), torch.cat(valids)


def _round_robin_pairs(n: int) -> np.ndarray:
    """[n-1, n/2, 2] int32: the disjoint pairs (p < q) of each round of the
    all-pairs round-robin (the circle method of
    ``divergence_tpu/kernels/linalg.py:_round_robin_schedule``)."""
    players = list(range(n))
    out = np.empty((n - 1, n // 2, 2), dtype=np.int32)
    for r in range(n - 1):
        for i in range(n // 2):
            p, q = players[i], players[n - 1 - i]
            out[r, i] = (min(p, q), max(p, q))
        players = [players[0]] + [players[-1]] + players[1:-1]
    return out


@functools.lru_cache(maxsize=16)
def _pairs(n: int, device: torch.device) -> torch.Tensor:
    """:func:`_round_robin_pairs` on ``device``, uploaded once."""
    return torch.from_numpy(_round_robin_pairs(n)).to(device)


def css_cmds(
    dis: torch.Tensor,    # [B, m, m] window dissimilarities (compute dtype)
    npos: torch.Tensor,   # [B] SNPs per window (a window with none is invalid)
    asize: int,
    bsize: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CMDS scores of every window: (scores [B], dist [B, m, m], valid
    [B]), ``valid`` False for empty and discarded windows, whose score is
    0 (``divergence_tpu/kernels/css.py:_score_pipeline``, ``mds=0``)."""
    if is_cpu(dis):
        return css_cmds_plain(dis, npos, asize, bsize)
    dev = dis.device
    B, m = dis.shape[0], dis.shape[-1]
    if m != asize + bsize or dis.shape != (B, m, m) or not dis.is_contiguous():
        raise ValueError("css_cmds kernel takes a contiguous [B, m, m] tensor, m = a + b")
    if m > CMDS_MAX_M:
        raise NotImplementedError(
            f"css_cmds runs panels of at most {CMDS_MAX_M} individuals on "
            f"CUDA (m={m}); larger panels are ROADMAP item P12"
        )
    scores = torch.empty(B, dtype=dis.dtype, device=dev)
    dist = torch.empty_like(dis)
    valid = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return scores, dist, valid
    mp = m + (m % 2)
    w = chain_weights_host(asize, bsize)
    wa = float(w[0]) if asize > 1 else 0.0
    wb = float(w[-1]) if bsize > 1 else 0.0
    npos_d = npos.to(dev, torch.int64).contiguous()
    launch(
        LAUNCHES, "css_cmds", f"css_cmds_{dtype_suffix(dis.dtype)}", dev,
        ptr(dis), ptr(npos_d), B, asize, bsize, ptr(_pairs(mp, dev)),
        wa, wb, ptr(scores), ptr(dist), ptr(valid),
    )
    return scores, dist, valid


# --------------------------------------------------------------------------
# phase 1 of a chromosome
# --------------------------------------------------------------------------

def css_phase1(
    vals: torch.Tensor,   # [N, m] joint genotype codes (SnpPair.to_device)
    lo: np.ndarray | torch.Tensor,     # [B] first SNP of each window
    npos: np.ndarray | torch.Tensor,   # [B] SNPs per window
    asize: int,
    bsize: int,
    fast: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every window of a chromosome in one call: dissimilarities, then
    CMDS scoring (``divergence_tpu/kernels/css.py:css_prefix_all`` with
    ``mds=0``).  Returns (scores [B], dist [B, m, m], valid [B]) on
    ``vals.device``, in the compute dtype of ``fast``."""
    dtype = compute_dtype("fast" if fast else "exact")
    lo = torch.as_tensor(lo, dtype=torch.int64)
    npos = torch.as_tensor(npos, dtype=torch.int64)
    if lo.numel() and (int(lo.min()) < 0 or int((lo + npos).max()) > vals.shape[0]):
        raise ValueError("window descriptors reach outside the SNP matrix")
    if not is_cpu(vals) and lo.device.type == "cpu":
        # one pinned upload serves both kernels
        rows = torch.stack([lo, npos]).pin_memory().to(vals.device, non_blocking=True)
        lo, npos = rows[0], rows[1]
    dis = css_dissim(vals, lo, npos, dtype)
    return css_cmds(dis, npos, asize, bsize)
