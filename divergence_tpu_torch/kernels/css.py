"""Batched Cluster Separation Score, phase 1: window dissimilarities
(K3/K4, and the drosophila frequency metric), CMDS scoring (K5) and
SMACOF scoring (K6).

Port of ``divergence_tpu/kernels/css.py``; every function keeps its JAX
name and semantics:

* dissimilarity counting (reference statistics/css/css.c:277-327): the
  number of SNPs at which individuals i and j are opposite homozygotes;
* the drosophila metric (css.c:245-264): two pseudo-individuals whose
  dissimilarity is the mean absolute frequency difference;
* fill-averages + discard rule (css.c:337-366), quirks preserved: the
  average divides by all m^2 cells, the diagonal is filled too, and a
  window with more than m*m//2 near-zero cells is discarded;
* classical MDS (css.c:505-560): double centring, top-2 eigenpairs,
  X = Q sqrt(L) with the JAX package's dust clamp;
* SMACOF (css.c:852-938): Guttman transforms until the stress improves by
  at most epsilon, from ``n_init`` slot-keyed uniform restarts (mds=1) or
  from the CMDS embedding (mds=2);
* the CSS score (css.c:608-647): between-group mean minus the weighted
  adjacent-chain terms.

Four wrappers launch hand-written CUDA kernels when their tensors lie on
a CUDA device, and run the plain torch version on the CPU:

* :func:`css_dissim` — ``csrc/css_dissim.cu``: every window's counts
  from the chromosome's hom-major / hom-minor bit planes, packed once a
  call (K3); :func:`css_dissim_gathered`, its second kernel, counts
  pre-gathered windows from their separate a and b codes (K4's gather
  form: the same integer counts).  :func:`pack_bitplanes_plain`,
  :func:`dissimilarity_bitplanes_plain` and
  :func:`gathered_bitplanes_plain` mirror their words for tests;
* :func:`css_cmds`   — ``csrc/css_cmds.cu``: fill, centring, the top-2
  eigenpairs (tridiagonal reduction, bisection, inverse iteration; one
  warp per window), embedding, distances and score per window (K5);
* :func:`css_smacof` — ``csrc/css_smacof.cu``: fill, the restarts'
  SMACOF loops (one warp a restart, one pass over the pairs a transform),
  the best restart, distances and score per window (K6);
  :func:`smacof_pairs` mirrors its order of operations for tests.

Each has a second kernel for large panels, which its wrapper launches
where the first one's per-window shared memory does not fit a block, as
the kernel library's own form queries reckon it from the kernels' slab
layouts and the device's shared memory (:func:`dissim_form`,
:func:`gathered_form`, :func:`cmds_form`, :func:`smacof_form`):
``css_dissim_tiles`` counts a window by 32 x 32
tiles of its pair matrix, ``css_cmds_block`` runs a window on a block of
256 or 512 threads and ``css_smacof_block`` a window's restarts on a
block of 256 (``css_block.cuh``), with their slabs in device memory
where even one block's shared memory is too small.  So every panel size
runs on the card.

There is no fallback: on a CUDA tensor the kernel runs or the call
raises.  Each launch adds one to :data:`LAUNCHES`.  The drosophila metric
(:func:`dissimilarity_freq_windows`) is plain torch on every device.
:func:`css_window_batch`, the sharded step's form on pre-gathered windows,
runs :func:`css_phase1` and needs no kernel of its own.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from divergence_tpu_torch import compute_dtype, rng
from divergence_tpu_torch.kernels._cuda import dtype_suffix, is_cpu, launch, ptr, query_form
from divergence_tpu_torch.kernels.fet import _lane_sum, _window_pad, codes_int16
from divergence_tpu_torch.kernels.linalg import top2_eig

# the JAX engine's memory guardrail for the prefix form
# (divergence_tpu/engine/css_engine.py:31): above it the plain version
# counts per window batch
PREFIX_MAX_ELEMS = 1 << 28
_COUNT_BATCH_ELEMS = 1 << 24   # [b, P, m] elements per step of the counts form
# windows per step of the plain CMDS / SMACOF: cuSOLVER's batched eigh
# refuses batches of 65 536 21x21 matrices on the card
# (CUSOLVER_STATUS_INVALID_VALUE); and at most _PLAIN_BATCH_ELEMS matrix
# elements a step (SMACOF: over its restarts), so large panels stay
# within the card's memory (m = 200: 6,710 windows, 2.1 GB a float64 copy)
_CMDS_BATCH = 16_384
_PLAIN_BATCH_ELEMS = 1 << 28
_GATHER_PLANE_BYTES = 256 << 20   # the gathered tile form packs this much at once

# kernel launches since the last reset_launches(), by kernel name; the
# *_tiles / *_block kernels are the large-panel forms (css_dissim_tiles
# counts the tile launches of both css_dissim and css_dissim_gathered)
LAUNCHES = {"css_dissim": 0, "css_dissim_gathered": 0, "css_dissim_tiles": 0,
            "css_cmds": 0, "css_cmds_block": 0, "css_smacof": 0, "css_smacof_block": 0}


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


def dissimilarity_gathered_plain(
    avals: torch.Tensor, bvals: torch.Tensor, npos: torch.Tensor
) -> torch.Tensor:
    """Plain torch version of :func:`css_dissim_gathered`, float64 counts:
    :func:`dissimilarity_counts` over window batches of the joint codes."""
    B, P = avals.shape[:2]
    m = avals.shape[2] + bvals.shape[2]
    dev = avals.device
    npos = torch.as_tensor(npos).to(dev, torch.int64)
    out = torch.empty((B, m, m), dtype=torch.float64, device=dev)
    offs = torch.arange(P, device=dev)[None, :]
    step = max(1, _COUNT_BATCH_ELEMS // max(P * m, 1))
    for s in range(0, B, step):
        sl = slice(s, min(s + step, B))
        joint = torch.cat([avals[sl], bvals[sl]], dim=-1)
        out[sl] = dissimilarity_counts(joint, offs < npos[sl, None])
    return out


def dissim_form(m: int, device: torch.device | None = None) -> str:
    """The kernel :func:`css_dissim` launches at panel size m on
    ``device``, by the kernel library's own reckoning
    (``csrc/css_dissim.cu:css_dissim_form``): ``"warp"`` (a warp per
    window) where a block holds all four warps' slabs (m <= 112 on an
    H100), else ``"tiles"`` (32 x 32 tiles a block).  The warp form runs
    while one warp's slab fits (m <= 233), but with fewer warps a block it
    is the slower: 3 warps at m = 128, 3.8 ms against the tiles' 1.1 on
    19,997 windows, one at m = 200, 24.4 ms against 2.9
    (tests/measure_large_panels.py, H100 80GB HBM3, 700 W)."""
    return query_form(("warp", "tiles"), "css_dissim_form", device, m)[0]


def gathered_form(asize: int, bsize: int, device: torch.device | None = None) -> str:
    """The kernel :func:`css_dissim_gathered` launches
    (``css_dissim_gathered_form``): ``"warp"`` where one window's staged
    codes, words and counts fit a block (m <= 207 at an even a + b split
    on an H100), else ``"tiles"``.  (Only the sharded step calls it; the
    two forms are not timed against each other above m = 64.)"""
    return query_form(("warp", "tiles"), "css_dissim_gathered_form", device, asize, bsize)[0]


def css_dissim(
    vals: torch.Tensor,   # [N, m] joint genotype codes (SnpPair.to_device)
    lo: torch.Tensor,     # [B] first SNP of each window
    npos: torch.Tensor,   # [B] SNPs per window
    dtype: torch.dtype,
) -> torch.Tensor:
    """Opposite-homozygote pair counts of every window, [B, m, m] in
    ``dtype`` (``divergence_tpu/kernels/css.py:dissimilarity_prefix`` +
    ``dissimilarity_from_prefix``, and ``dissimilarity_counts``).  On a
    CUDA ``vals`` the descriptors may lie on the host or the card; the
    kernel packs the chromosome's bit planes into a scratch of
    2 (ceil(N/32) + 1) m words, then counts every window from them."""
    if is_cpu(vals):
        return dissimilarity_plain(vals, lo, npos).to(dtype)
    if vals.dtype != torch.int16:
        raise TypeError(f"css_dissim kernel takes int16 genotype codes, got {vals.dtype}")
    if vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError("css_dissim kernel takes a contiguous [N, m] tensor")
    dev = vals.device
    N, m = vals.shape
    B = lo.shape[0]
    out = torch.empty((B, m, m), dtype=dtype, device=dev)
    if B == 0:
        return out
    planes = torch.empty((2, (N + 31) // 32 + 1, m), dtype=torch.int32, device=dev)
    lo_d, npos_d = (t.to(dev, torch.int64).contiguous() for t in (lo, npos))
    name = "css_dissim" if dissim_form(m, dev) == "warp" else "css_dissim_tiles"
    launch(
        LAUNCHES, name, f"{name}_{dtype_suffix(dtype)}", dev,
        ptr(vals), N, ptr(lo_d), ptr(npos_d), B, m, ptr(planes), ptr(out),
    )
    return out


def css_dissim_gathered(
    avals: torch.Tensor,   # [B, P, asize] int16 codes
    bvals: torch.Tensor,   # [B, P, bsize]
    npos: torch.Tensor,    # [B] SNPs per window (rows 0 .. npos[b])
    dtype: torch.dtype,
) -> torch.Tensor:
    """:func:`css_dissim` on pre-gathered windows
    (``divergence_tpu/kernels/css.py:dissimilarity_counts``), [B, m, m] in
    ``dtype`` with the a individuals first: the kernel reads the a and b
    codes where they lie, with no joint copy.  ``npos`` may lie on the
    host or the card."""
    if is_cpu(avals):
        return dissimilarity_gathered_plain(avals, bvals, npos).to(dtype)
    if avals.dtype != torch.int16 or bvals.dtype != torch.int16:
        raise TypeError("css_dissim_gathered kernel takes int16 genotype codes")
    if (avals.dim() != 3 or bvals.dim() != 3 or avals.shape[:2] != bvals.shape[:2]
            or not avals.is_contiguous() or not bvals.is_contiguous()):
        raise ValueError(
            "css_dissim_gathered kernel takes contiguous [B, P, a] and [B, P, b] codes"
        )
    dev = avals.device
    B, P, asize = avals.shape
    bsize = bvals.shape[2]
    m = asize + bsize
    out = torch.empty((B, m, m), dtype=dtype, device=dev)
    if B == 0:
        return out
    npos = torch.as_tensor(npos)
    if int(npos.max()) > P:
        raise ValueError(f"a window claims {int(npos.max())} SNPs; the batch holds {P} rows")
    npos_d = npos.to(dev, torch.int64).contiguous()
    sfx = dtype_suffix(dtype)
    if gathered_form(asize, bsize, dev) == "warp":
        launch(
            LAUNCHES, "css_dissim_gathered", f"css_dissim_gathered_{sfx}", dev,
            ptr(avals), ptr(bvals), ptr(npos_d), B, P, asize, bsize, ptr(out),
        )
        return out
    # the tile form: each batch's words packed into per-window planes of
    # wpw words, window w's first bit at 32 wpw w
    wpw = (P + 31) // 32 + 1
    step = max(1, _GATHER_PLANE_BYTES // (2 * wpw * m * 4))
    for s in range(0, B, step):
        e = min(s + step, B)
        planes = torch.empty((2, e - s, wpw, m), dtype=torch.int32, device=dev)
        lo_d = torch.arange(e - s, dtype=torch.int64, device=dev) * (32 * wpw)
        launch(
            LAUNCHES, "css_dissim_tiles", f"css_dissim_gathered_tiles_{sfx}", dev,
            ptr(avals[s:e]), ptr(bvals[s:e]), ptr(npos_d[s:e]), ptr(lo_d), e - s, P, asize,
            bsize, ptr(planes), ptr(out[s:e]),
        )
    return out


# the kernels' bit planes, mirrored in torch: words hold 32 SNPs each as
# int64 values in [0, 2^32), bit b of word k the SNP 32 k + b

def _words(bits: torch.Tensor, nwords: int) -> torch.Tensor:
    """[..., S, c] bools -> [..., nwords, c] words of 32 rows (rows past S
    are 0): the kernels' ballots."""
    S = bits.shape[-2]
    pad = 32 * nwords - S
    b = torch.nn.functional.pad(bits.to(torch.int64), (0, 0, 0, pad))
    b = b.reshape(*bits.shape[:-2], nwords, 32, bits.shape[-1])
    weight = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device)
    return (b * weight[:, None]).sum(-2)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _pair_counts(maj: torch.Tensor, mnr: torch.Tensor) -> torch.Tensor:
    """[B, K, m] words -> [B, m, m] float64 counts: the sum over words of
    popc(maj_i & mnr_j) + popc(mnr_i & maj_j)."""
    d = (_popcount32(maj[:, :, :, None] & mnr[:, :, None, :])
         + _popcount32(mnr[:, :, :, None] & maj[:, :, None, :]))
    return d.sum(1).to(torch.float64)


def pack_bitplanes_plain(vals: torch.Tensor) -> torch.Tensor:
    """``css_pack``'s planes of the codes [N, m]: [2, ceil(N/32) + 1, m]
    (hom-major, hom-minor), word-major, the last word 0."""
    W = (vals.shape[0] + 31) // 32 + 1
    return torch.stack([_words(vals == 3, W), _words(vals == -3, W)])


def dissimilarity_bitplanes_plain(
    planes: torch.Tensor, lo: torch.Tensor, npos: torch.Tensor
) -> torch.Tensor:
    """``css_dissim``'s counts from :func:`pack_bitplanes_plain` planes,
    float64 [B, m, m]: word k of a window is the funnel shift of plane
    words lo // 32 + k and + 1 right by lo % 32, its bits past npos
    cleared."""
    W = planes.shape[1]
    m = planes.shape[2]
    lo = torch.as_tensor(lo).to(planes.device, torch.int64)
    npos = torch.as_tensor(npos).to(planes.device, torch.int64)
    B = lo.shape[0]
    if B == 0:
        return torch.zeros((0, m, m), dtype=torch.float64, device=planes.device)
    K = max(1, (int(npos.max()) + 31) // 32)
    k = torch.arange(K, device=planes.device)
    at = (lo // 32)[:, None] + k[None, :]                        # [B, K]
    sh = (lo % 32)[:, None, None]
    rem = (npos[:, None] - 32 * k[None, :]).clamp(0, 32)[..., None]
    keep = (torch.ones_like(rem) << rem) - 1

    def window_words(plane):
        first = plane[at.clamp(max=W - 1)]                       # [B, K, m]
        second = plane[(at + 1).clamp(max=W - 1)]
        return (((second << 32) | first) >> sh) & 0xFFFFFFFF & keep

    return _pair_counts(window_words(planes[0]), window_words(planes[1]))


def gathered_bitplanes_plain(
    avals: torch.Tensor, bvals: torch.Tensor, npos: torch.Tensor
) -> torch.Tensor:
    """``css_dissim_gathered``'s counts, float64 [B, m, m]: each window's
    words packed from its a codes, then its b codes, rows past npos 0."""
    B, P = avals.shape[:2]
    npos = torch.as_tensor(npos).to(avals.device, torch.int64)
    K = max(1, (P + 31) // 32)
    row_in = (torch.arange(P, device=avals.device)[None, :] < npos[:, None])[..., None]
    planes = [
        torch.cat([_words((avals == c) & row_in, K), _words((bvals == c) & row_in, K)],
                  dim=-1)
        for c in (3, -3)
    ]
    return _pair_counts(*planes)


def dissimilarity_freq(
    avals: torch.Tensor, bvals: torch.Tensor, npos: torch.Tensor,
    snp_mask: torch.Tensor,
) -> torch.Tensor:
    """Drosophila frequency metric (reference statistics/css/css.c:245-264):
    a 2x2 matrix with the mean absolute frequency difference off the
    diagonal, summed in float64.  ``avals``/``bvals``: [B, P, 1] gathered
    frequencies, ``snp_mask`` [B, P] -> [B, 2, 2] float64."""
    diff = (avals[..., 0].to(torch.float64) - bvals[..., 0].to(torch.float64)).abs()
    avg = torch.where(snp_mask, diff, 0.0).sum(dim=-1) / torch.clamp(
        npos.to(torch.float64), min=1.0
    )
    zero = torch.zeros_like(avg)
    return torch.stack(
        [torch.stack([zero, avg], dim=-1), torch.stack([avg, zero], dim=-1)], dim=-2
    )


def dissimilarity_freq_windows(
    fa: torch.Tensor, fb: torch.Tensor, lo: torch.Tensor, npos: torch.Tensor
) -> torch.Tensor:
    """Every window's drosophila matrix [B, 2, 2] float64 from the
    chromosome's frequency columns ``fa``/``fb`` [N] (the JAX engine's
    gather path, ``css_gather_all``): windows gathered at a padded width
    in batches of ``_COUNT_BATCH_ELEMS`` values, so memory stays bounded.
    Plain torch on every device (ROADMAP queue 2: no hand kernel)."""
    dev = fa.device
    lo, npos = lo.to(dev, torch.int64), npos.to(dev, torch.int64)
    B = lo.shape[0]
    out = torch.empty((B, 2, 2), dtype=torch.float64, device=dev)
    if B == 0:
        return out
    P = _window_pad(int(npos.max()))
    step = max(1, _COUNT_BATCH_ELEMS // P)
    offs = torch.arange(P, device=dev)[None, :]
    for s in range(0, B, step):
        sl = slice(s, min(s + step, B))
        mask = offs < npos[sl, None]
        idx = torch.where(mask, lo[sl, None] + offs, 0)
        out[sl] = dissimilarity_freq(fa[idx][..., None], fb[idx][..., None], npos[sl], mask)
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
    # divided by a tensor: torch on CUDA multiplies by the reciprocal of a
    # Python-number divisor, the kernels (and the CPU) divide
    avg = (torch.where(unval, 0.0, dis).sum(dim=(-1, -2))
           / torch.full((), total, dtype=dis.dtype, device=dis.device))
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


def _stress(dis: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Raw stress over unordered pairs (reference statistics/css/css.c:767-777):
    half the full-matrix sum.  The diagonal counts too: ``d``'s is zero,
    but a filled ``dis`` holds the fill average there, so the stress
    carries the constant 0.5 m avg^2, as in the JAX package."""
    diff = d - dis
    return 0.5 * (diff * diff).sum(dim=(-1, -2))


def _guttman(x: torch.Tensor, d: torch.Tensor, dis: torch.Tensor) -> torch.Tensor:
    """One Guttman transform (reference statistics/css/css.c:811-836):
    X' = B(Z) Z / m, B off-diagonal -dis/d where d >= 1e-5, diagonal
    -rowsum."""
    m = dis.shape[-1]
    eye = torch.eye(m, dtype=torch.bool, device=dis.device)
    b = torch.where(~eye & (d >= 0.00001), -dis / torch.where(d == 0, 1.0, d), 0.0)
    rowsum = b.sum(dim=-1)
    b = b - rowsum[..., None] * eye.to(b.dtype)
    return (b @ x) / m


def _smacof_loop(
    dis: torch.Tensor, x0: torch.Tensor, max_iters: int, epsilon: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`smacof` plus each element's transform count (int32).  The
    masked loop of the JAX scan, stopped once no element is active: a
    frozen element never changes, so the result equals the fixed
    ``max_iters + 1``-step scan's."""
    x = x0
    d = calc_dist(x0)
    sig = _stress(dis, d)
    active = sig == sig       # as JAX: a NaN start never iterates
    n = torch.zeros(sig.shape, dtype=torch.int32, device=sig.device)
    for _ in range(max_iters + 1):
        if not bool(active.any()):
            break
        xn = _guttman(x, d, dis)
        dn = calc_dist(xn)
        sign = _stress(dis, dn)
        improved = (sig - sign) > epsilon
        x = torch.where(active[..., None, None], xn, x)
        d = torch.where(active[..., None, None], dn, d)
        sig = torch.where(active, sign, sig)
        n = n + active.to(torch.int32)
        active = active & improved
    return x, sig, n


def smacof(
    dis: torch.Tensor, x0: torch.Tensor, max_iters: int = 300, epsilon: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched SMACOF (reference statistics/css/css.c:907-938).

    ``dis``: [..., m, m], ``x0``: [..., m, 2].  The reference's loop
    protocol: the first transform is unconditional, then transforms go on
    while the stress improvement exceeds epsilon and k <= max_iters (so up
    to max_iters + 1), each element freezing on its own.  Returns (x,
    sigma)."""
    x, sig, _ = _smacof_loop(dis, x0, max_iters, epsilon)
    return x, sig


def _argmin_nan_first(sig: torch.Tensor) -> torch.Tensor:
    """numpy's argmin over dim 0: the first NaN, else the first minimum
    (stresses are >= 0, so a NaN can stand in as -inf)."""
    return torch.where(sig.isnan(), -torch.inf, sig).argmin(dim=0)


def _smacof_restarts(
    dis: torch.Tensor, wkeys: torch.Tensor, n_init: int, max_iters: int,
    epsilon: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`smacof_runs` plus each window's chosen restart, that
    restart's transform count and the transforms of every restart summed:
    (x [B, m, 2], restart, ntrans, total)."""
    B, m = dis.shape[0], dis.shape[-1]
    x0 = rng.smacof_inits(wkeys.to(dis.device), n_init, m, dis.dtype)   # [B, I, m, 2]
    x, sig, n = _smacof_loop(dis[None], x0.movedim(1, 0), max_iters, epsilon)
    best = _argmin_nan_first(sig)                                      # [B]
    cols = torch.arange(B, device=dis.device)
    return x[best, cols], best.to(torch.int32), n[best, cols], n.sum(dim=0, dtype=torch.int32)


def _smacof_best(
    dis: torch.Tensor, wkeys: torch.Tensor, n_init: int, max_iters: int,
    epsilon: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`smacof_runs` plus each window's chosen restart and that
    restart's transform count: (x [B, m, 2], restart, ntrans)."""
    return _smacof_restarts(dis, wkeys, n_init, max_iters, epsilon)[:3]


def smacof_runs(
    dis: torch.Tensor,
    wkeys: torch.Tensor,     # [B, 2] per-window keys (rng.slot_keys)
    n_init: int = 4,
    max_iters: int = 300,
    epsilon: float = 1e-6,
) -> torch.Tensor:
    """SMACOF with random restarts, best of ``n_init`` by stress
    (reference statistics/css/css.c:852-884).  Each window draws its
    restarts from its own slot key (:func:`rng.smacof_inits`), so the
    chosen embedding does not depend on the batching.  ``dis``:
    [B, m, m] -> [B, m, 2]."""
    return _smacof_best(dis, wkeys, n_init, max_iters, epsilon)[0]


# ------------------------------------------------ K6's order of operations


WARP_LANES = 32        # threads of K6's warp form (css_smacof)
BLOCK_LANES = 256      # threads of K6's block form (css_smacof_block, kSmacofThreads)


def smacof_lanes(m: int, mode: int, dtype: torch.dtype,
                 device: torch.device | None = None) -> int:
    """Threads that share one restart in the kernel :func:`css_smacof`
    launches at panel size m on ``device`` (the ``lanes`` of
    :func:`smacof_pairs`; asks the kernel library, so the card)."""
    return WARP_LANES if smacof_form(m, mode, dtype, device) == "warp" else BLOCK_LANES


def _butterfly(acc: torch.Tensor) -> torch.Tensor:
    """The kernels' xor butterfly over the last dim (32 lanes): lane 0's
    value, which every lane holds."""
    idx = torch.arange(32, device=acc.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., idx ^ o]
    return acc[..., 0]


def _block_sum(v: torch.Tensor, lanes: int) -> torch.Tensor:
    """The kernels' sum of v [..., P] over ``lanes`` threads (a multiple
    of 32): element p on thread p % lanes, each thread's partial added in
    p order, the xor butterfly in each warp, then the warps' sums added in
    warp order (``css_block.cuh`` block_reduce; with 32 lanes
    :func:`kernels.fet._lane_sum`).  The zero padding adds +0.0 to
    partials that are never -0.0, so it changes no bit."""
    if lanes == WARP_LANES:
        return _lane_sum(v)
    P = v.shape[-1]
    K = -(-P // lanes)
    t = torch.nn.functional.pad(v, (0, lanes * K - P)).reshape(*v.shape[:-1], K, lanes)
    acc = torch.zeros_like(t[..., 0, :])
    for k in range(K):
        acc = acc + t[..., k, :]
    acc = _butterfly(acc.reshape(*v.shape[:-1], lanes // 32, 32))
    s = acc[..., 0]
    for q in range(1, lanes // 32):
        s = s + acc[..., q]
    return s


def _pair_pass(fp: torch.Tensor, x: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
               diag: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's warp form's pair pass over x [..., m, 2]: (the stress of x,
    B(x) [..., m, m] with a zero diagonal), d_ij and b_ij once a pair
    i < j, the stress in lane order."""
    r, b = _pair_terms(fp, x, i, j)
    m = x.shape[-2]
    bm = torch.zeros((*x.shape[:-1], m), dtype=x.dtype, device=x.device)
    bm[..., i, j] = b
    bm[..., j, i] = b
    return _lane_sum(r * r) + diag, bm


def _pair_terms(fp, x, i, j):
    """Each pair's residual d_ij - F_ij and b_ij = -F_ij / d_ij (0 where
    d_ij < 1e-5), d_ij = ||x_i - x_j|| once a pair i < j."""
    dx = x[..., i, :] - x[..., j, :]
    d = torch.sqrt(dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1])
    b = torch.where(d >= 0.00001, -fp / torch.where(d == 0, 1.0, d), 0.0)
    return d - fp, b


def _row_pass(bm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K6's row pass: XN_i = (sum_{j != i} b_ij x_j - rowsum_i x_i) / m,
    each row's sums in j order."""
    m = x.shape[-2]
    zero = torch.zeros_like(x[..., 0])
    rs, a0, a1 = zero, zero, zero
    rows = torch.arange(m, device=x.device)
    for j in range(m):
        b = bm[..., :, j]
        off = rows != j
        rs = torch.where(off, rs + b, rs)
        a0 = torch.where(off, a0 + b * x[..., j, 0][..., None], a0)
        a1 = torch.where(off, a1 + b * x[..., j, 1][..., None], a1)
    return _transform(rs, a0, a1, x)


def _transform(rs, a0, a1, x):
    """XN = (a - rs x) / m from the row sums [..., m]."""
    m = x.shape[-2]
    # a divisor tensor on x's device: torch on CUDA multiplies by the
    # reciprocal of a Python-number divisor, the kernel divides
    mt = torch.full((), m, dtype=x.dtype, device=x.device)
    return torch.stack([(a0 - rs * x[..., 0]) / mt, (a1 - rs * x[..., 1]) / mt], dim=-1)


@functools.lru_cache(maxsize=16)
def _block_plan(m: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """Index tensors of the block form's fused pass at panel size m
    (``csrc/css_smacof.cu`` pair_sums; pair p = (i, j), i < j, row-major,
    P = m(m-1)/2 stands for an added zero):

    * ``stress`` [NW, 32, L]: each lane's pairs in the order it adds their
      residuals: warp w's rows s NW + w (s even) or s NW + NW - 1 - w (s
      odd), s ascending, and in row i the pairs j = i + 1 + lane + 32t, t
      ascending;
    * ``rowp`` [m, 32, T]: row i's pairs on each lane, t ascending;
    * ``colp`` [S, NW, m]: the pair of (row of warp w in slot s, column j),
      P where that row does not precede j (or the slot is empty)."""
    NW = BLOCK_LANES // 32
    P = m * (m - 1) // 2
    pid = np.full((m + 1, m), P, dtype=np.int64)
    iu, ju = np.triu_indices(m, 1)
    pid[iu, ju] = np.arange(P)
    T = max(1, -(-(m - 1) // 32))
    lane = np.arange(32)
    cols = (np.arange(m)[:, None, None] + 1 + lane[None, :, None]
            + 32 * np.arange(T)[None, None, :])                        # [m, 32, T]
    rowp = np.where(cols < m, pid[np.arange(m)[:, None, None], np.minimum(cols, m - 1)],
                    P)                                                 # [m, 32, T]
    S = -(-m // NW)
    s = np.arange(S)[:, None]
    w = np.arange(NW)[None, :]
    rows = s * NW + np.where(s % 2 == 1, NW - 1 - w, w)                # [S, NW]
    rows = np.where(rows < m, rows, m)
    colp = pid[rows]                                                   # [S, NW, m]
    seq = np.concatenate([rowp, np.full((1, 32, T), P)])[rows]         # [S, NW, 32, T]
    seq = seq.transpose(1, 2, 0, 3).reshape(NW, 32, S * T)
    keep = seq != P
    L = int(keep.sum(-1).max()) if P else 1
    stress = np.full((NW, 32, max(L, 1)), P, dtype=np.int64)
    for wi in range(NW):
        for li in range(32):
            got = seq[wi, li][keep[wi, li]]
            stress[wi, li, :len(got)] = got
    return tuple(torch.from_numpy(a).to(device) for a in (stress, rowp, colp))


def _fused_pass(fp, x, i, j, diag, plan):
    """K6's block form's pass over x [..., m, 2] (``css_smacof.cu``
    pair_sums and guttman_finish): (the stress of x, its transform XN).
    The stress: each lane's residuals in its order, the warps' butterflies,
    the warps in order, then diag.  Row i's sums: its column partials
    (each warp's, added over its rows in row order) in warp order, then
    its own row partial (each lane's in t order, a butterfly)."""
    stress_idx, rowp_idx, colp_idx = plan
    r, b = _pair_terms(fp, x, i, j)
    zero = torch.zeros_like(r[..., :1])
    r2 = torch.cat([r * r, zero], dim=-1)
    acc = torch.zeros((*r.shape[:-1], *stress_idx.shape[:2]), dtype=r.dtype, device=r.device)
    for k in range(stress_idx.shape[-1]):
        acc = acc + r2[..., stress_idx[..., k]]
    spw = _butterfly(acc)
    st = spw[..., 0]
    for q in range(1, spw.shape[-1]):
        st = st + spw[..., q]
    # row partials (b, b x_j0, b x_j1) and column partials (b, b x_i0, b x_i1)
    xi, xj = x[..., i, :], x[..., j, :]
    rv = torch.cat([torch.stack([b, b * xj[..., 0], b * xj[..., 1]], dim=-2),
                    zero[..., None, :].expand(*zero.shape[:-1], 3, 1)], dim=-1)
    cv = torch.cat([torch.stack([b, b * xi[..., 0], b * xi[..., 1]], dim=-2),
                    zero[..., None, :].expand(*zero.shape[:-1], 3, 1)], dim=-1)
    racc = torch.zeros((*rv.shape[:-1], *rowp_idx.shape[:2]), dtype=r.dtype, device=r.device)
    for t in range(rowp_idx.shape[-1]):
        racc = racc + rv[..., rowp_idx[..., t]]
    rowp = _butterfly(racc)                                  # [..., 3, m]
    cacc = torch.zeros((*cv.shape[:-1], *colp_idx.shape[1:]), dtype=r.dtype, device=r.device)
    for s_ in range(colp_idx.shape[0]):
        cacc = cacc + cv[..., colp_idx[s_]]                  # [..., 3, NW, m]
    tot = cacc[..., 0, :]
    for q in range(1, cacc.shape[-2]):
        tot = tot + cacc[..., q, :]
    tot = tot + rowp
    return st + diag, _transform(tot[..., 0, :], tot[..., 1, :], tot[..., 2, :], x)


def smacof_pairs(
    dis: torch.Tensor, x0: torch.Tensor, max_iters: int = 300, epsilon: float = 1e-6,
    lanes: int = WARP_LANES,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_smacof_loop` in K6's order of operations, for tests
    (``csrc/css_smacof.cu``), over ``lanes`` threads (:func:`smacof_lanes`;
    ``dis`` must be symmetric; the stress is sum_{i<j} (d_ij - F_ij)^2 +
    0.5 sum_i F_ii^2 and d_ij is formed once a pair a pass):

    * 32, the warp form: one pair pass a transform gives the stress of the
      new configuration and the next transform's B, the stress in lane
      order and a warp butterfly, then a row pass, each row's sums in j
      order;
    * BLOCK_LANES, the block form: one fused pass over the pairs gives the
      stress of a configuration and its transform at once
      (:func:`_fused_pass`); the stop test reads the pass that made the
      next configuration, whose transform is then left unused.

    Returns (x, sigma, transforms)."""
    m = dis.shape[-1]
    i, j = torch.triu_indices(m, m, 1, device=dis.device)
    fp = dis[..., i, j]
    dd = torch.diagonal(dis, dim1=-2, dim2=-1)
    diag = 0.5 * _block_sum(dd * dd, lanes)
    if lanes == WARP_LANES:
        sig, bm = _pair_pass(fp, x0, i, j, diag)

        def step(x, bm):
            xn = _row_pass(bm, x)
            return (xn, *_pair_pass(fp, xn, i, j, diag))
    else:
        plan = _block_plan(m, dis.device)
        sig, bm = _fused_pass(fp, x0, i, j, diag, plan)   # bm: the transform of x

        def step(x, xn):
            return (xn, *_fused_pass(fp, xn, i, j, diag, plan))
    x = x0
    active = sig == sig
    n = torch.zeros(sig.shape, dtype=torch.int32, device=sig.device)
    for _ in range(max_iters + 1):
        if not bool(active.any()):
            break
        xn, sign, bn = step(x, bm)
        improved = (sig - sign) > epsilon
        x = torch.where(active[..., None, None], xn, x)
        bm = torch.where(active[..., None, None], bn, bm)
        sig = torch.where(active, sign, sig)
        n = n + active.to(torch.int32)
        active = active & improved
    return x, sig, n


def _score_pipeline(
    dis: torch.Tensor,        # [B, m, m] window dissimilarities (dtype set)
    npos: torch.Tensor,
    wkeys: torch.Tensor | None,   # [B, 2] per-window keys (mds=1)
    a_sz: int,
    b_sz: int,
    mds: int,
    smacof_iters: int = 300,
    smacof_inits: int = 4,
    smacof_eps: float = 1e-6,
) -> tuple[torch.Tensor, ...]:
    """``divergence_tpu/kernels/css.py:_score_pipeline`` for one batch:
    (scores, dist, valid, restart, ntrans, total).  The last three are the
    SMACOF diagnostics (the chosen restart, its transform count and the
    transforms of every restart summed; zeros for CMDS)."""
    filled, keep = fill_averages(dis)
    B = dis.shape[0]
    restart = torch.zeros(B, dtype=torch.int32, device=dis.device)
    ntrans = torch.zeros(B, dtype=torch.int32, device=dis.device)
    total = ntrans
    if mds == 0:
        x = cmds(filled)
    elif mds == 1:
        x, restart, ntrans, total = _smacof_restarts(
            filled, wkeys, smacof_inits, smacof_iters, smacof_eps
        )
    else:
        x, _, ntrans = _smacof_loop(filled, cmds(filled), smacof_iters, smacof_eps)
        total = ntrans
    dist = calc_dist(x)
    scores = css_from_dist(dist, a_sz, b_sz)
    valid = keep & (npos > 0)
    return torch.where(valid, scores, 0.0), dist, valid, restart, ntrans, total


def _score_plain(
    dis: torch.Tensor, npos: torch.Tensor, asize: int, bsize: int, mds: int,
    wkeys: torch.Tensor | None = None, **smacof_kw,
) -> tuple[torch.Tensor, ...]:
    """:func:`_score_pipeline` over window batches of at most ``_CMDS_BATCH``
    windows and ``_PLAIN_BATCH_ELEMS`` elements."""
    B, m = dis.shape[0], dis.shape[-1]
    npos = npos.to(dis.device)
    if B == 0:
        dev = dis.device
        return (torch.zeros(0, dtype=torch.float64, device=dev),
                torch.zeros((0, m, m), dtype=dis.dtype, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    reps = smacof_kw.get("smacof_inits", 1) if mds == 1 else 1
    step = max(1, min(_CMDS_BATCH, _PLAIN_BATCH_ELEMS // (m * m * reps)))
    parts = []
    for s in range(0, B, step):
        sl = slice(s, min(s + step, B))
        parts.append(_score_pipeline(
            dis[sl], npos[sl], None if wkeys is None else wkeys[sl],
            asize, bsize, mds, **smacof_kw,
        ))
    return tuple(torch.cat(cols) for cols in zip(*parts))


# ------------------------------------------------- K5 / K6 kernel forms

_SCORE_FORMS = ("warp", "block", "device")


def cmds_form(m: int, dtype: torch.dtype, device: torch.device | None = None) -> str:
    """The kernel :func:`css_cmds` launches at panel size m on ``device``,
    by the kernel library's own reckoning (``csrc/css_cmds.cu:
    css_cmds_form``): ``"warp"`` (``css_cmds``, a warp per window: on an
    H100 float64 to m = 75, float32 to 111), ``"block"``
    (``css_cmds_block``, a block per window, its slab in shared memory:
    float64 to 221, float32 to 321) or ``"device"`` (the same kernel, the
    slabs in device memory)."""
    return _cmds_form(m, dtype, device)[0]


def _cmds_form(m, dtype, device):
    return query_form(_SCORE_FORMS, f"css_cmds_form_{dtype_suffix(dtype)}", device, m)


def smacof_form(m: int, mode: int, dtype: torch.dtype,
                device: torch.device | None = None) -> str:
    """The kernel :func:`css_smacof` launches, as :func:`cmds_form`
    (``csrc/css_smacof.cu:css_smacof_form``): ``"warp"`` (``css_smacof``:
    on an H100 float64 to m = 68, float32 to 97), ``"block"``
    (``css_smacof_block``, a window a block, slab in shared memory:
    float64 to 203, float32 to 302) or ``"device"``."""
    return _smacof_form(m, mode, dtype, device)[0]


def _smacof_form(m, mode, dtype, device):
    return query_form(_SCORE_FORMS, f"css_smacof_form_{dtype_suffix(dtype)}", device, m, mode)


def _device_slabs(form: str, elems: int, dtype: torch.dtype, dev: torch.device):
    """(slabs, count) of a block form: one slab of ``elems`` per SM in
    device memory for ``"device"`` (a grid of one block per SM, so the
    slabs stay in L2), none (shared memory) for ``"block"``."""
    if form != "device":
        return None, 0
    n = torch.cuda.get_device_properties(dev).multi_processor_count
    return torch.empty(n * elems, dtype=dtype, device=dev), n


def css_cmds_plain(
    dis: torch.Tensor, npos: torch.Tensor, asize: int, bsize: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`css_cmds`
    (``divergence_tpu/kernels/css.py:_score_pipeline`` with ``mds=0``),
    over window batches (:func:`_score_plain`)."""
    return _score_plain(dis, npos, asize, bsize, 0)[:3]


def css_cmds(
    dis: torch.Tensor,    # [B, m, m] window dissimilarities (compute dtype)
    npos: torch.Tensor,   # [B] SNPs per window (a window with none is invalid)
    asize: int,
    bsize: int,
    steps: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CMDS scores of every window: (scores [B], dist [B, m, m], valid
    [B]), ``valid`` False for empty and discarded windows, whose score is
    0 (``divergence_tpu/kernels/css.py:_score_pipeline``, ``mds=0``).
    ``steps``, an int32 [B] tensor on the card, receives each window's
    multisection steps (a diagnostic of the kernel's eigensolver; the
    plain version leaves it untouched)."""
    if is_cpu(dis):
        return css_cmds_plain(dis, npos, asize, bsize)
    dev = dis.device
    B, m = dis.shape[0], dis.shape[-1]
    if m != asize + bsize or dis.shape != (B, m, m) or not dis.is_contiguous():
        raise ValueError("css_cmds kernel takes a contiguous [B, m, m] tensor, m = a + b")
    scores = torch.empty(B, dtype=dis.dtype, device=dev)
    dist = torch.empty_like(dis)
    valid = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return scores, dist, valid
    if steps is not None and (steps.shape != (B,) or steps.dtype != torch.int32
                              or steps.device != dev or not steps.is_contiguous()):
        raise ValueError("css_cmds writes steps into a contiguous int32 [B] tensor "
                         "on the card")
    w = chain_weights_host(asize, bsize)
    wa = float(w[0]) if asize > 1 else 0.0
    wb = float(w[-1]) if bsize > 1 else 0.0
    npos_d = npos.to(dev, torch.int64).contiguous()
    sfx = dtype_suffix(dis.dtype)
    args = (ptr(dis), ptr(npos_d), B, asize, bsize, wa, wb, ptr(scores), ptr(dist),
            ptr(valid), ptr(steps))
    form, elems = _cmds_form(m, dis.dtype, dev)
    if form == "warp":
        launch(LAUNCHES, "css_cmds", f"css_cmds_{sfx}", dev, *args)
    else:
        slabs, n = _device_slabs(form, elems, dis.dtype, dev)
        launch(LAUNCHES, "css_cmds_block", f"css_cmds_block_{sfx}", dev, *args, ptr(slabs), n)
    return scores, dist, valid


# --------------------------------------------------------------------------
# K6: fill-averages, SMACOF, distances, score
# --------------------------------------------------------------------------

def _check_transforms(transforms, B, dev) -> None:
    if transforms is not None and (
            transforms.shape != (B,) or transforms.dtype != torch.int32
            or transforms.device != dev or not transforms.is_contiguous()):
        raise ValueError("css_smacof writes transforms into a contiguous int32 [B] tensor "
                         f"on {dev}")


def css_smacof_plain(
    dis: torch.Tensor, npos: torch.Tensor, asize: int, bsize: int, mds: int,
    key: torch.Tensor, slots: torch.Tensor, n_init: int = 4,
    max_iters: int = 300, epsilon: float = 1e-6, transforms: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """Plain torch version of :func:`css_smacof`
    (``divergence_tpu/kernels/css.py:_score_pipeline`` with ``mds`` 1 or
    2), over window batches (:func:`_score_plain`)."""
    _check_transforms(transforms, dis.shape[0], dis.device)
    wkeys = None
    if mds == 1:
        slots = torch.as_tensor(slots, dtype=torch.int64).to(dis.device)
        wkeys = rng.slot_keys(key.to(dis.device), slots)
    out = _score_plain(
        dis, npos, asize, bsize, mds, wkeys, smacof_iters=max_iters,
        smacof_inits=n_init, smacof_eps=epsilon,
    )
    if transforms is not None:
        transforms.copy_(out[5])
    return out[:5]


def css_smacof(
    dis: torch.Tensor,    # [B, m, m] window dissimilarities (compute dtype)
    npos: torch.Tensor,   # [B] SNPs per window (a window with none is invalid)
    asize: int,
    bsize: int,
    mds: int,             # 1: n_init uniform restarts; 2: one, from CMDS
    key: torch.Tensor,    # [2] chromosome key, fold_in(PRNGKey(seed), chrom)
    slots: torch.Tensor,  # [B] window slots: restart keys fold_in(key, slot)
    n_init: int = 4,
    max_iters: int = 300,
    epsilon: float = 1e-6,
    transforms: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """SMACOF scores of every window: (scores [B], dist [B, m, m], valid
    [B], restart [B], ntrans [B]) (``divergence_tpu/kernels/css.py:
    _score_pipeline``, ``mds`` 1 or 2; ``dis`` symmetric, as every
    dissimilarity is).  ``restart`` and ``ntrans`` (int32) are diagnostics
    for testing: each window's chosen restart and that restart's number of
    Guttman transforms.  ``transforms``, an int32 [B] tensor on ``dis``'s
    device, receives each window's transforms summed over every restart
    (the work the kernel did)."""
    if mds not in (1, 2):
        raise ValueError(f"css_smacof runs mds 1 or 2, got {mds}")
    if mds == 1 and n_init < 1:
        raise ValueError(f"css_smacof runs at least 1 restart, got {n_init}")
    if is_cpu(dis):
        return css_smacof_plain(
            dis, npos, asize, bsize, mds, key, slots, n_init, max_iters, epsilon, transforms
        )
    dev = dis.device
    B, m = dis.shape[0], dis.shape[-1]
    if m != asize + bsize or dis.shape != (B, m, m) or not dis.is_contiguous():
        raise ValueError("css_smacof kernel takes a contiguous [B, m, m] tensor, m = a + b")
    _check_transforms(transforms, B, dev)
    scores = torch.empty(B, dtype=dis.dtype, device=dev)
    dist = torch.empty_like(dis)
    valid = torch.empty(B, dtype=torch.bool, device=dev)
    restart = torch.empty(B, dtype=torch.int32, device=dev)
    ntrans = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return scores, dist, valid, restart, ntrans
    w = chain_weights_host(asize, bsize)
    wa = float(w[0]) if asize > 1 else 0.0
    wb = float(w[-1]) if bsize > 1 else 0.0
    npos_d = npos.to(dev, torch.int64).contiguous()
    slots_d = torch.as_tensor(slots, dtype=torch.int64).to(dev).contiguous()
    k0, k1 = (int(v) for v in key.tolist())
    sfx = dtype_suffix(dis.dtype)
    args = (ptr(dis), ptr(npos_d), ptr(slots_d), B, ctypes.c_uint32(k0),
            ctypes.c_uint32(k1), asize, bsize, mds, n_init, max_iters,
            float(epsilon), wa, wb, ptr(scores),
            ptr(dist), ptr(valid), ptr(restart), ptr(ntrans), ptr(transforms))
    form, elems = _smacof_form(m, mds, dis.dtype, dev)
    if form == "warp":
        tasks = B * (n_init if mds == 1 else 1)
        # the task counter, then each window's finished restarts; each
        # task's stress, transforms and final X
        counters = torch.zeros(B + 1, dtype=torch.int32, device=dev)
        sig_s = torch.empty(tasks, dtype=dis.dtype, device=dev)
        x_s = torch.empty((tasks, m, 2), dtype=dis.dtype, device=dev)
        n_s = torch.empty(tasks, dtype=torch.int32, device=dev)
        launch(LAUNCHES, "css_smacof", f"css_smacof_{sfx}", dev, *args, ptr(counters),
               ptr(sig_s), ptr(x_s), ptr(n_s))
    else:
        # the block form: a window a task (its restarts in turn), the task
        # counter alone
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        slabs, n = _device_slabs(form, elems, dis.dtype, dev)
        launch(LAUNCHES, "css_smacof_block", f"css_smacof_block_{sfx}", dev, *args,
               ptr(counter), ptr(slabs), n)
    return scores, dist, valid, restart, ntrans


# --------------------------------------------------------------------------
# phase 1 of a chromosome
# --------------------------------------------------------------------------

def css_phase1(
    vals: torch.Tensor,   # [N, a+b] joint codes or frequencies (SnpPair.to_device)
    lo: np.ndarray | torch.Tensor,     # [B] first SNP of each window
    npos: np.ndarray | torch.Tensor,   # [B] SNPs per window
    asize: int,
    bsize: int,
    fast: bool = False,
    mds: int = 0,
    key: torch.Tensor | None = None,   # [2] chromosome key (mds=1)
    slots: np.ndarray | torch.Tensor | None = None,  # [B] window slots (mds=1)
    drosophila: bool = False,
    smacof_iters: int = 300,
    smacof_inits: int = 4,
    smacof_eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every window of a chromosome in one call: dissimilarities, then
    CMDS (``mds=0``) or SMACOF (``mds`` 1, 2) scoring
    (``divergence_tpu/kernels/css.py:css_prefix_all`` and
    ``css_gather_all``).  Drosophila mode scores the two frequency
    pseudo-individuals (columns 0 and ``asize`` of ``vals``) with
    ``asize = bsize = 1``.  Returns (scores [B], dist [B, m, m], valid [B])
    on ``vals.device``, in the compute dtype of ``fast``."""
    dtype = compute_dtype("fast" if fast else "exact")
    lo = torch.as_tensor(lo, dtype=torch.int64)
    npos = torch.as_tensor(npos, dtype=torch.int64)
    if lo.numel() and (int(lo.min()) < 0 or int((lo + npos).max()) > vals.shape[0]):
        raise ValueError("window descriptors reach outside the SNP matrix")
    if mds == 1 and (key is None or slots is None):
        raise ValueError("mds=1 draws its restarts from the chromosome key and slots")
    if not is_cpu(vals) and lo.device.type == "cpu":
        # one pinned upload serves every kernel
        rows = [lo, npos]
        if slots is not None:
            rows.append(torch.as_tensor(slots, dtype=torch.int64))
        rows = torch.stack(rows).pin_memory().to(vals.device, non_blocking=True)
        lo, npos = rows[0], rows[1]
        slots = None if slots is None else rows[2]
    if drosophila:
        dis = dissimilarity_freq_windows(vals[:, 0], vals[:, asize], lo, npos).to(dtype)
        asize = bsize = 1
    else:
        dis = css_dissim(vals, lo, npos, dtype)
    return _score_windows(dis, npos, asize, bsize, mds, key, slots, smacof_iters,
                          smacof_inits, smacof_eps)


def _score_windows(dis, npos, asize, bsize, mds, key, slots, smacof_iters, smacof_inits,
                   smacof_eps):
    """K5 (``mds=0``) or K6 on the windows' dissimilarities."""
    if mds == 0:
        return css_cmds(dis, npos, asize, bsize)
    return css_smacof(
        dis, npos, asize, bsize, mds, key, slots, smacof_inits, smacof_iters,
        smacof_eps,
    )[:3]


def css_window_batch(
    avals: torch.Tensor,   # [B, P, asize] codes (frequencies in drosophila mode)
    bvals: torch.Tensor,   # [B, P, bsize]
    npos: torch.Tensor,    # [B] true SNP count per window
    key: torch.Tensor,     # [2] key; window b's restarts fold in slot[b] (mds=1)
    asize: int,
    bsize: int,
    drosophila: bool = False,
    mds: int = 0,
    smacof_iters: int = 300,
    smacof_inits: int = 4,
    smacof_eps: float = 1e-6,
    fast: bool = False,
    slot: torch.Tensor | None = None,   # [B] window slots; default arange(B)
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CSS scores of a batch of pre-gathered windows
    (``divergence_tpu/kernels/css.py:css_window_batch``): (scores [B],
    dist [B, m, m], valid [B]).  ``valid`` is False for empty windows and
    fill-averages discards, whose score is 0.

    Genotype codes go in as int16 (``codes_int16``: the counts only
    ``==``-compare them) and their counts come from
    :func:`css_dissim_gathered`, which reads the a and b codes where they
    lie (K4's gather form; the same integer counts as
    ``dissimilarity_counts``), then K5 or K6.  Drosophila frequencies keep
    their float values (column 0 of each group).  ``plain=True`` runs the
    plain torch versions on any device (the twin a card run is held
    against)."""
    B, P = avals.shape[:2]
    npos = torch.as_tensor(npos).to(torch.int64)
    slot = torch.arange(B) if slot is None else torch.as_tensor(slot).to(torch.int64)
    dtype = compute_dtype("fast" if fast else "exact")
    dev = avals.device
    if not plain and not is_cpu(avals):
        # one pinned upload serves every kernel
        rows = torch.stack([npos.cpu(), slot.cpu()]).pin_memory().to(dev, non_blocking=True)
        npos_d, slot_d = rows[0], rows[1]
    else:
        npos_d, slot_d = npos.to(dev), slot.to(dev)
    if drosophila:
        lo = torch.arange(B, dtype=torch.int64, device=dev) * P
        dis = dissimilarity_freq_windows(avals[..., 0].reshape(B * P),
                                         bvals[..., 0].reshape(B * P), lo, npos_d).to(dtype)
        asize = bsize = 1
    else:
        a16, b16 = (codes_int16(v).contiguous() for v in (avals, bvals))
        if plain:
            dis = dissimilarity_gathered_plain(a16, b16, npos_d).to(dtype)
        else:
            dis = css_dissim_gathered(a16, b16, npos, dtype)
    if not plain:
        return _score_windows(dis, npos_d, asize, bsize, mds, key, slot_d, smacof_iters,
                              smacof_inits, smacof_eps)
    if mds == 0:
        return css_cmds_plain(dis, npos_d, asize, bsize)
    return css_smacof_plain(
        dis, npos_d, asize, bsize, mds, key, slot_d, smacof_inits, smacof_iters, smacof_eps
    )[:3]
