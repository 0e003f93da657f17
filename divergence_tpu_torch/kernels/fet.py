"""Batched Fisher's Exact Test: per-SNP scores (K1) and the window
percentile + bootstrap stddev (K2).

Port of ``divergence_tpu/kernels/fet.py``; every function keeps its JAX
name and semantics (the reference's Zar-shortcut two-tailed test,
reference statistics/fisher/cFisher.c:405-455, and the order-statistic
bootstrap of the window percentile, cFisher.c:562-597).  The math is
plain torch on tensors of any device.

These functions launch hand-written CUDA kernels (``csrc/``) when their
tensors lie on a CUDA device, and run the plain torch version when they
lie on the CPU:

* :func:`fet_lut`             — ``csrc/fet_snp.cu:fet_lut_build``, the
  score of every possible table (K1, LUT regime);
* :func:`fet_snp_logs`        — ``csrc/fet_snp.cu:fet_snp_logs``, the
  score of every SNP (K1);
* :func:`fet_aggregate`       — ``csrc/fet_aggregate.cu``, every window of
  a chromosome in one launch (K2);
* :func:`fet_lut_rank`        — ``csrc/fet_rank.cu:fet_lut_rank``, the
  stable ascending sort of the LUT (K1r);
* :func:`fet_snp_ranks`       — ``csrc/fet_rank.cu:fet_snp_ranks``, every
  SNP's rank into the sorted LUT (K1r, with K1's LUT build and the sort);
* :func:`fet_aggregate_ranks` — ``csrc/fet_aggregate_ranks.cu``, K2 on the
  ranks, mapped through the sorted LUT (K2r);
* :func:`fet_window_batch`    — ``csrc/fet_window.cu``, K1's per-table
  score and K2's window body on pre-gathered windows (K10), the sharded
  step's FET part.

K2, K2r and K10 take windows of any width: a warp per window up to 128
SNPs' padding, a block per window to 256, and past that their ``*_wide``
kernels, which sort nothing: the bootstrap first, then a radix select of the band of ranks its
picks need (:func:`window_form` asks the kernel library which; the body's
orders in torch: :func:`order_stat_uniforms_tiled`, :func:`band_picks`,
:func:`aggregate_band`).

There is no fallback: on a CUDA tensor the kernel runs or the call
raises.  Each launch adds one to :data:`LAUNCHES`.

The LUT depends on the panel and precision only, so :func:`fet_snp_logs`,
:func:`fet_snp_ranks` and :func:`fet_window_batch` read it (and K1r's sort
of it) from a cache of one entry per (asize, bsize, maxs, nmax, dtype,
device), built on first use (:func:`lut_cached`, :func:`lut_rank_cached`;
:func:`clear_lut_cache`): one build and one sort a key per process, not
one a chromosome call.  :func:`fet_lut` and :func:`fet_lut_rank` stay
uncached.

The rank path (K1r -> K2r) is the JAX package's exact-mode route in the
LUT regime (``divergence_tpu/engine/fet_engine.py``): its window sort
runs on int32 ranks, and its results equal the float path's (K1 -> K2)
bit for bit.  Not ported, because they exist only for the TPU: the
one-hot MXU picks and the two-stage window gather.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch

from divergence_tpu_torch import compute_dtype, rng
from divergence_tpu_torch.kernels._cuda import dtype_suffix, is_cpu, launch, ptr, query_form

_LUT_MAX_BUILD_OPS = 100_000_000

_AGG_WINDOW_CHUNK = 65_536     # windows per step of the plain aggregate

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES = {"fet_lut_build": 0, "fet_snp_logs": 0, "fet_aggregate": 0, "fet_window": 0,
            "fet_lut_rank": 0, "fet_snp_ranks": 0, "fet_aggregate_ranks": 0,
            "fet_aggregate_wide": 0, "fet_aggregate_ranks_wide": 0, "fet_window_wide": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def support_size(asize: int, bsize: int) -> int:
    """Static bound on the hypergeometric support after table shifting.

    With the minimum cell leading, hi = min(R1', C1') <= N/2 where
    N <= asize + bsize individuals enter the table."""
    return (asize + bsize) // 2 + 2


def _log_factorials(nmax: int) -> np.ndarray:
    """lgamma(i+1) for i in 0..nmax, computed host-side once."""
    from scipy.special import gammaln

    return gammaln(np.arange(nmax + 1, dtype=np.float64) + 1.0)


@functools.lru_cache(maxsize=16)
def _lf_table(nmax: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """:func:`_log_factorials` on ``device``, uploaded once per
    (nmax, dtype, device): a fresh upload from pageable memory would wait
    for the work already queued on the stream.  Read-only."""
    return torch.as_tensor(_log_factorials(nmax), dtype=dtype, device=device)


def _const(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (JAX's ``dtype(np.log(...))``
    constants), returned as a Python float that ``dtype`` holds exactly."""
    return float(np.float32(value)) if dtype == torch.float32 else float(value)


def count_tables(avals: torch.Tensor, bvals: torch.Tensor) -> torch.Tensor:
    """2x2 allele-count tables for every SNP.

    ``avals``: [..., asize], ``bvals``: [..., bsize] genotype codes.
    Only homozygous calls are counted (reference statistics/fisher/cFisher.c:208-238).
    Returns [..., 4] int32 (f0..f3)."""
    f0 = (avals == 3).sum(-1, dtype=torch.int32)
    f1 = (avals == -3).sum(-1, dtype=torch.int32)
    f2 = (bvals == 3).sum(-1, dtype=torch.int32)
    f3 = (bvals == -3).sum(-1, dtype=torch.int32)
    return torch.stack([f0, f1, f2, f3], dim=-1)


def _shift_min_first(f: torch.Tensor) -> torch.Tensor:
    """Rotate each table in clockwise order so the minimum cell leads
    (reference statistics/fisher/cFisher.c:327-346).  argmin == first
    minimum, like min_idx."""
    cw = torch.stack([f[..., 0], f[..., 1], f[..., 3], f[..., 2]], dim=-1)
    idx = torch.argmin(cw, dim=-1)
    offs = (idx[..., None] + torch.arange(4, device=f.device)) % 4
    rot = torch.gather(cw, -1, offs)
    return torch.stack(
        [rot[..., 0], rot[..., 1], rot[..., 3], rot[..., 2]], dim=-1
    )


def _support_logp(tables, maxs, nmax, dtype):
    """Shared support-scan prelude of :func:`fet_two_tailed` and
    :func:`fet_two_tailed_neglog10`: the table normalization, margin
    test, and per-support-point log point probabilities.  Returns
    ``(x, logp, valid, a0, equal_margins)`` with ``logp`` unmasked
    (``-inf`` only at impossible cell combinations)."""
    dev = tables.device
    lf = _lf_table(nmax, dtype, dev)

    def lchoose(n, k):
        ok = (k >= 0) & (k <= n) & (n >= 0)
        kc = k.clamp(0, nmax)
        nc = n.clamp(0, nmax)
        val = lf[nc] - lf[kc] - lf[(nc - kc).clamp(0, nmax)]
        return torch.where(ok, val, float("-inf"))

    f = tables.to(torch.int64)
    R1 = f[..., 0] + f[..., 1]
    R2 = f[..., 2] + f[..., 3]
    C1 = f[..., 0] + f[..., 2]
    C2 = f[..., 1] + f[..., 3]
    equal_margins = (R1 == R2) | (C1 == C2)

    s = _shift_min_first(f)
    a0 = s[..., 0]
    r1 = s[..., 0] + s[..., 1]
    r2 = s[..., 2] + s[..., 3]
    c1 = s[..., 0] + s[..., 2]
    n = r1 + r2
    hi = torch.minimum(r1, c1)

    x = torch.arange(maxs, device=dev).reshape((1,) * a0.ndim + (maxs,))
    r1e, r2e, c1e, ne = (t[..., None] for t in (r1, r2, c1, n))
    logp = lchoose(r1e, x) + lchoose(r2e, c1e - x) - lchoose(ne, c1e)
    valid = x <= hi[..., None]
    return x, logp, valid, a0, equal_margins


def _observed(values, a0, maxs):
    """``values`` at the observed table's support point.  ``a0 < maxs``
    for every table a panel can produce; the clamp only keeps the
    unreachable LUT grid entries (f0 + f1 > asize) in bounds, where JAX's
    out-of-range gather fills instead."""
    return torch.gather(values, -1, a0.clamp(max=maxs - 1)[..., None])


def _suffix_blocked(bad: torch.Tensor) -> torch.Tensor:
    """Number of ``bad`` support points at or above each point."""
    return bad.flip(-1).to(torch.int32).cumsum(-1).flip(-1)


def fet_two_tailed(
    tables: torch.Tensor, maxs: int, nmax: int, dtype=torch.float64
) -> torch.Tensor:
    """Two-tailed FET p for a batch of 2x2 tables (Zar-shortcut
    semantics, ``divergence_tpu/kernels/fet.py:fet_two_tailed``).

    ``tables``: [..., 4] integer; ``maxs``: support bound; ``nmax``: max
    total count (for the log-factorial table).  Returns [...] in ``dtype``."""
    x, logp, valid, a0, equal_margins = _support_logp(tables, maxs, nmax, dtype)
    p = torch.where(valid, torch.exp(logp), 0.0)
    p0 = _observed(p, a0, maxs)
    a0e = a0[..., None]
    # first tail: every table from the observed minimum cell down to zero
    # (reference statistics/fisher/cFisher.c:422-427)
    t1 = torch.where(x <= a0e, p, 0.0).sum(-1)
    # second tail: scanned from the opposite extreme inward while STRICTLY
    # less probable than the observed table (cFisher.c:440); a position
    # contributes iff no valid table at >= x fails the comparison
    tie_rtol = 1e-12 if dtype == torch.float64 else 1e-5
    bad = (p >= p0 * (1.0 - tie_rtol)) & valid
    ok = (_suffix_blocked(bad) == 0) & valid & (x > a0e)
    t2 = torch.where(ok, p, 0.0).sum(-1)

    total = torch.where(equal_margins, 2.0 * t1, t1 + t2)
    # snap round-off-shy-of-1 totals to exactly 1 and clamp the >1
    # overshoots (cFisher.c:451-452)
    snap = 1e-12 if dtype == torch.float64 else 1e-5
    return torch.where(total > 1.0 - snap, 1.0, total)


def fet_two_tailed_neglog10(
    tables: torch.Tensor, maxs: int, nmax: int, dtype=torch.float32
) -> torch.Tensor:
    """``-log10`` of :func:`fet_two_tailed` computed without ever
    materializing ``p`` — the fast (f32) path's score function: a
    max-shifted log-sum-exp over the same selected support keeps every
    score finite where f32 ``p`` would underflow (large panels).  Tie and
    snap rules mirror the linear path's f32 band in log space."""
    x, logp, valid, a0, equal_margins = _support_logp(tables, maxs, nmax, dtype)
    logp = torch.where(valid, logp, float("-inf"))
    logp0 = _observed(logp, a0, maxs)
    a0e = a0[..., None]
    tie_rtol = 1e-12 if dtype == torch.float64 else 1e-5
    bad = (logp >= logp0 + _const(np.log1p(-tie_rtol), dtype)) & valid
    sel1 = (x <= a0e) & valid
    sel2 = (_suffix_blocked(bad) == 0) & valid & (x > a0e)
    sel = torch.where(equal_margins[..., None], sel1, sel1 | sel2)

    # the observed table is always selected, so the max is finite
    lm = torch.where(sel, logp, float("-inf"))
    M = lm.amax(-1, keepdim=True)
    ssum = torch.where(sel, torch.exp(lm - M), 0.0).sum(-1)
    log_total = M[..., 0] + torch.log(ssum)
    log_total = log_total + equal_margins.to(dtype) * _const(np.log(2.0), dtype)

    snap = 1e-12 if dtype == torch.float64 else 1e-5
    neglog10 = -log_total / _const(np.log(10.0), dtype)
    return torch.where(
        log_total > _const(np.log1p(-snap), dtype), 0.0, neglog10
    )


def _neglog10_p(tables, maxs, nmax, dtype):
    """Per-table score ``-log10 p``: linear f64 for exact mode (the C's
    doubles), log-space for f32 (:func:`fet_two_tailed_neglog10`)."""
    if dtype == torch.float64:
        return -torch.log10(fet_two_tailed(tables, maxs, nmax, dtype=dtype))
    return fet_two_tailed_neglog10(tables, maxs, nmax, dtype=dtype)


def _table_grid(asize: int, bsize: int) -> np.ndarray:
    """Every rectangular (f0, f1, f2, f3) combination with f0, f1 in
    [0, asize] and f2, f3 in [0, bsize], flattened row-major.  Includes
    unreachable combos (f0 + f1 > asize); they are never gathered."""
    A1, B1 = asize + 1, bsize + 1
    g = np.indices((A1, A1, B1, B1), dtype=np.int32)
    return g.reshape(4, -1).T


def lut_active(asize: int, bsize: int) -> bool:
    """Whether the per-SNP scores go through the possible-table LUT.

    Depends on the panel only, never on the chromosome length (the JAX
    package's round-5 rule: every host of a run takes the same branch).
    The bound caps the one-off LUT build at ~1e8 support-scan ops; the
    G < 2^24 term mirrors the JAX package's rank-path guard so that both
    packages switch at the same panels."""
    grid = (asize + 1) ** 2 * (bsize + 1) ** 2
    return (
        grid * support_size(asize, bsize) <= _LUT_MAX_BUILD_OPS
        and grid < (1 << 24)
    )


def _lut_index(tables: torch.Tensor, asize: int, bsize: int) -> torch.Tensor:
    A1, B1 = asize + 1, bsize + 1
    t = tables.to(torch.int64)
    return ((t[..., 0] * A1 + t[..., 1]) * B1 + t[..., 2]) * B1 + t[..., 3]


# --------------------------------------------------------------------------
# K1: per-SNP scores
# --------------------------------------------------------------------------

def fet_lut_plain(asize, bsize, maxs, nmax, dtype, device) -> torch.Tensor:
    """Plain torch version of :func:`fet_lut`."""
    grid = torch.from_numpy(_table_grid(asize, bsize)).to(device)
    return _neglog10_p(grid, maxs, nmax, dtype)


def fet_lut(asize, bsize, maxs, nmax, dtype, device) -> torch.Tensor:
    """Score ``-log10 p`` of every table of the (asize+1)^2 (bsize+1)^2
    grid (``divergence_tpu/kernels/fet.py:fet_snp_logs``' LUT), row-major
    in (f0, f1, f2, f3).  Uncached: each call launches the build
    (:func:`lut_cached` builds once a key)."""
    device = torch.device(device)
    if is_cpu(device):
        return fet_lut_plain(asize, bsize, maxs, nmax, dtype, device)
    lf = _lf_table(nmax, dtype, device)
    out = torch.empty(
        (asize + 1) ** 2 * (bsize + 1) ** 2, dtype=dtype, device=device
    )
    launch(
        LAUNCHES, "fet_lut_build", f"fet_lut_build_{dtype_suffix(dtype)}", device,
        ptr(lf), nmax, asize, bsize, maxs, ptr(out),
    )
    return out


# --------------------------------------------------------------------------
# K1's LUT and K1r's sort of it, once per key
# --------------------------------------------------------------------------

_LUT_CACHE_ENTRIES = 64    # keys kept, least recently used dropped first


@dataclasses.dataclass
class _LutEntry:
    """One key's LUT and, once the rank path asks, K1r's ``(lut_sorted,
    rank_of_entry)`` of it; each with the CUDA stream it was built on and
    an event recorded there after the build (None on the CPU)."""

    lut: torch.Tensor
    stream: object
    ready: object
    ranked: tuple | None = None
    ranked_stream: object = None
    ranked_ready: object = None


_lut_cache: collections.OrderedDict = collections.OrderedDict()
_lut_cache_lock = threading.Lock()


def clear_lut_cache() -> None:
    """Drop every cached LUT and sort: the next use of a key builds anew."""
    with _lut_cache_lock:
        _lut_cache.clear()


def _stamp(device: torch.device):
    """(the current stream, an event recorded on it now), or (None, None)
    on the CPU."""
    if is_cpu(device):
        return None, None
    stream = torch.cuda.current_stream(device)
    event = torch.cuda.Event()
    event.record(stream)
    return stream, event


def _ready(tensors, device: torch.device, stream, event) -> None:
    """Let the caller's current stream read ``tensors``, built on
    ``stream``: another stream waits for the build's event first, and the
    allocator learns of its use (an entry dropped from the cache keeps its
    memory until that stream's work is done)."""
    if stream is None:
        return
    current = torch.cuda.current_stream(device)
    if current != stream:
        current.wait_event(event)
        for t in tensors:
            t.record_stream(current)


def _lut_entry(asize, bsize, maxs, nmax, dtype, device) -> _LutEntry:
    key = (asize, bsize, maxs, nmax, dtype, device)
    with _lut_cache_lock:
        entry = _lut_cache.get(key)
        if entry is None:
            lut = fet_lut(asize, bsize, maxs, nmax, dtype, device)
            entry = _lut_cache[key] = _LutEntry(lut, *_stamp(device))
            while len(_lut_cache) > _LUT_CACHE_ENTRIES:
                _lut_cache.popitem(last=False)
        else:
            _lut_cache.move_to_end(key)
    return entry


def _key_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def lut_cached(asize, bsize, maxs, nmax, dtype, device) -> torch.Tensor:
    """:func:`fet_lut` of the key (asize, bsize, maxs, nmax, dtype,
    device), built on the caller's current stream at the key's first use
    and returned again after: the same storage, no second launch.
    Read-only."""
    device = _key_device(device)
    entry = _lut_entry(asize, bsize, maxs, nmax, dtype, device)
    _ready((entry.lut,), device, entry.stream, entry.ready)
    return entry.lut


def lut_rank_cached(asize, bsize, maxs, nmax, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fet_lut_rank` of :func:`lut_cached`'s LUT, sorted at the
    key's first use on the rank path and returned again after.
    Read-only."""
    device = _key_device(device)
    entry = _lut_entry(asize, bsize, maxs, nmax, dtype, device)
    with _lut_cache_lock:
        if entry.ranked is None:
            _ready((entry.lut,), device, entry.stream, entry.ready)
            entry.ranked = fet_lut_rank(entry.lut)
            entry.ranked_stream, entry.ranked_ready = _stamp(device)
    _ready(entry.ranked, device, entry.ranked_stream, entry.ranked_ready)
    return entry.ranked


def fet_snp_logs_plain(
    vals: torch.Tensor, asize: int, maxs: int, nmax: int, fast: bool = False,
    lut: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch version of :func:`fet_snp_logs`: each SNP's entry of
    ``lut`` (a LUT of its own, :func:`fet_lut_plain`, where None) where
    :func:`lut_active`, else its own support scan."""
    dtype = compute_dtype("fast" if fast else "exact")
    bsize = vals.shape[1] - asize
    tables = count_tables(vals[:, :asize], vals[:, asize:])
    if not lut_active(asize, bsize):
        return _neglog10_p(tables, maxs, nmax, dtype)
    if lut is None:
        lut = fet_lut_plain(asize, bsize, maxs, nmax, dtype, vals.device)
    return lut[_lut_index(tables, asize, bsize)]


def fet_snp_logs(
    vals: torch.Tensor, asize: int, maxs: int, nmax: int, fast: bool = False
) -> torch.Tensor:
    """-log10 two-tailed FET p for every SNP of a chromosome, once
    (``divergence_tpu/kernels/fet.py:fet_snp_logs_joint``).

    ``vals``: [N, asize+bsize] joint genotype codes, group A first
    (:meth:`SnpPair.to_device`).  When :func:`lut_active`, the test is
    evaluated once per possible table (:func:`lut_cached`) and each SNP
    reads its table's score; otherwise each SNP scans its own support.
    Returns [N] float64 (exact) or float32 (``fast``)."""
    dtype = compute_dtype("fast" if fast else "exact")
    bsize = vals.shape[1] - asize
    if not is_cpu(vals):
        if vals.dtype != torch.int16:
            raise TypeError(
                f"fet_snp_logs kernel takes int16 genotype codes, got {vals.dtype}"
            )
        if vals.dim() != 2 or not vals.is_contiguous():
            raise ValueError("fet_snp_logs kernel takes a contiguous [N, a+b] tensor")
    lut = (lut_cached(asize, bsize, maxs, nmax, dtype, vals.device)
           if lut_active(asize, bsize) else None)
    if is_cpu(vals):
        return fet_snp_logs_plain(vals, asize, maxs, nmax, fast, lut)
    lf = _lf_table(nmax, dtype, vals.device)
    out = torch.empty(vals.shape[0], dtype=dtype, device=vals.device)
    launch(
        LAUNCHES, "fet_snp_logs", f"fet_snp_logs_{dtype_suffix(dtype)}", vals.device,
        ptr(vals), vals.shape[0], asize, bsize, ptr(lut), ptr(lf), nmax,
        maxs, ptr(out),
    )
    return out


# --------------------------------------------------------------------------
# K2: window percentile + bootstrap stddev
# --------------------------------------------------------------------------

def _interp_ranks(npos: torch.Tensor, perc: float, dtype=torch.float64):
    """(idx, hi_idx, delta) of the reference's interpolated percentile
    (reference statistics/fisher/cFisher.c:136-144): with ascending order
    statistics s[.], result = (1-d)*s[idx] + d*s[hi_idx],
    idx = int((n-1)*perc), hi_idx = min(idx+1, n-1)."""
    nf = npos.to(dtype)
    xpos = (nf - 1.0) * _const(perc, dtype)
    idx = torch.floor(xpos).to(torch.int64)
    delta = xpos - idx.to(dtype)
    hi_idx = torch.minimum(idx + 1, (npos - 1).clamp(min=0))
    return idx, hi_idx, delta


def _sorted_pick(sorted_asc: torch.Tensor, npos: torch.Tensor, rank: torch.Tensor):
    """Value of ascending order statistic ``rank`` (0-based, per window)
    from a padded ascending sort where the n valid values occupy the LAST
    n positions (padding = -inf sorts first).  ``rank`` is [B, S]."""
    P = sorted_asc.shape[-1]
    pos = (P - npos[:, None] + rank).clamp(0, P - 1)
    return torch.gather(sorted_asc, -1, pos)


def _steps_max(P: int, perc: float, dtype) -> int:
    """Upper bound on the Renyi steps t1 = (n-1) - idx(n) over every
    window size n <= P, in the SAME dtype arithmetic as
    :func:`_interp_ranks` (a float32-rounded (n-1)*perc can floor one
    below the Python-float value)."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    n1 = np.arange(P, dtype=np_dtype)              # n - 1 for n = 1..P
    idx = np.floor(n1 * np_dtype(perc))
    return int(np.max(n1 - idx))


def _order_stat_uniforms(wkeys, nf, t1, t2, nsamples, steps_max, dtype):
    """(U_(k1), U_(k2)) joint order statistics of n iid uniforms via the
    Renyi top-down recursion U_(n) = V^(1/n), U_(k) = U_(k+1) * V^(1/k).

    Step j draws ``uniform(fold_in(wkey, j), (nsamples,))`` and produces
    U_(n-j); the per-window targets t1 >= t2 are captured with masks, so
    one fixed-length loop serves windows of every n.  Keys are per window
    (slot-derived), so every stream is a pure function of the window's
    genomic identity."""
    B = nf.shape[0]
    u = torch.ones((B, nsamples), dtype=dtype, device=nf.device)
    u1 = u
    u2 = u
    for j in range(steps_max + 1):
        jf = float(j)
        v_j = rng.uniform(rng.fold_in(wkeys, j), nsamples, dtype)   # [B, S]
        # a tensor exponent: the elementwise pow the kernel also calls
        factor = v_j ** (torch.ones_like(nf) / torch.clamp(nf - jf, min=1.0))
        u = torch.where(jf <= t1, u * factor, u)
        u2 = torch.where(jf == t2, u, u2)
        u1 = torch.where(jf == t1, u, u1)
    return u1, u2


def _lane_sum(v: torch.Tensor) -> torch.Tensor:
    """The kernels' warp sum of v [..., P] (K2's stddev,
    ``csrc/fet_window_stats.cuh:lane_order_stddev``, and K6's stress,
    ``csrc/css_smacof.cu``): element p on lane p % 32, each lane's partial
    added in p order from 0, then the xor butterfly over the lanes.  The
    zero padding of the last row adds +0.0 to partials that are never
    -0.0, so it changes no bit."""
    P = v.shape[-1]
    K = -(-P // 32)
    lanes = torch.nn.functional.pad(v, (0, 32 * K - P)).reshape(*v.shape[:-1], K, 32)
    acc = torch.zeros_like(lanes[..., 0, :])
    for k in range(K):
        acc = acc + lanes[..., k, :]
    idx = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., idx ^ o]
    return acc[..., 0]


def _lane_stddev(reps: torch.Tensor) -> torch.Tensor:
    """Population stddev of each row of ``reps`` [B, S] as the kernels
    take it: the mean is the lane-order total over S, then the squared
    deviations d * d are summed alike."""
    count = torch.tensor(reps.shape[-1], dtype=reps.dtype, device=reps.device)
    d = reps - (_lane_sum(reps) / count)[:, None]
    return torch.sqrt(_lane_sum(d * d) / count)


def _aggregate_sorted(keys_sorted, npos, perc, wkeys, nsamples, dtype, value_of):
    """Window score (interpolated percentile) and bootstrap stddev from
    each window's ascending sort keys ``keys_sorted`` [B, P], the n valid
    keys last; ``value_of`` maps picked keys to scores (non-decreasing, so
    the keys' order statistics are the scores').  Keys [B, 2]."""
    P = keys_sorted.shape[-1]
    idx, hi_idx, delta = _interp_ranks(npos, perc, dtype=dtype)
    v_lo = value_of(_sorted_pick(keys_sorted, npos, idx[:, None])[:, 0])
    v_hi = value_of(_sorted_pick(keys_sorted, npos, hi_idx[:, None])[:, 0])
    scores = (1.0 - delta) * v_lo + delta * v_hi

    # Bootstrap stddev via order statistics: the percentile of a resample
    # of n draws interpolates its ascending order statistics at ranks
    # k1 = idx+1 and k2 = hi_idx+1; X_(k) = sorted[ceil(n*U_(k)) - 1].
    nf = npos.to(dtype)[:, None]                            # [B, 1]
    idx_f = idx.to(dtype)[:, None]
    hi_f = hi_idx.to(dtype)[:, None]
    t1 = torch.clamp(nf - 1.0 - idx_f, min=0.0)
    t2 = nf - 1.0 - hi_f
    steps_max = _steps_max(P, perc, dtype)
    u1, u2 = _order_stat_uniforms(wkeys, nf, t1, t2, nsamples, steps_max, dtype)

    def rank_of(u):
        r = torch.ceil(nf * u) - 1.0
        r = torch.minimum(torch.clamp(r, min=0.0), torch.clamp(nf - 1.0, min=0.0))
        return r.to(torch.int64)

    x1 = value_of(_sorted_pick(keys_sorted, npos, rank_of(u1)))       # [B, S]
    same = (hi_idx == idx)[:, None]
    x2 = torch.where(same, x1, value_of(_sorted_pick(keys_sorted, npos, rank_of(u2))))
    reps = (1.0 - delta[:, None]) * x1 + delta[:, None] * x2
    stddev = _lane_stddev(reps)

    valid_w = npos > 0
    return (
        torch.where(valid_w, scores, 0.0),
        torch.where(valid_w, stddev, 0.0),
    )


def _aggregate(logs, npos, perc, wkeys, nsamples, dtype):
    """Window score and bootstrap stddev for per-SNP scores ``logs``
    [B, P] (``divergence_tpu/kernels/fet.py:_aggregate``): -inf pads sort
    first."""
    P = logs.shape[-1]
    snp_mask = torch.arange(P, device=logs.device)[None, :] < npos[:, None]
    logs_sorted = torch.sort(
        torch.where(snp_mask, logs, float("-inf")), dim=-1
    ).values
    return _aggregate_sorted(logs_sorted, npos, perc, wkeys, nsamples, dtype,
                             lambda v: v)


def _aggregate_ranks(ranks, npos, perc, wkeys, nsamples, lut_sorted):
    """:func:`_aggregate` in LUT-rank space
    (``divergence_tpu/kernels/fet.py:_aggregate_ranks``): the window sort
    runs on int32 ranks ``ranks`` [B, P] with -1 pads (they sort first),
    and each pick maps through ``lut_sorted`` just before interpolation."""
    P = ranks.shape[-1]
    G = lut_sorted.shape[0]
    snp_mask = torch.arange(P, device=ranks.device)[None, :] < npos[:, None]
    r_sorted = torch.sort(torch.where(snp_mask, ranks, -1), dim=-1).values
    return _aggregate_sorted(r_sorted, npos, perc, wkeys, nsamples, lut_sorted.dtype,
                             lambda r: lut_sorted[r.clamp(0, G - 1)])


WIDE_CHUNK = 4096   # keys a shared-memory pass of the wide body sorts (csrc kWideChunk)


def bitonic_schedule(P: int, chunk: int | None) -> list[tuple[int, int, int]]:
    """The kernels' bitonic network over P keys as its stages (k, j, S):
    ``chunk`` None gives the warp and block bodies' one pass (S = 0: each
    stage over all P keys); else the wide body's grouping
    (``csrc/fet_window_stats.cuh:wide_sort``): stages of stride j >= S over
    the slab (S = 0), and each run of stages of stride j < S chunk by
    chunk (S = min(chunk, P))."""
    pairs = []
    k = 2
    while k <= P:
        j = k // 2
        while j > 0:
            pairs.append((k, j))
            j //= 2
        k *= 2
    if chunk is None:
        return [(k, j, 0) for k, j in pairs]
    S = min(chunk, P)
    return [(k, j, S if j < S else 0) for k, j in pairs]


def bitonic_network(keys: torch.Tensor, schedule) -> torch.Tensor:
    """Run ``schedule``'s stages on keys [B, P] as the kernels do: the
    comparator (i, i ^ j) ascending iff (i & k) == 0 of the key's index in
    the slab, swapping only when strictly out of order; a stage with S > 0
    runs on each aligned chunk of S keys in chunk-local indices, its
    direction from the global index (a mirror of the kernels' sort; the
    plain versions sort with torch.sort)."""
    x = keys.clone()
    B, P = x.shape
    for k, j, S in schedule:
        n = S or P
        v = x.reshape(B, P // n, n)
        i = torch.arange(n, device=x.device)
        partner = i ^ j
        glob = torch.arange(P // n, device=x.device)[:, None] * n + i[None, :]
        up = (glob & k) == 0
        xp = v[..., partner]
        lower = (partner > i)[None, None, :]
        lo = torch.where(lower, v, xp)
        hi = torch.where(lower, xp, v)
        swap = torch.where(up, lo > hi, lo < hi)
        x = torch.where(swap, xp, v).reshape(B, P)
    return x


WIDE_BAND_KEYS = 4096    # band keys the wide body sorts in shared memory (csrc kBandKeys)
WIDE_EARLY_KEYS = 512    # the wide body's select stops once its band fits (csrc kEarlyKeys)
WIDE_TERM_TILE = 4096    # bootstrap terms a tile of the wide body holds (csrc kTermTile)


def _band_keys(band_keys: int | None) -> int:
    return WIDE_BAND_KEYS if band_keys is None else int(band_keys)


def band_tile_steps(nsamples: int) -> int:
    """Steps of the bootstrap a tile of the wide body takes
    (``csrc/fet_window_stats.cuh:band_tile_steps``)."""
    return WIDE_TERM_TILE // nsamples if nsamples < WIDE_TERM_TILE else 1


def order_stat_uniforms_tiled(wkeys, nf, t1, t2, nsamples, steps_max, dtype, tile=None):
    """:func:`_order_stat_uniforms` in the wide body's order: the steps in
    tiles of ``tile`` (default :func:`band_tile_steps`), each tile's terms
    V_j^(1/max(n-j, 1)) drawn and raised for all its steps and samples at
    once, then folded into u one step after another, u2 captured at j ==
    t2.  The same product chain, so the same bits."""
    B = nf.shape[0]
    J = tile or band_tile_steps(nsamples)
    u = torch.ones((B, nsamples), dtype=dtype, device=nf.device)
    u2 = u
    for j0 in range(0, steps_max + 1, J):
        js = range(j0, min(j0 + J, steps_max + 1))
        v = torch.stack([rng.uniform(rng.fold_in(wkeys, j), nsamples, dtype) for j in js],
                        dim=1)                                             # [B, J, S]
        e = torch.stack([torch.ones_like(nf) / torch.clamp(nf - float(j), min=1.0)
                         for j in js], dim=1)                              # [B, J, 1]
        terms = v ** e
        for q, j in enumerate(js):
            u = torch.where(float(j) <= t1, u * terms[:, q], u)
            u2 = torch.where(float(j) == t2, u, u2)
    return u, u2


def _ordered_ints(keys: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Keys as int64 in the order of the wide body's unsigned map
    (``csrc/fet_window_stats.cuh:Radix``; the map with its top bit
    flipped, so signed order is the map's order) and the map's width."""
    if keys.dtype == torch.float64:
        b = keys.view(torch.int64)
        return torch.where(b < 0, b ^ 0x7FFFFFFFFFFFFFFF, b), 64
    if keys.dtype == torch.float32:
        b = keys.view(torch.int32)
        return torch.where(b < 0, b ^ 0x7FFFFFFF, b).to(torch.int64), 32
    return keys.to(torch.int64), 32                                        # int32 ranks


def _from_ordered(s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`_ordered_ints`."""
    if dtype == torch.float64:
        return torch.where(s < 0, s ^ 0x7FFFFFFFFFFFFFFF, s).view(torch.float64)
    if dtype == torch.float32:
        s32 = s.to(torch.int32)
        return torch.where(s32 < 0, s32 ^ 0x7FFFFFFF, s32).view(torch.float32)
    return s.to(torch.int32)


def _digits(s: torch.Tensor, shift: int, width: int) -> torch.Tensor:
    """The 8-bit digit at ``shift`` of the unsigned map of ordered keys."""
    d = (s >> shift) & 0xFF
    return d ^ 0x80 if shift == width - 8 else d                        # the flipped top bit


def band_picks(keys: torch.Tensor, ranks: torch.Tensor, early: int = WIDE_EARLY_KEYS
               ) -> torch.Tensor:
    """The wide body's picks: the values of the ascending order statistics
    ``ranks`` (0-based) of one window's keys [n] (float or int32), found
    without sorting them all.  A radix select runs for the lowest and the
    highest rank at once (8-bit digits of the ordered map from the top, a
    histogram a pass of the keys that share each target's prefix); after
    a pass whose bins from the low target's to the high target's hold at
    most ``early`` keys (the kernel's min(band_keys, kEarlyKeys)), those
    keys alone are sorted and a rank picks the band's key at its offset
    from the keys below.  Past the last digit (the ends tied over more
    than ``early`` keys) a rank below the count of
    keys <= the low key picks the low key, one at or past the count of
    keys < the high key the high key, and only the keys strictly between
    the two are sorted.  Equal to ``torch.sort(keys)`` picked at
    ``ranks``, bit for bit."""
    s, width = _ordered_ints(keys)
    r_lo, r_hi = int(ranks.min()), int(ranks.max())
    cand_lo = torch.ones_like(s, dtype=torch.bool)
    cand_hi = cand_lo.clone()
    k_lo, k_hi = r_lo, r_hi
    band = None
    for shift in range(width - 8, -1, -8):
        d = _digits(s, shift, width)
        ends = []
        for cand, k in ((cand_lo, k_lo), (cand_hi, k_hi)):
            hist = torch.bincount(d[cand], minlength=256)
            cum = torch.cumsum(hist, 0)
            b = int(torch.searchsorted(cum, torch.tensor(k, dtype=cum.dtype), right=True))
            ends.append((b, int(cum[b - 1]) if b > 0 else 0, int(hist[b])))
        (b_lo, below_lo, _), (b_hi, below_hi, count_hi) = ends
        below = r_lo - k_lo + below_lo                  # keys before the low bin
        upto = r_hi - k_hi + below_hi + count_hi        # keys up to the high bin's end
        first = s[cand_lo & (d == b_lo)].min()
        last = s[cand_hi & (d == b_hi)].max()
        k_lo, k_hi = k_lo - below_lo, k_hi - below_hi
        cand_lo &= d == b_lo
        cand_hi &= d == b_hi
        if upto - below <= early:
            band = torch.sort(s[(s >= first) & (s <= last)]).values
            le_lo, lt_hi = below, upto
            break
    if band is None:
        vlo, vhi = s[cand_lo][0], s[cand_hi][0]
        le_lo = r_lo - k_lo + int(cand_lo.sum())       # keys <= vlo
        lt_hi = r_hi - k_hi                             # keys < vhi
        band = torch.sort(s[(s > vlo) & (s < vhi)]).values
    if band.numel() != max(lt_hi - le_lo, 0):
        raise AssertionError("band count differs from the select's counts")
    out = torch.empty_like(ranks)
    inside = (ranks >= le_lo) & (ranks < lt_hi)
    out[inside] = band[ranks[inside] - le_lo]
    if not bool(inside.all()):
        out[ranks < le_lo] = vlo
        out[ranks >= lt_hi] = vhi
    return _from_ordered(out, keys.dtype)


def aggregate_band(keys, npos, perc, wkeys, nsamples, dtype, value_of, tile=None,
                   early=WIDE_EARLY_KEYS):
    """The wide body's window score and bootstrap stddev (keys [B, P],
    each window's n valid keys first and in any order): the tiled
    bootstrap (:func:`order_stat_uniforms_tiled`) before any key is read,
    then the picks by :func:`band_picks`, the replicates and the
    lane-order stddev as :func:`_aggregate_sorted`.  Equal to
    :func:`_aggregate` / :func:`_aggregate_ranks` bit for bit."""
    P = keys.shape[-1]
    idx, hi_idx, delta = _interp_ranks(npos, perc, dtype=dtype)
    nf = npos.to(dtype)[:, None]
    t1 = torch.clamp(nf - 1.0 - idx.to(dtype)[:, None], min=0.0)
    t2 = nf - 1.0 - hi_idx.to(dtype)[:, None]
    u1, u2 = order_stat_uniforms_tiled(wkeys, nf, t1, t2, nsamples,
                                       _steps_max(P, perc, dtype), dtype, tile)

    def rank_of(u):
        r = torch.ceil(nf * u) - 1.0
        r = torch.minimum(torch.clamp(r, min=0.0), torch.clamp(nf - 1.0, min=0.0))
        return r.to(torch.int64)

    r1, r2 = rank_of(u1), rank_of(u2)
    B = keys.shape[0]
    scores = torch.zeros(B, dtype=dtype, device=keys.device)
    stddev = torch.zeros(B, dtype=dtype, device=keys.device)
    for b in range(B):
        n = int(npos[b])
        if n <= 0:
            continue
        want = torch.cat([torch.stack([idx[b], hi_idx[b]]), r1[b], r2[b]])
        x = value_of(band_picks(keys[b, :n], want, early))
        d = delta[b]
        scores[b] = (1.0 - d) * x[0] + d * x[1]
        x1 = x[2:2 + nsamples]
        x2 = x1 if bool(hi_idx[b] == idx[b]) else x[2 + nsamples:]
        stddev[b] = _lane_stddev(((1.0 - d) * x1 + d * x2)[None])[0]
    return scores, stddev


def _window_pad(max_npos: int) -> int:
    """Padded per-window SNP count: the next power of two >= the largest
    window, at least 32 (the JAX engine's ``P``)."""
    P = 32
    while P < max_npos:
        P *= 2
    return P


def _plain_over_windows(per_snp, lo, npos, slot, chrom_key, dtype, body):
    """Gather ``per_snp`` [N] into [b, P] windows in chunks of
    ``_AGG_WINDOW_CHUNK`` (to bound memory; every window's result depends
    on that window alone) and run ``body(windows, npos, wkeys)`` on each."""
    dev = per_snp.device
    lo, npos, slot = (t.to(dev, torch.int64) for t in (lo, npos, slot))
    key = chrom_key.to(dev, torch.int64)
    B = lo.shape[0]
    out = torch.zeros((2, B), dtype=dtype, device=dev)
    if B == 0:
        return out
    P = _window_pad(int(npos.max()))
    offs = torch.arange(P, device=dev)[None, :]
    for s in range(0, B, _AGG_WINDOW_CHUNK):
        sl = slice(s, min(s + _AGG_WINDOW_CHUNK, B))
        gidx = torch.where(offs < npos[sl, None], lo[sl, None] + offs, 0)
        sc, sd = body(per_snp[gidx], npos[sl], rng.slot_keys(key, slot[sl]))
        out[0, sl] = sc
        out[1, sl] = sd
    return out


def fet_aggregate_plain(
    snp_logs, lo, npos, slot, chrom_key, perc, nsamples
) -> torch.Tensor:
    """Plain torch version of :func:`fet_aggregate`."""
    dtype = snp_logs.dtype
    return _plain_over_windows(
        snp_logs, lo, npos, slot, chrom_key, dtype,
        lambda logs, n, wkeys: _aggregate(logs, n, perc, wkeys, nsamples, dtype),
    )


def window_form(pmax: int, nsamples: int, key_bytes: int, value_bytes: int,
                device: torch.device | None = None) -> str:
    """The body K2 / K2r / K10 take on ``device`` for a launch whose widest
    window pads to ``pmax`` (sort keys of ``key_bytes``, replicates of
    ``value_bytes``), by the kernel library's own reckoning
    (``csrc/fet_window_stats.cuh:window_form``): ``"warp"``, ``"block"``
    or ``"wide"`` (the band body, no sort).  The block body takes
    windows to P = 256, where it is the faster of the two
    (``tests/measure_large_forms.py``)."""
    return _window_form(pmax, nsamples, key_bytes, value_bytes, device)[0]


def _window_form(pmax, nsamples, key_bytes, value_bytes, device):
    return query_form(("warp", "block", "wide"), "fet_window_form", device, pmax, nsamples,
                      key_bytes, value_bytes)


def _wide_scratch(pmax, nsamples, key_dtype, value_bytes, dev):
    """(True, scratch) where the launch takes the wide body, else (False,
    None)."""
    key_bytes = torch.empty(0, dtype=key_dtype).element_size()
    form, nbytes = _window_form(pmax, nsamples, key_bytes, value_bytes, dev)
    if form != "wide":
        return False, None
    return True, torch.empty(nbytes // key_bytes, dtype=key_dtype, device=dev)


def _window_rows(lo, npos, slot, nsnps, dev):
    """The window descriptors packed [3, B] int64 on ``dev``, after the
    checks every window kernel needs; and the largest window's padded
    width P."""
    pmax = _window_pad(int(npos.max()))
    if int(lo.min()) < 0 or int((lo + npos).max()) > nsnps:
        raise ValueError(f"window descriptors reach outside the {nsnps} SNPs")
    rows = torch.stack([lo, npos, slot]).to(torch.int64)
    if rows.device.type == "cpu":
        # pinned + non_blocking: the upload queues behind K1 instead of
        # waiting for it
        rows = rows.pin_memory()
    return rows.to(dev, non_blocking=True), pmax


def fet_aggregate(
    snp_logs: torch.Tensor,   # [N] per-SNP -log10 p (fet_snp_logs)
    lo: torch.Tensor,         # [B] first SNP index per window
    npos: torch.Tensor,       # [B] SNP count per window (> 0)
    slot: torch.Tensor,       # [B] output slot (window genomic identity)
    chrom_key: torch.Tensor,  # [2] chromosome key; windows fold in their slot
    perc: float,
    nsamples: int,
    band_keys: int | None = None,
) -> torch.Tensor:
    """Window percentile + bootstrap stddev of every window of one
    chromosome (``divergence_tpu/kernels/fet.py:fet_aggregate_all``).
    Returns [2, B] (scores, stddev) in ``snp_logs.dtype``.

    Window descriptors may live on the host; on a CUDA ``snp_logs`` the
    wrapper reads the largest window from them (host tensors avoid a
    device sync) and uploads them packed.  ``band_keys``: the widest band
    of keys the wide body sorts in shared memory before it takes device
    scratch (default and most :data:`WIDE_BAND_KEYS`; 0 sends every band
    to device scratch)."""
    if is_cpu(snp_logs):
        return fet_aggregate_plain(
            snp_logs, lo, npos, slot, chrom_key, perc, nsamples
        )
    dev = snp_logs.device
    dtype = snp_logs.dtype
    if snp_logs.dim() != 1 or not snp_logs.is_contiguous():
        raise ValueError("fet_aggregate kernel takes contiguous [N] scores")
    B = lo.shape[0]
    out = torch.empty((2, B), dtype=dtype, device=dev)
    if B == 0:
        return out
    rows, pmax = _window_rows(lo, npos, slot, snp_logs.shape[0], dev)
    k0, k1 = (int(w) for w in chrom_key.tolist())
    args = (ptr(snp_logs), ptr(rows), B, ctypes.c_uint32(k0), ctypes.c_uint32(k1),
            ctypes.c_double(perc), nsamples, pmax)
    wide, scratch = _wide_scratch(pmax, nsamples, dtype, snp_logs.element_size(), dev)
    if wide:
        launch(LAUNCHES, "fet_aggregate_wide", f"fet_aggregate_wide_{dtype_suffix(dtype)}",
               dev, *args, _band_keys(band_keys), ptr(scratch), ptr(out))
    else:
        launch(LAUNCHES, "fet_aggregate", f"fet_aggregate_{dtype_suffix(dtype)}", dev, *args,
               ptr(out))
    return out


# --------------------------------------------------------------------------
# K1r / K2r: the LUT-rank path (exact mode in the LUT regime)
# --------------------------------------------------------------------------

def _require_lut(asize: int, bsize: int) -> None:
    if not lut_active(asize, bsize):
        raise ValueError(
            f"the rank path needs the table LUT, which is off at {asize} + {bsize}"
        )


def fet_lut_rank_plain(lut: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`fet_lut_rank`.  ``lut + 0.0`` turns
    -0.0 into +0.0, so the stable sort ties the two zeros as IEEE ``<``
    does (torch's CUDA sort orders float bits)."""
    G = lut.shape[0]
    order = torch.sort(lut + 0.0, stable=True).indices
    rank_of_entry = torch.empty(G, dtype=torch.int32, device=lut.device)
    rank_of_entry[order] = torch.arange(G, dtype=torch.int32, device=lut.device)
    return lut[order], rank_of_entry


def lut_radix_keys(lut: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The keys K1r's radix sort orders the LUT by, as :func:`_ordered_ints`
    gives them (``csrc/fet_common.cuh:Radix``), and their width: each value
    canonicalised by ``+ 0.0`` first, so -0.0 and +0.0 share a key.  This
    and :func:`lut_radix_rank` mirror the kernel for the tests."""
    return _ordered_ints(lut + 0.0)


def lut_radix_rank(lut: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lut_sorted, rank_of_entry)`` by K1r's passes mirrored in torch:
    the (key, index) pairs of :func:`lut_radix_keys`, then one stable pass
    an 8-bit digit, least significant first (each entry to its digit's
    start plus the entries of that digit before it, the order a stable
    sort by the digit gives).  Equal to :func:`fet_lut_rank_plain` bit for
    bit on a LUT without NaN."""
    keys, width = lut_radix_keys(lut)
    G = lut.shape[0]
    order = torch.arange(G, device=lut.device)
    for shift in range(0, width, 8):
        order = order[torch.sort(_digits(keys[order], shift, width), stable=True).indices]
    rank_of_entry = torch.empty(G, dtype=torch.int32, device=lut.device)
    rank_of_entry[order] = torch.arange(G, dtype=torch.int32, device=lut.device)
    return lut[order], rank_of_entry


def lut_rank_scratch(G: int, key_bytes: int, device: torch.device | None = None) -> int:
    """The bytes of device scratch K1r's sort takes for a LUT of ``G``
    keys of ``key_bytes`` on ``device``, by the kernel library's reckoning
    (``csrc/fet_rank.cu:fet_lut_rank_scratch``: the histograms, the
    look-back words of a tile size that follows the device's SMs, and two
    (value, index) buffers)."""
    return query_form(("onesweep",), "fet_lut_rank_scratch", device, G, key_bytes)[1]


def fet_lut_rank(lut: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lut_sorted, rank_of_entry)``: the LUT in ascending order and each
    entry's place in it, int32 (``divergence_tpu/kernels/fet.py:
    fet_snp_ranks_joint``'s stable ``jnp.argsort``: IEEE ``<`` on the
    values, ties by index, -0.0 == +0.0).  On the card a stable LSD radix
    sort of (canonical key, index) pairs, a onesweep pass an 8-bit digit;
    one launch count a call."""
    if is_cpu(lut):
        return fet_lut_rank_plain(lut)
    if lut.dim() != 1 or not lut.is_contiguous():
        raise ValueError("fet_lut_rank kernel takes a contiguous [G] LUT")
    G = lut.shape[0]
    if G >= 1 << 24:
        raise ValueError(f"fet_lut_rank takes fewer than 2^24 entries, got {G}")
    dev = lut.device
    lut_sorted = torch.empty_like(lut)
    rank_of_entry = torch.empty(G, dtype=torch.int32, device=dev)
    scratch = torch.empty(lut_rank_scratch(G, lut.element_size(), dev), dtype=torch.uint8,
                          device=dev)
    launch(
        LAUNCHES, "fet_lut_rank", f"fet_lut_rank_{dtype_suffix(lut.dtype)}", dev,
        ptr(lut), G, ptr(scratch), ptr(lut_sorted), ptr(rank_of_entry),
    )
    return lut_sorted, rank_of_entry


def fet_snp_ranks_plain(
    vals: torch.Tensor, asize: int, maxs: int, nmax: int, fast: bool = False,
    ranked: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`fet_snp_ranks`, on ``ranked``'s
    ``(lut_sorted, rank_of_entry)`` (a LUT and sort of its own where
    None)."""
    bsize = vals.shape[1] - asize
    _require_lut(asize, bsize)
    dtype = compute_dtype("fast" if fast else "exact")
    if ranked is None:
        ranked = fet_lut_rank_plain(fet_lut_plain(asize, bsize, maxs, nmax, dtype, vals.device))
    lut_sorted, rank_of_entry = ranked
    tables = count_tables(vals[:, :asize], vals[:, asize:])
    return lut_sorted, rank_of_entry[_lut_index(tables, asize, bsize)]


def fet_snp_ranks(
    vals: torch.Tensor, asize: int, maxs: int, nmax: int, fast: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lut_sorted [G], ranks [N] int32)``: the ascending table LUT and
    every SNP's rank into it, so ``lut_sorted[ranks]`` are the SNPs'
    scores (``divergence_tpu/kernels/fet.py:fet_snp_ranks_joint``).  Only
    where :func:`lut_active`.  ``vals`` as :func:`fet_snp_logs`; the LUT
    and its sort from :func:`lut_rank_cached` (``lut_sorted`` read-only)."""
    bsize = vals.shape[1] - asize
    _require_lut(asize, bsize)
    dtype = compute_dtype("fast" if fast else "exact")
    if not is_cpu(vals):
        if vals.dtype != torch.int16:
            raise TypeError(
                f"fet_snp_ranks kernel takes int16 genotype codes, got {vals.dtype}"
            )
        if vals.dim() != 2 or not vals.is_contiguous():
            raise ValueError("fet_snp_ranks kernel takes a contiguous [N, a+b] tensor")
    ranked = lut_rank_cached(asize, bsize, maxs, nmax, dtype, vals.device)
    if is_cpu(vals):
        return fet_snp_ranks_plain(vals, asize, maxs, nmax, fast, ranked)
    lut_sorted, rank_of_entry = ranked
    out = torch.empty(vals.shape[0], dtype=torch.int32, device=vals.device)
    launch(
        LAUNCHES, "fet_snp_ranks", "fet_snp_ranks", vals.device,
        ptr(vals), vals.shape[0], asize, bsize, ptr(rank_of_entry), ptr(out),
    )
    return lut_sorted, out


def fet_aggregate_ranks_plain(
    lut_sorted, ranks, lo, npos, slot, chrom_key, perc, nsamples
) -> torch.Tensor:
    """Plain torch version of :func:`fet_aggregate_ranks`."""
    return _plain_over_windows(
        ranks, lo, npos, slot, chrom_key, lut_sorted.dtype,
        lambda r, n, wkeys: _aggregate_ranks(r, n, perc, wkeys, nsamples, lut_sorted),
    )


def fet_aggregate_ranks(
    lut_sorted: torch.Tensor,  # [G] ascending LUT (fet_snp_ranks)
    ranks: torch.Tensor,       # [N] int32 per-SNP ranks into lut_sorted
    lo: torch.Tensor,          # [B] first SNP index per window
    npos: torch.Tensor,        # [B] SNP count per window (> 0)
    slot: torch.Tensor,        # [B] output slot (window genomic identity)
    chrom_key: torch.Tensor,   # [2] chromosome key; windows fold in their slot
    perc: float,
    nsamples: int,
    band_keys: int | None = None,
) -> torch.Tensor:
    """:func:`fet_aggregate` in LUT-rank space
    (``divergence_tpu/kernels/fet.py:fet_aggregate_all_ranks``): every
    window's percentile and bootstrap stddev from its SNPs' ranks, equal
    bit for bit to :func:`fet_aggregate` on ``lut_sorted[ranks]``.
    Returns [2, B] in ``lut_sorted.dtype``; descriptors and ``band_keys``
    as there."""
    if is_cpu(ranks):
        return fet_aggregate_ranks_plain(
            lut_sorted, ranks, lo, npos, slot, chrom_key, perc, nsamples
        )
    dev = ranks.device
    dtype = lut_sorted.dtype
    if ranks.dtype != torch.int32 or ranks.dim() != 1 or not ranks.is_contiguous():
        raise ValueError("fet_aggregate_ranks kernel takes contiguous [N] int32 ranks")
    if lut_sorted.dim() != 1 or not lut_sorted.is_contiguous() or lut_sorted.device != dev:
        raise ValueError(
            "fet_aggregate_ranks kernel takes a contiguous [G] LUT on the ranks' device"
        )
    B = lo.shape[0]
    out = torch.empty((2, B), dtype=dtype, device=dev)
    if B == 0:
        return out
    rows, pmax = _window_rows(lo, npos, slot, ranks.shape[0], dev)
    k0, k1 = (int(w) for w in chrom_key.tolist())
    args = (ptr(lut_sorted), lut_sorted.shape[0], ptr(ranks), ptr(rows), B,
            ctypes.c_uint32(k0), ctypes.c_uint32(k1), ctypes.c_double(perc), nsamples, pmax)
    wide, scratch = _wide_scratch(pmax, nsamples, torch.int32, lut_sorted.element_size(),
                                  dev)
    sfx = dtype_suffix(dtype)
    if wide:
        launch(LAUNCHES, "fet_aggregate_ranks_wide", f"fet_aggregate_ranks_wide_{sfx}", dev,
               *args, _band_keys(band_keys), ptr(scratch), ptr(out))
    else:
        launch(LAUNCHES, "fet_aggregate_ranks", f"fet_aggregate_ranks_{sfx}", dev, *args,
               ptr(out))
    return out


# --------------------------------------------------------------------------
# K10: FET on pre-gathered windows
# --------------------------------------------------------------------------

def codes_int16(x: torch.Tensor) -> torch.Tensor:
    """Genotype codes of any dtype as int16 in {3, -3, 0}:
    ``3*(x == 3) - 3*(x == -3)``.  :func:`count_tables` only ``==``-compares
    the codes, so the map is result-identical (drosophila frequencies
    too).  An int16 tensor is returned as it is: its comparisons are the
    same."""
    if x.dtype == torch.int16:
        return x
    return (3 * (x == 3).to(torch.int16) - 3 * (x == -3).to(torch.int16))


def fet_window_batch_plain(
    avals, bvals, npos, perc, key, nsamples, maxs, nmax, fast=False, slot=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`fet_window_batch`
    (``divergence_tpu/kernels/fet.py:fet_window_batch``):
    :func:`count_tables`, :func:`_neglog10_p`, then :func:`_aggregate`
    keyed by ``slot_keys(key, slot)``."""
    dtype = compute_dtype("fast" if fast else "exact")
    dev = avals.device
    npos = torch.as_tensor(npos).to(dev, torch.int64)
    slot = (torch.arange(npos.shape[0], device=dev) if slot is None
            else torch.as_tensor(slot).to(dev, torch.int64))
    logs = _neglog10_p(count_tables(avals, bvals), maxs, nmax, dtype)      # [B, P]
    wkeys = rng.slot_keys(key.to(dev, torch.int64), slot)
    return _aggregate(logs, npos, perc, wkeys, nsamples, dtype)


def fet_window_batch(
    avals: torch.Tensor,      # [B, P, asize] genotype codes (any dtype)
    bvals: torch.Tensor,      # [B, P, bsize]
    npos: torch.Tensor,       # [B] true SNP count per window
    perc: float,
    key: torch.Tensor,        # [2] key; window b folds in slot[b]
    nsamples: int,
    maxs: int,
    nmax: int,
    fast: bool = False,
    slot: torch.Tensor | None = None,   # [B] window slots; default arange(B)
    band_keys: int | None = None,       # as fet_aggregate's
    npos_d: torch.Tensor | None = None,  # int64 copies of npos and slot on
    slot_d: torch.Tensor | None = None,  # the card, for the kernel to read
) -> tuple[torch.Tensor, torch.Tensor]:
    """FET scores and bootstrap stddev of a batch of pre-gathered windows
    (``divergence_tpu/kernels/fet.py:fet_window_batch``), the sharded
    step's form: (scores [B], stddev [B]) in float64, or float32 when
    ``fast``.  Rows at or past ``npos`` never influence a window.  The
    ``arange`` default of ``slot`` is only stream-correct when the batch is
    the complete, ordered window set; callers pass genomic slots.

    On a CUDA tensor the codes go to K10 as int16 (:func:`codes_int16`),
    with K1's LUT where :func:`lut_active` (:func:`lut_cached`); ``npos``
    and ``slot`` may lie on the host or the card.  The host decisions
    (the widest window, the key's words) read ``npos`` and ``key``; the
    kernel reads ``npos_d`` and ``slot_d`` where they are given (the
    sharded step's one upload a share: then nothing here waits for the
    card once the key's LUT is built), else copies of ``npos`` and
    ``slot``.  A CPU tensor runs the plain version on ``npos`` and
    ``slot``."""
    if is_cpu(avals):
        return fet_window_batch_plain(
            avals, bvals, npos, perc, key, nsamples, maxs, nmax, fast, slot
        )
    dev = avals.device
    dtype = compute_dtype("fast" if fast else "exact")
    if avals.dim() != 3 or bvals.dim() != 3 or avals.shape[:2] != bvals.shape[:2]:
        raise ValueError("fet_window_batch takes [B, P, a] and [B, P, b] codes")
    B, P, asize = avals.shape
    bsize = bvals.shape[2]
    npos = torch.as_tensor(npos)
    slot = torch.arange(B) if slot is None else torch.as_tensor(slot)
    if npos.shape != (B,) or slot.shape != (B,):
        raise ValueError("fet_window_batch takes [B] npos and slot")
    out = torch.empty((2, B), dtype=dtype, device=dev)
    if B == 0:
        return out[0], out[1]
    nmax_win = int(npos.max())
    if nmax_win > P:
        raise ValueError(f"a window claims {nmax_win} SNPs; the batch holds {P} rows")
    pmax = _window_pad(nmax_win)
    a16 = codes_int16(avals).contiguous()
    b16 = codes_int16(bvals).contiguous()
    npos_d, slot_d = (t.to(dev, torch.int64).contiguous()
                      for t in (npos if npos_d is None else npos_d,
                                slot if slot_d is None else slot_d))
    lut = (lut_cached(asize, bsize, maxs, nmax, dtype, dev)
           if lut_active(asize, bsize) else None)
    lf = _lf_table(nmax, dtype, dev)
    k0, k1 = (int(w) for w in key.tolist())
    args = (ptr(a16), ptr(b16), ptr(npos_d), ptr(slot_d), B, P, asize, bsize, ptr(lut),
            ptr(lf), nmax, maxs, ctypes.c_uint32(k0), ctypes.c_uint32(k1),
            ctypes.c_double(perc), nsamples, pmax)
    wide, scratch = _wide_scratch(pmax, nsamples, dtype, out.element_size(), dev)
    if wide:
        launch(LAUNCHES, "fet_window_wide", f"fet_window_wide_{dtype_suffix(dtype)}", dev,
               *args, _band_keys(band_keys), ptr(scratch), ptr(out))
    else:
        launch(LAUNCHES, "fet_window", f"fet_window_{dtype_suffix(dtype)}", dev, *args,
               ptr(out))
    return out[0], out[1]
