"""Adaptive permutation Monte-Carlo for CSS significance, shared stream
(K7).

Port of ``divergence_tpu/kernels/perm.py`` for the default
``mc_stream="shared"``, ``rng="mix"`` path.  Each chunk ``k`` of
``chunk`` permutations is keyed by ``fold_in(key, k)`` alone and shared
by every window, so the CSS of every (window, permutation) pair is one
product ``D_flat [B, m^2] @ M_k [m^2, chunk]`` with the rank-coefficient
matrix ``M_k`` (:func:`_shared_coeff`).  The estimator is the
reference's (reference statistics/css/css.c:727-752): a window stops at
its ``threshold``-th hit (a permuted score ``>=`` the observed one, both
float32) or at ``runs``; ``n`` is the 1-based index of that hit or
``runs``, and ``p = (hits+1)/(n+1)``.

Two kernels (``csrc/css_mc.cu``) carry it on a CUDA device:

* ``css_mc_coeff``  — the columns of ``M`` for a range of chunks, bit-equal
  to :func:`_shared_coeff`;
* ``css_mc_shared`` — the chunk loop for tiles of windows: product, hit
  test, the position of the threshold-th hit, the adaptive stop.

:func:`significance` runs them on a CUDA ``dist`` and the plain chunk loop
(:func:`mc_significance`) on a CPU one.  Each stop is per window, so
there is no window batching, padding or two-stage compaction (the JAX
package's ``lax.map`` slices existed for XLA on the TPU); the results are
those of the JAX package's single-pass loop.  Each launch adds one to
:data:`LAUNCHES`.  Not ported here: the per-window stream (``stream=
"window"``, K8) and approx mode (K9), both ROADMAP item P9.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import numpy as np
import torch

from divergence_tpu_torch import rng
from divergence_tpu_torch.kernels._cuda import is_cpu, launch, ptr

MC_MAX_M = 64                   # css_mc_coeff ranks m words per thread
_FIRST_RANGE_CHUNKS = 16        # the first launch: 4096 permutations at chunk 256
_RANGE_COEFF_BYTES = 64 << 20   # later launches: at most this much of M at once

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES = {"css_mc_coeff": 0, "css_mc_shared": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _chain_weights(asize: int, bsize: int) -> tuple[float, float]:
    wa = 1.0 / (asize * asize * (asize - 1)) if asize > 1 else 0.0
    wb = 1.0 / (bsize * bsize * (bsize - 1)) if bsize > 1 else 0.0
    return wa, wb


def _ranks(keys: torch.Tensor, chunk: int, m: int) -> torch.Tensor:
    """Permutation ranks [B, m, K]: the position of individual j in the
    stable ascending order of the ``mix`` draws of keys [B, 2], by
    pairwise compares with index tie-break (``perm.py:_ranks``,
    ``bitgen="mix"``)."""
    x = rng.mix_bits(keys, chunk * m).reshape(keys.shape[0], chunk, m)
    xt = x.transpose(-1, -2)                             # [B, m, K]
    xj = xt[:, :, None, :]
    xl = xt[:, None, :, :]
    idx = torch.arange(m, device=keys.device)
    tie = (idx[:, None] > idx[None, :])[None, :, :, None]
    cmp = (xj > xl) | ((xj == xl) & tie)
    return cmp.sum(dim=2)                                # [B, m, K]


def _coeff_constants(asize: int, bsize: int) -> tuple[float, float, float]:
    """The three float32 values a coefficient column is built from, as the
    JAX package rounds them: the between weight ``1/(a b)`` (a float32
    division) and the chain weights ``(a+b) w`` (a float64 product,
    rounded once to float32)."""
    wa, wb = _chain_weights(asize, bsize)
    m = asize + bsize
    between = np.float32(1.0) / np.float32(asize * bsize)
    return float(between), float(np.float32(m * wa)), float(np.float32(m * wb))


def _shared_coeff(key: torch.Tensor, k: int, m: int, asize: int, bsize: int,
                  chunk: int) -> torch.Tensor:
    """Rank-coefficient matrix M [m*m, chunk] float32 of shared chunk ``k``
    (``perm.py:_shared_coeff``): column K holds vec(C) with
    C[j, l] = u_j (1-u_l)/(a b) - (a+b) w(r_j) 1[r_l = r_j + 1],
    u_j = 1[r_j < a], for the ranks r of ``fold_in(key, k)``'s draws."""
    kc = rng.fold_in(key, k)
    r = _ranks(kc[None], chunk, m)[0]                    # [m, K]
    between, ca, cb = _coeff_constants(asize, bsize)
    cw = torch.where(
        r < asize - 1, ca, torch.where((r >= asize) & (r < m - 1), cb, 0.0)
    ).to(torch.float32)
    adj = r[None, :, :] == r[:, None, :] + 1             # [j, l, K]
    u = r < asize
    bet = torch.where(u[:, None, :] & ~u[None, :, :], between, 0.0).to(torch.float32)
    chain = torch.where(adj, cw[:, None, :], 0.0).to(torch.float32)
    return (bet - chain).reshape(m * m, chunk)


def shared_coeff_plain(key, k0, nk, m, asize, bsize, chunk, device) -> torch.Tensor:
    """Plain torch version of :func:`shared_coeff`."""
    key = key.to(device)
    return torch.cat(
        [_shared_coeff(key, k, m, asize, bsize, chunk) for k in range(k0, k0 + nk)],
        dim=1,
    )


def shared_coeff(
    key: torch.Tensor,     # [2] run-level MC key
    k0: int,               # first chunk
    nk: int,               # number of chunks
    m: int,
    asize: int,
    bsize: int,
    chunk: int,
    device: str | torch.device,
) -> torch.Tensor:
    """The shared coefficient matrices of chunks ``k0 .. k0+nk-1`` side by
    side: [m*m, nk*chunk] float32, column ``(k - k0)*chunk + K`` equal to
    column K of ``_shared_coeff(key, k)``."""
    device = torch.device(device)
    if is_cpu(device):
        return shared_coeff_plain(key, k0, nk, m, asize, bsize, chunk, device)
    if m > MC_MAX_M:
        raise NotImplementedError(
            f"css_mc_coeff ranks panels of at most {MC_MAX_M} individuals on "
            f"CUDA (m={m}); larger panels are ROADMAP item P12"
        )
    ncols = nk * chunk
    out = torch.empty((m * m, ncols), dtype=torch.float32, device=device)
    between, ca, cb = _coeff_constants(asize, bsize)
    k0w, k1w = (int(w) for w in key.tolist())
    launch(
        LAUNCHES, "css_mc_coeff", "css_mc_coeff", device,
        ctypes.c_uint32(k0w), ctypes.c_uint32(k1w), k0, nk, chunk, m, asize,
        ctypes.c_float(between), ctypes.c_float(ca), ctypes.c_float(cb),
        ptr(out),
    )
    return out


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 products in full float32 on CUDA (no TF32), whatever the
    caller's setting: the hits compare float32 scores."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def mc_significance(
    dist: torch.Tensor,     # [B, m, m]
    scores,                 # [B] observed CSS
    key: torch.Tensor,      # [2] run-level MC key
    asize: int,
    bsize: int,
    chunk: int,
    runs: int,
    threshold: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Plain torch version of the shared-stream MC
    (``perm.py:mc_significance``, ``stream="shared"``): a host-driven
    chunk loop with the same ``counted``/``cum``/``need``/``pos``
    arithmetic, on ``dist``'s device, stopping once every window is done.
    Returns (pvals float64, nscores, hits) as numpy arrays."""
    dev = dist.device
    B, m = dist.shape[0], dist.shape[-1]
    distf = dist.to(torch.float32).reshape(B, m * m)
    scoresf = torch.as_tensor(scores, dtype=torch.float64).to(torch.float32).to(dev)
    hits = torch.zeros(B, dtype=torch.int64, device=dev)
    nsc = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n_chunks = (runs + chunk - 1) // chunk
    key = key.to(dev)
    arange = torch.arange(chunk, device=dev)
    for k in range(n_chunks):
        if B == 0 or bool(done.all()):
            break
        M = _shared_coeff(key, k, m, asize, bsize, chunk)
        with _full_f32_matmul():
            new_scores = distf @ M                        # [B, K]
        offset = k * chunk
        counted = (offset + arange) < runs
        hit = (new_scores >= scoresf[:, None]) & counted[None, :]
        cum = torch.cumsum(hit.to(torch.int64), dim=-1)
        chunk_hits = cum[:, -1]
        n_counted = int(counted.sum())
        need = threshold - hits
        reached = (chunk_hits >= need) & ~done
        pos = torch.argmax((cum >= need[:, None]).to(torch.int8), dim=-1)
        hits = torch.where(done, hits, torch.where(reached, threshold, hits + chunk_hits))
        nsc = torch.where(
            done, nsc, torch.where(reached, offset + pos + 1, offset + n_counted)
        )
        done = done | reached
    hits_np = hits.cpu().numpy()
    nsc_np = nsc.cpu().numpy()
    return (hits_np + 1.0) / (nsc_np + 1.0), nsc_np, hits_np


def mc_shared(
    distf: torch.Tensor,   # [B, m*m] float32 on the card
    obs: torch.Tensor,     # [B] float32 observed scores on the card
    key: torch.Tensor,     # [2] run-level MC key
    asize: int,
    bsize: int,
    chunk: int,
    runs: int,
    threshold: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The shared-stream MC on the card: (nscores, hits) int32 [B].

    The chunks run in ranges: the coefficient kernel writes M for a range,
    then the MC kernel carries every still-active window through it, each
    tile of windows leaving the range as soon as all its windows are
    done.  The first range is short (most windows finish there); after
    each range the active windows are compacted, one host sync per
    range."""
    dev = distf.device
    B, mm = distf.shape
    m = asize + bsize
    if mm != m * m or not distf.is_contiguous() or distf.dtype != torch.float32:
        raise ValueError("css_mc_shared takes contiguous float32 [B, m*m] distances")
    hits = torch.zeros(B, dtype=torch.int32, device=dev)
    nsc = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.uint8, device=dev)
    n_chunks = (runs + chunk - 1) // chunk
    active = torch.arange(B, dtype=torch.int64, device=dev)
    later = max(1, _RANGE_COEFF_BYTES // (4 * mm * chunk))
    k = 0
    while k < n_chunks and active.numel():
        nk = min(_FIRST_RANGE_CHUNKS if k == 0 else later, n_chunks - k)
        M = shared_coeff(key, k, nk, m, asize, bsize, chunk, dev)
        launch(
            LAUNCHES, "css_mc_shared", "css_mc_shared", dev,
            ptr(distf), ptr(obs), ptr(active), active.numel(), m, ptr(M),
            k, nk, chunk, runs, threshold, ptr(hits), ptr(nsc), ptr(done),
        )
        k += nk
        if k < n_chunks:
            active = active[done[active] == 0]
    return nsc, hits


@dataclasses.dataclass
class McResult:
    pvals: np.ndarray      # [B]
    nscores: np.ndarray    # [B] permutations consumed
    hits: np.ndarray       # [B]


def significance(
    dist: torch.Tensor,     # [B, m, m] distance matrices of the windows
    scores,                 # [B] observed CSS (float64)
    asize: int,
    bsize: int,
    threshold: int,
    runs: int,
    key: torch.Tensor,      # [2] run-level MC key
    chunk: int = 256,
) -> McResult:
    """Adaptive permutation p-values for a set of windows
    (``perm.py:significance`` with ``stream="shared"``, ``bitgen="mix"``):
    the kernels on a CUDA ``dist``, the plain chunk loop on a CPU one."""
    B = dist.shape[0]
    if B == 0:
        z = np.zeros(0, dtype=np.int64)
        return McResult(pvals=np.zeros(0), nscores=z, hits=z.copy())
    if is_cpu(dist):
        pv, n, h = mc_significance(
            dist, scores, key, asize, bsize, chunk, runs, threshold
        )
        return McResult(pvals=pv, nscores=n, hits=h)
    m = dist.shape[-1]
    distf = dist.to(torch.float32).reshape(B, m * m).contiguous()
    obs = torch.as_tensor(scores, dtype=torch.float64).to(torch.float32)
    obs = obs.to(dist.device)
    nsc, hits = mc_shared(distf, obs, key, asize, bsize, chunk, runs, threshold)
    n = nsc.cpu().numpy().astype(np.int64)
    h = hits.cpu().numpy().astype(np.int64)
    return McResult(pvals=(h + 1.0) / (n + 1.0), nscores=n, hits=h)
