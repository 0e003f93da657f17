"""Permutation p-values for CSS significance: the adaptive Monte-Carlo
(K7, K8) and the Pearson-III approximation (K9).

Port of ``divergence_tpu/kernels/perm.py``.  The estimator of the MC is
the reference's (reference statistics/css/css.c:727-752): a window stops
at its ``threshold``-th hit (a permuted score ``>=`` the observed one,
both float32) or at ``runs``; ``n`` is the 1-based index of that hit or
``runs``, and ``p = (hits+1)/(n+1)``.  Two permutation streams:

* ``stream="shared"`` — chunk ``k`` of ``chunk`` permutations is keyed by
  ``fold_in(key, k)`` alone and shared by every window, so the CSS of
  every (window, permutation) pair is one product ``D_flat [B, m^2] @ M_k
  [m^2, chunk]`` with the rank-coefficient matrix ``M_k``
  (:func:`_shared_coeff`);
* ``stream="window"`` — window ``w`` owns ``fold_in(fold_in(key, chrom),
  slot)`` (:func:`rng.window_keys`) and chunk ``k`` of it is keyed by
  ``fold_in(wkey, k)``: independent noise per window, scored from the
  permutation ranks (:func:`_perm_scores`).

The draws of a chunk are ranked: ``bitgen="mix"`` ranks the counter words
``mix32(mix32(k0 ^ c) + k1)``, ``bitgen="threefry"`` the float32 uniforms
of the chunk key (the round-1 stream).  ``backend="native"`` is the JAX
package's host C++ evaluator (``native/mc_native.cpp``): the window
stream with ``mix`` draws, scored in float64 in a fixed order.  The port
does not copy its thread pool: on the CPU :func:`mc_native_plain` runs
the same arithmetic as torch, and on the card K8 runs it in its float64
form, with the same stream and the same per-window early exit.

Kernels (``csrc/``) carry the work on a CUDA device:

* ``css_mc_coeff``  (K7) — the columns of ``M`` for a range of chunks,
  bit-equal to :func:`_shared_coeff`, for either bitgen, each chunk's
  columns padded to whole 32-bit hit words (:func:`coeff_range`);
* ``css_mc_shared`` (K7) — the product ``D_flat[active] @ M`` of a range
  and its hit test, packed into words (:func:`mc_hit_words`);
* ``css_mc_scan``   (K7) — the adaptive stop through a range's hit words,
  the position of the threshold-th hit (:func:`mc_scan`);
* ``css_mc_window`` (K8) — the window-stream MC, one warp per window
  carrying its own stream to its own stop, in float32 (the terms of
  :func:`_scores_from_ranks`) or float64 (``mc_native``'s order);
* ``css_mc_power``  (K9) — per-chunk float64 power sums of the permuted
  scores (:func:`null_power_sums`), shared or window stream, for
  :func:`approx_significance`;
* ``css_perm_chunk`` (K11) — one fixed chunk of the null per window with a
  hit target (:func:`permutation_chunk`), the sharded step's MC.

:func:`significance`, :func:`null_power_sums`,
:func:`approx_significance` and :func:`permutation_chunk` launch them on a
CUDA ``dist`` (or raise) and run the plain torch versions on a CPU one.
``sharding=`` (a ``parallel.make_mesh`` tuple) splits the windows of
:func:`significance` and :func:`approx_significance` into contiguous
shares, one per device, run one after another: every window's result
depends on its own stream and stop only, so the union equals the
unsharded run.  Each stop is per window, so
there is no window batching, padding or two-stage compaction (the JAX
package's ``lax.map`` slices existed for XLA on the TPU); the results are
those of the JAX package's single-pass loop.  The JAX ``perm_form``
("broadcast" / "matmul") scores the same permutations in two float32
layouts; the port has one.  Each launch adds one to :data:`LAUNCHES`.
The function defaults follow ``CssConfig`` (``stream="shared"``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import numpy as np
import torch

from divergence_tpu_torch import rng
from divergence_tpu_torch.kernels._cuda import is_cpu, launch, ptr

MC_MAX_M = 64                   # the MC kernels rank m words per thread
BITGENS = ("mix", "threefry")   # kernel argument: the index in this tuple
STREAMS = ("shared", "window")
# the shared stream's ranges (range_chunks)
_FIRST_RANGE_CHUNKS = 16        # at most: 4096 permutations at chunk 256
_RANGE_FMAS = 1 << 32           # product work a range reaches where it can
_RANGE_COEFF_BYTES = 64 << 20   # at most this much of M at once
_RANGE_HIT_BYTES = 256 << 20    # at most this much of hit words at once
WORD_BITS = 32                  # a chunk's columns are padded to whole words
TILE_COLUMNS = 128              # columns of a product tile (csrc permk::kTC)
# [b, m, m, K] elements per step of the window-stream twins, by device type
_PLAIN_BATCH_ELEMS = {"cpu": 1 << 24, "cuda": 1 << 28}

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES = {"css_mc_coeff": 0, "css_mc_shared": 0, "css_mc_scan": 0, "css_mc_window": 0,
            "css_mc_power": 0, "css_perm_chunk": 0}
# css_mc_coeff launches by bitgen (counted with LAUNCHES["css_mc_coeff"])
COEFF_LAUNCHES = {name: 0 for name in BITGENS}


def reset_launches() -> None:
    for counts in (LAUNCHES, COEFF_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _chain_weights(asize: int, bsize: int) -> tuple[float, float]:
    wa = 1.0 / (asize * asize * (asize - 1)) if asize > 1 else 0.0
    wb = 1.0 / (bsize * bsize * (bsize - 1)) if bsize > 1 else 0.0
    return wa, wb


def _check_bitgen(bitgen: str) -> int:
    if bitgen not in BITGENS:
        raise ValueError(f"bitgen must be one of {BITGENS}, got {bitgen!r}")
    return BITGENS.index(bitgen)


def _draws(keys: torch.Tensor, chunk: int, m: int, bitgen: str) -> torch.Tensor:
    """The [B, chunk, m] draws of keys [B, 2] that a chunk's ranks order:
    element (K, j) is flat draw ``K*m + j`` of ``mix_bits`` or of
    ``uniform(key, (chunk, m), float32)``."""
    _check_bitgen(bitgen)
    if bitgen == "mix":
        x = rng.mix_bits(keys, chunk * m)
    else:
        x = rng.uniform(keys, chunk * m, torch.float32)
    return x.reshape(keys.shape[0], chunk, m)


def _ranks(keys: torch.Tensor, chunk: int, m: int, bitgen: str = "mix") -> torch.Tensor:
    """Permutation ranks [B, m, K]: the position of individual j in the
    stable ascending order of the draws of keys [B, 2], by pairwise
    compares with index tie-break (``perm.py:_ranks``).  Threefry draws
    compare as float32 values, so equal uniforms tie on the index."""
    xt = _draws(keys, chunk, m, bitgen).transpose(-1, -2)   # [B, m, K]
    xj = xt[:, :, None, :]
    xl = xt[:, None, :, :]
    idx = torch.arange(m, device=keys.device)
    tie = (idx[:, None] > idx[None, :])[None, :, :, None]
    cmp = (xj > xl) | ((xj == xl) & tie)
    return cmp.sum(dim=2)                                    # [B, m, K]


def _coeff_constants(asize: int, bsize: int) -> tuple[float, float, float]:
    """The three float32 values a coefficient column is built from, as the
    JAX package rounds them: the between weight ``1/(a b)`` (a float32
    division) and the chain weights ``(a+b) w`` (a float64 product,
    rounded once to float32)."""
    wa, wb = _chain_weights(asize, bsize)
    m = asize + bsize
    between = np.float32(1.0) / np.float32(asize * bsize)
    return float(between), float(np.float32(m * wa)), float(np.float32(m * wb))


def _rank_coeff(r: torch.Tensor, asize: int, bsize: int) -> torch.Tensor:
    """Coefficients [..., m, m, K] float32 of ranks r [..., m, K]:
    C[j, l] = u_j (1-u_l)/(a b) - (a+b) w(r_j) 1[r_l = r_j + 1],
    u_j = 1[r_j < a], the values the JAX package builds in float32."""
    m = asize + bsize
    between, ca, cb = _coeff_constants(asize, bsize)
    cw = torch.where(
        r < asize - 1, ca, torch.where((r >= asize) & (r < m - 1), cb, 0.0)
    ).to(torch.float32)
    adj = r[..., None, :, :] == r[..., :, None, :] + 1      # [..., j, l, K]
    u = r < asize
    bet = torch.where(u[..., :, None, :] & ~u[..., None, :, :], between, 0.0)
    chain = torch.where(adj, cw[..., :, None, :], 0.0)
    return bet.to(torch.float32) - chain.to(torch.float32)


def _shared_coeff(key: torch.Tensor, k: int, m: int, asize: int, bsize: int,
                  chunk: int, bitgen: str = "mix") -> torch.Tensor:
    """Rank-coefficient matrix M [m*m, chunk] float32 of shared chunk ``k``
    (``perm.py:_shared_coeff``): column K holds vec(C) of the ranks of
    ``fold_in(key, k)``'s draws."""
    kc = rng.fold_in(key, k)
    r = _ranks(kc[None], chunk, m, bitgen)[0]            # [m, K]
    return _rank_coeff(r, asize, bsize).reshape(m * m, chunk)


def _scores_from_ranks(distf: torch.Tensor, r: torch.Tensor, asize: int,
                       bsize: int) -> torch.Tensor:
    """CSS [B, K] float32 of the rank-encoded permutations r [B, m, K]
    against distf [B, m, m] float32 (``perm.py:_scores_from_ranks``,
    ``form="broadcast"``): the float32 products D[j, l] C[j, l] added one
    after another in row-major (j, l) order, from 0.  That is the order of
    XLA's fused reduction on the CPU, so the scores equal the JAX
    package's bit for bit; K8 adds the same products in the same order."""
    prod = distf[..., None] * _rank_coeff(r, asize, bsize)   # [B, m, m, K]
    m = distf.shape[-1]
    acc = torch.zeros_like(prod[:, 0, 0])
    for j in range(m):
        for l in range(m):
            acc += prod[:, j, l]
    return acc


def _window_step(dev: torch.device, m: int, chunk: int) -> int:
    """Windows per step of a window-stream twin: its [b, m, m, K]
    temporaries stay within ``_PLAIN_BATCH_ELEMS``."""
    return max(1, _PLAIN_BATCH_ELEMS[dev.type] // (m * m * chunk))


def _perm_scores(distf: torch.Tensor, keys: torch.Tensor, asize: int,
                 bsize: int, chunk: int, bitgen: str = "mix") -> torch.Tensor:
    """CSS [B, K] float32 of ``chunk`` permutations per window, window w's
    drawn from keys[w] (``perm.py:_perm_scores``), in window batches of
    at most ``_PLAIN_BATCH_ELEMS`` coefficients."""
    B, m = distf.shape[0], distf.shape[-1]
    step = _window_step(distf.device, m, chunk)
    out = torch.empty((B, chunk), dtype=torch.float32, device=distf.device)
    for s in range(0, B, step):
        sl = slice(s, min(s + step, B))
        out[sl] = _scores_from_ranks(
            distf[sl], _ranks(keys[sl], chunk, m, bitgen), asize, bsize
        )
    return out


def shared_coeff_plain(key, k0, nk, m, asize, bsize, chunk, device,
                       bitgen: str = "mix") -> torch.Tensor:
    """Plain torch version of :func:`shared_coeff`."""
    key = key.to(device)
    return torch.cat(
        [_shared_coeff(key, k, m, asize, bsize, chunk, bitgen)
         for k in range(k0, k0 + nk)],
        dim=1,
    )


def _check_m(m: int, kernel: str) -> None:
    if m > MC_MAX_M:
        raise NotImplementedError(
            f"{kernel} ranks panels of at most {MC_MAX_M} individuals on "
            f"CUDA (m={m}); larger panels are ROADMAP item P12"
        )


def chunk_stride(chunk: int) -> int:
    """Columns a chunk takes in a range's M: ``chunk`` rounded up to whole
    hit words, so a word never spans two chunks."""
    return -(-chunk // WORD_BITS) * WORD_BITS


def coeff_range_plain(key, k0, nk, m, asize, bsize, chunk, device,
                      bitgen: str = "mix") -> torch.Tensor:
    """Plain torch version of :func:`coeff_range`."""
    M = shared_coeff_plain(key, k0, nk, m, asize, bsize, chunk, device, bitgen)
    pad = chunk_stride(chunk) - chunk
    M = torch.nn.functional.pad(M.reshape(m * m, nk, chunk), (0, pad))
    return M.reshape(m * m, nk * (chunk + pad))


def coeff_range(
    key: torch.Tensor,     # [2] run-level MC key
    k0: int,               # first chunk
    nk: int,               # number of chunks
    m: int,
    asize: int,
    bsize: int,
    chunk: int,
    device: str | torch.device,
    bitgen: str = "mix",
) -> torch.Tensor:
    """The shared coefficient matrices of chunks ``k0 .. k0+nk-1`` side by
    side, each padded with zero columns to ``cs = chunk_stride(chunk)``:
    [m*m, nk*cs] float32, column ``(k - k0)*cs + K`` equal to column K of
    ``_shared_coeff(key, k)`` for K < chunk.  K7's ``css_mc_coeff`` on a
    CUDA device, the plain version on the CPU."""
    device = torch.device(device)
    gen = _check_bitgen(bitgen)
    if is_cpu(device):
        return coeff_range_plain(key, k0, nk, m, asize, bsize, chunk, device, bitgen)
    _check_m(m, "css_mc_coeff")
    cs = chunk_stride(chunk)
    out = torch.empty((m * m, nk * cs), dtype=torch.float32, device=device)
    between, ca, cb = _coeff_constants(asize, bsize)
    k0w, k1w = (int(w) for w in key.tolist())
    launch(
        LAUNCHES, "css_mc_coeff", "css_mc_coeff", device,
        ctypes.c_uint32(k0w), ctypes.c_uint32(k1w), k0, nk, chunk, cs, m, asize, gen,
        ctypes.c_float(between), ctypes.c_float(ca), ctypes.c_float(cb),
        ptr(out),
    )
    COEFF_LAUNCHES[bitgen] += 1
    return out


def shared_coeff(key, k0, nk, m, asize, bsize, chunk, device,
                 bitgen: str = "mix") -> torch.Tensor:
    """:func:`coeff_range` without the padding: [m*m, nk*chunk], column
    ``(k - k0)*chunk + K`` equal to column K of ``_shared_coeff(key, k)``."""
    M = coeff_range(key, k0, nk, m, asize, bsize, chunk, device, bitgen)
    return M.reshape(m * m, nk, -1)[:, :, :chunk].reshape(m * m, nk * chunk)


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


def _chunk_update(hit, k, chunk, runs, threshold, hits, nsc):
    """One chunk of the adaptive loop for windows not yet done
    (``perm.py:362-380``): hit [b, K] bool of the chunk's permutations,
    counted ones only.  Returns (hits, nsc, reached)."""
    offset = k * chunk
    counted = (offset + torch.arange(hit.shape[1], device=hit.device)) < runs
    hit = hit & counted[None, :]
    cum = torch.cumsum(hit.to(torch.int64), dim=-1)
    chunk_hits = cum[:, -1]
    n_counted = int(counted.sum())
    need = threshold - hits
    reached = chunk_hits >= need
    pos = torch.argmax((cum >= need[:, None]).to(torch.int8), dim=-1)
    hits = torch.where(reached, threshold, hits + chunk_hits)
    nsc = torch.where(reached, offset + pos + 1, offset + n_counted)
    return hits, nsc, reached


def _mc_loop(B, dev, chunk, runs, threshold, chunk_hits_of):
    """The host-driven chunk loop shared by the plain MCs: chunk_hits_of(k,
    rows) gives hit [len(rows), chunk] for the windows still running;
    stops once every window is done.  Returns (pvals, nscores, hits)."""
    hits = torch.zeros(B, dtype=torch.int64, device=dev)
    nsc = torch.zeros(B, dtype=torch.int64, device=dev)
    active = torch.arange(B, device=dev)
    for k in range((runs + chunk - 1) // chunk):
        if active.numel() == 0:
            break
        h, n, reached = _chunk_update(
            chunk_hits_of(k, active), k, chunk, runs, threshold, hits[active], nsc[active]
        )
        hits[active] = h
        nsc[active] = n
        active = active[~reached]
    hits_np = hits.cpu().numpy()
    nsc_np = nsc.cpu().numpy()
    return (hits_np + 1.0) / (nsc_np + 1.0), nsc_np, hits_np


def _observed_f32(scores, dev) -> torch.Tensor:
    return torch.as_tensor(scores, dtype=torch.float64).to(torch.float32).to(dev)


def mc_significance(
    dist: torch.Tensor,     # [B, m, m]
    scores,                 # [B] observed CSS
    key: torch.Tensor,      # [2] run-level MC key (shared) or [B, 2] window keys
    asize: int,
    bsize: int,
    chunk: int,
    runs: int,
    threshold: int,
    stream: str = "shared",
    bitgen: str = "mix",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Plain torch version of the float32 MC (``perm.py:mc_significance``):
    a host-driven chunk loop with the same ``counted``/``cum``/``need``/
    ``pos`` arithmetic, on ``dist``'s device, carrying only the windows
    still running (each window's result depends on its own stream only).
    Returns (pvals float64, nscores, hits) as numpy arrays."""
    dev = dist.device
    B, m = dist.shape[0], dist.shape[-1]
    distf = dist.to(torch.float32)
    obs = _observed_f32(scores, dev)
    key = key.to(dev)
    if stream == "shared":
        flat = distf.reshape(B, m * m)

        def chunk_hits(k, rows):
            M = _shared_coeff(key, k, m, asize, bsize, chunk, bitgen)
            with _full_f32_matmul():
                return (flat[rows] @ M) >= obs[rows, None]
    elif stream == "window":
        def chunk_hits(k, rows):
            s = _perm_scores(distf[rows], rng.fold_in(key[rows], k), asize, bsize,
                             chunk, bitgen)
            return s >= obs[rows, None]
    else:
        raise ValueError(f"stream must be one of {STREAMS}, got {stream!r}")
    return _mc_loop(B, dev, chunk, runs, threshold, chunk_hits)


def _native_scores(D: torch.Tensor, rowtot: torch.Tensor, r: torch.Tensor,
                   asize: int, bsize: int) -> torch.Tensor:
    """float64 CSS [b, K] of ranks r [b, m, K] against D [b, m, m] float64
    in ``mc_native``'s order (``native/mc_native.cpp:272-294``), looping
    over rank positions: row totals over the smaller group and
    ``between = rt - 2 within``, the a- and b-chains over rank-adjacent
    pairs, ``s = between inv_ab - m (wa chain_a + wb chain_b)``."""
    b, m, K = r.shape
    wa, wb = _chain_weights(asize, bsize)
    inv_ab = 1.0 / (asize * bsize)
    order = torch.empty_like(r)                              # order[rank] = j
    order.scatter_(1, r, torch.arange(m, device=r.device)[None, :, None].expand(b, m, K))
    flat = D.reshape(b, m * m)

    def d_at(j, l):
        return flat.gather(1, j * m + l)

    g_lo, g_hi = (asize, m) if bsize <= asize else (0, asize)
    zero = torch.zeros((b, K), dtype=torch.float64, device=D.device)
    rt, within = zero, zero
    for p in range(g_lo, g_hi):
        j = order[:, p]
        rt = rt + rowtot.gather(1, j)
        acc = zero
        for q in range(p + 1, g_hi):
            acc = acc + d_at(j, order[:, q])
        within = within + acc
    between = rt - 2.0 * within
    chain_a, chain_b = zero, zero
    for p in range(0, asize - 1):
        chain_a = chain_a + d_at(order[:, p], order[:, p + 1])
    for p in range(asize, m - 1):
        chain_b = chain_b + d_at(order[:, p], order[:, p + 1])
    return between * inv_ab - float(m) * (wa * chain_a + wb * chain_b)


def _row_totals(D: torch.Tensor) -> torch.Tensor:
    """Row sums of D [b, m, m] float64, l = 0, 1, ... in order."""
    acc = torch.zeros(D.shape[:2], dtype=torch.float64, device=D.device)
    for l in range(D.shape[-1]):
        acc = acc + D[:, :, l]
    return acc


def mc_native_plain(
    dist: torch.Tensor,     # [B, m, m]
    scores,                 # [B] observed CSS
    wkeys: torch.Tensor,    # [B, 2] window keys
    asize: int,
    bsize: int,
    chunk: int,
    runs: int,
    threshold: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Plain torch version of ``perm_backend="native"``
    (``native/mc_native.cpp:mc_native``): the window stream with ``mix``
    draws, float32 distances widened to float64, scored by
    :func:`_native_scores`, a hit when the score is ``>=`` the float32
    observed score widened to float64.  Returns (pvals, nscores, hits)."""
    dev = dist.device
    B, m = dist.shape[0], dist.shape[-1]
    D = dist.to(torch.float32).to(torch.float64)
    rowtot = _row_totals(D)
    obs = _observed_f32(scores, dev).to(torch.float64)
    wkeys = wkeys.to(dev)
    step = _window_step(dev, m, chunk)

    def chunk_hits(k, rows):
        out = torch.empty((rows.numel(), chunk), dtype=torch.bool, device=dev)
        for s in range(0, rows.numel(), step):
            sel = rows[s:s + step]
            r = _ranks(rng.fold_in(wkeys[sel], k), chunk, m, "mix")
            out[s:s + step] = _native_scores(D[sel], rowtot[sel], r, asize, bsize) >= obs[sel, None]
        return out

    return _mc_loop(B, dev, chunk, runs, threshold, chunk_hits)


def _pack_words(hit: torch.Tensor) -> torch.Tensor:
    """[..., n*32] bool -> [..., n] int32 words, bit b of word q = element
    32 q + b (the bits of a uint32)."""
    bits = hit.reshape(*hit.shape[:-1], -1, WORD_BITS).to(torch.int64)
    v = (bits << torch.arange(WORD_BITS, device=hit.device)).sum(dim=-1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _unpack_words(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_words`: [..., n] -> [..., n*32] bool."""
    bits = (words.to(torch.int64)[..., None]
            >> torch.arange(WORD_BITS, device=words.device)) & 1
    return bits.reshape(*words.shape[:-1], -1).bool()


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the 32-bit words held in int64 ``x``."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _check_range(flat, obs, active, M, nk, chunk) -> int:
    """m of a range's inputs for css_mc_shared; raises on what it does not
    take."""
    mm = flat.shape[-1]
    m = round(mm ** 0.5)
    if (flat.dim() != 2 or m * m != mm or flat.dtype != torch.float32
            or not flat.is_contiguous()):
        raise ValueError("css_mc_shared takes contiguous float32 [B, m*m] distances")
    if obs.shape != flat.shape[:1] or obs.dtype != torch.float32 or not obs.is_contiguous():
        raise ValueError("css_mc_shared takes contiguous float32 [B] observed scores")
    if M.shape != (mm, nk * chunk_stride(chunk)) or not M.is_contiguous():
        raise ValueError(f"css_mc_shared takes M [{mm}, {nk} * chunk_stride({chunk})], "
                         f"got {tuple(M.shape)}")
    if active.dtype != torch.int64 or not active.is_contiguous():
        raise ValueError("css_mc_shared takes contiguous int64 active rows")
    return m


def mc_hit_words_plain(flat, obs, active, M, k0, nk, chunk, runs) -> torch.Tensor:
    """Plain torch version of :func:`mc_hit_words`: the product in full
    float32, the hit test, the words packed per chunk."""
    cs = chunk_stride(chunk)
    with _full_f32_matmul():
        s = (flat[active] @ M).reshape(-1, nk, cs)
    K = torch.arange(cs, device=flat.device)
    offset = (k0 + torch.arange(nk, device=flat.device))[:, None] * chunk
    counted = (K < chunk)[None, :] & (offset + K[None, :] < runs)      # [nk, cs]
    return _pack_words((s >= obs[active][:, None, None]) & counted)


def mc_hit_words(
    flat: torch.Tensor,     # [B, m*m] float32 distances
    obs: torch.Tensor,      # [B] float32 observed scores
    active: torch.Tensor,   # [A] int64 rows of flat taking part
    M: torch.Tensor,        # [m*m, nk*cs] coeff_range of chunks k0 .. k0+nk-1
    k0: int,
    nk: int,
    chunk: int,
    runs: int,
) -> torch.Tensor:
    """The hits of a range (K7 ``css_mc_shared``): int32 words [A, nk,
    cs/32], bit b of word q of chunk kk set where permutation K = 32 q + b
    of chunk k0 + kk counts (K < chunk, (k0 + kk)*chunk + K < runs) and
    scores ``>=`` the window's observed score, both float32.  The kernel
    on a CUDA ``flat``, the plain version on a CPU one."""
    if is_cpu(flat):
        return mc_hit_words_plain(flat, obs, active, M, k0, nk, chunk, runs)
    m = _check_range(flat, obs, active, M, nk, chunk)
    cs = chunk_stride(chunk)
    words = torch.empty((active.numel(), nk, cs // WORD_BITS), dtype=torch.int32,
                        device=flat.device)
    launch(
        LAUNCHES, "css_mc_shared", "css_mc_shared", flat.device,
        ptr(flat), m, ptr(active), active.numel(), ptr(obs), ptr(M), k0, nk, chunk, cs,
        runs, ptr(words),
    )
    return words


def mc_scan_plain(words, active, k0, chunk, runs, threshold, hits, nsc, done) -> None:
    """Plain torch version of :func:`mc_scan`, word by word as the kernel
    goes: per chunk the words' popcounts, the first word whose running
    count reaches ``need``, and the set bit within it that does."""
    nk = words.shape[1]
    w = words.to(torch.int64) & 0xFFFFFFFF                     # [A, nk, wpc]
    h, n, d = hits[active].long(), nsc[active].long(), done[active] != 0
    bit = torch.arange(WORD_BITS, device=words.device)
    for kk in range(nk):
        offset = (k0 + kk) * chunk
        pc = _popcount32(w[:, kk])                             # [A, wpc]
        cum = torch.cumsum(pc, dim=1)
        total = cum[:, -1]
        need = threshold - h
        reached = ~d & (total >= need)
        q = torch.argmax((cum >= need[:, None]).to(torch.int8), dim=1)
        before = (cum - pc).gather(1, q[:, None])[:, 0]
        word = w[:, kk].gather(1, q[:, None])[:, 0]
        inword = torch.cumsum((word[:, None] >> bit) & 1, dim=1)
        b = torch.argmax((inword >= (need - before)[:, None]).to(torch.int8), dim=1)
        pos = torch.where(need <= 0, 0, q * WORD_BITS + b)
        h = torch.where(d, h, torch.where(reached, threshold, h + total))
        n = torch.where(d, n, torch.where(reached, offset + pos + 1,
                                          offset + min(chunk, runs - offset)))
        d = d | reached
    hits[active] = h.to(hits.dtype)
    nsc[active] = n.to(nsc.dtype)
    done[active] = d.to(done.dtype)


def mc_scan(
    words: torch.Tensor,    # [A, nk, cs/32] int32, mc_hit_words of chunks k0 ..
    active: torch.Tensor,   # [A] int64 rows
    k0: int,
    chunk: int,
    runs: int,
    threshold: int,
    hits: torch.Tensor,     # [B] int32, updated in place
    nsc: torch.Tensor,      # [B] int32, updated in place
    done: torch.Tensor,     # [B] uint8, updated in place
) -> None:
    """The adaptive stop through a range (K7 ``css_mc_scan``): each window
    ``active[a]`` not yet done goes through its chunks in order with the
    update of ``perm.py:362-380`` (:func:`_chunk_update`) — a chunk whose
    hits reach ``need = threshold - hits`` stops it at the column of the
    need-th hit (hits = threshold, n = offset + pos + 1), any other adds
    its hits and sets n = offset + counted.  The kernel on CUDA tensors,
    the plain version on CPU ones."""
    if is_cpu(words):
        mc_scan_plain(words, active, k0, chunk, runs, threshold, hits, nsc, done)
        return
    A, nk, wpc = words.shape
    if wpc != chunk_stride(chunk) // WORD_BITS or not words.is_contiguous():
        raise ValueError(f"css_mc_scan takes contiguous words [A, nk, {wpc}]")
    if (active.shape != (A,) or active.dtype != torch.int64
            or [t.dtype for t in (hits, nsc, done)] != [torch.int32, torch.int32, torch.uint8]
            or not all(t.is_contiguous() for t in (active, hits, nsc, done))):
        raise ValueError("css_mc_scan takes contiguous int64 rows and int32 / int32 / "
                         "uint8 state")
    launch(
        LAUNCHES, "css_mc_scan", "css_mc_scan", words.device,
        ptr(words), ptr(active), A, k0, nk, chunk, chunk_stride(chunk), runs, threshold,
        ptr(hits), ptr(nsc), ptr(done),
    )


def range_chunks(k: int, n_chunks: int, nact: int, mm: int, chunk: int) -> int:
    """Chunks of the shared stream's range that starts at chunk ``k`` with
    ``nact`` windows running.  A range's product costs nact x nk*chunk x
    mm FMAs and every running window pays for all of it, though it may
    stop in the first chunk; each range ends with one host sync.  So a
    range takes as many chunks as came before it (a window that stops
    inside pays at most as much again as it consumed) and at least enough
    for ``_RANGE_FMAS`` of work (the sync stays small beside it), the first
    at most ``_FIRST_RANGE_CHUNKS``; and never more M than
    ``_RANGE_COEFF_BYTES`` or hit words than ``_RANGE_HIT_BYTES`` (one
    chunk at least)."""
    cs = chunk_stride(chunk)
    nact = max(nact, 1)
    want = max(k, _RANGE_FMAS // (nact * mm * chunk))
    if k == 0:
        want = min(want, _FIRST_RANGE_CHUNKS)
    cap = min(_RANGE_COEFF_BYTES // (4 * mm * cs), _RANGE_HIT_BYTES // (nact * cs // 8))
    return max(1, min(want, cap, n_chunks - k))


def mc_shared(
    distf: torch.Tensor,   # [B, m*m] float32
    obs: torch.Tensor,     # [B] float32 observed scores
    key: torch.Tensor,     # [2] run-level MC key
    asize: int,
    bsize: int,
    chunk: int,
    runs: int,
    threshold: int,
    bitgen: str = "mix",
    ranges: list | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The shared-stream MC in ranges of chunks: (nscores, hits) int32
    [B].  For each range (:func:`range_chunks`) M of its chunks
    (:func:`coeff_range`), the hit words of every running window
    (:func:`mc_hit_words`) and the adaptive stop (:func:`mc_scan`); then
    the running windows are compacted, one host sync per range.  The
    kernels on the card, their plain versions on the CPU.  ``ranges``, if
    given, gets (first chunk, chunks, running windows) of each range."""
    dev = distf.device
    B, mm = distf.shape
    m = asize + bsize
    if mm != m * m or not distf.is_contiguous() or distf.dtype != torch.float32:
        raise ValueError("css_mc_shared takes contiguous float32 [B, m*m] distances")
    obs = obs.to(device=dev, dtype=torch.float32).contiguous()
    hits = torch.zeros(B, dtype=torch.int32, device=dev)
    nsc = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.uint8, device=dev)
    n_chunks = (runs + chunk - 1) // chunk
    active = torch.arange(B, dtype=torch.int64, device=dev)
    k = 0
    while k < n_chunks and active.numel():
        nk = range_chunks(k, n_chunks, active.numel(), mm, chunk)
        M = coeff_range(key, k, nk, m, asize, bsize, chunk, dev, bitgen)
        words = mc_hit_words(distf, obs, active, M, k, nk, chunk, runs)
        mc_scan(words, active, k, chunk, runs, threshold, hits, nsc, done)
        if ranges is not None:
            ranges.append((k, nk, active.numel()))
        k += nk
        if k < n_chunks:
            active = active[done[active] == 0]
    return nsc, hits


def _flat_f32(dist: torch.Tensor, kernel: str) -> torch.Tensor:
    """[B, m*m] contiguous float32 distances for a kernel, m checked."""
    B, m = dist.shape[0], dist.shape[-1]
    if dist.dim() != 3 or dist.shape[1] != m:
        raise ValueError(f"{kernel} takes [B, m, m] distances, got {tuple(dist.shape)}")
    _check_m(m, kernel)
    return dist.to(torch.float32).reshape(B, m * m).contiguous()


def _window_key_words(wkeys: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """[B, 2] int64 key words on the card, contiguous, for the kernels."""
    if wkeys.dim() != 2 or wkeys.shape[1] != 2:
        raise ValueError(f"window keys must be [B, 2], got {tuple(wkeys.shape)}")
    return wkeys.to(device=dev, dtype=torch.int64).contiguous()


def mc_window(
    dist: torch.Tensor,    # [B, m, m] on the card
    obs: torch.Tensor,     # [B] float32 observed scores on the card
    wkeys: torch.Tensor,   # [B, 2] window keys
    asize: int,
    bsize: int,
    chunk: int,
    runs: int,
    threshold: int,
    bitgen: str = "mix",
    native: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The window-stream MC on the card (K8): (nscores, hits) int32 [B],
    one launch, each window to its own stop.  ``native=True`` scores in
    float64 in ``mc_native``'s order (``mix`` draws only)."""
    dev = dist.device
    B = dist.shape[0]
    distf = _flat_f32(dist, "css_mc_window")
    gen = _check_bitgen(bitgen)
    if native and bitgen != "mix":
        raise ValueError("perm_backend='native' replays the 'mix' stream only")
    keys = _window_key_words(wkeys, dev)
    obs = obs.to(device=dev, dtype=torch.float32).contiguous()
    hits = torch.empty(B, dtype=torch.int32, device=dev)
    nsc = torch.empty(B, dtype=torch.int32, device=dev)
    between, ca, cb = _coeff_constants(asize, bsize)
    wa, wb = _chain_weights(asize, bsize)
    launch(
        LAUNCHES, "css_mc_window", "css_mc_window", dev,
        ptr(distf), ptr(obs), ptr(keys), B, asize + bsize, asize, chunk, runs,
        threshold, gen, int(native), ctypes.c_float(between), ctypes.c_float(ca),
        ctypes.c_float(cb), ctypes.c_double(wa), ctypes.c_double(wb),
        ctypes.c_double(1.0 / (asize * bsize)), ptr(hits), ptr(nsc),
    )
    return nsc, hits


@dataclasses.dataclass
class McResult:
    pvals: np.ndarray      # [B]
    nscores: np.ndarray    # [B] permutations consumed
    hits: np.ndarray       # [B]


def _over_shares(sharding, dist, scores, chroms, slots, run) -> McResult:
    """``run(dist, scores, chroms, slots)`` on each device's contiguous
    share of the windows, in device order, the results concatenated.  The
    window-stream defaults (chromosome 0, slot = window index) are fixed
    over the whole batch first, so a share keeps its windows' streams."""
    from divergence_tpu_torch.parallel.mesh import window_slices

    B = dist.shape[0]
    scores = np.asarray(scores, dtype=np.float64)
    chroms = np.zeros(B, dtype=np.int64) if chroms is None else np.asarray(chroms)
    slots = np.arange(B, dtype=np.int64) if slots is None else np.asarray(slots)
    parts = [
        run(dist[sl].to(dev), scores[sl], chroms[sl], slots[sl])
        for dev, sl in zip(sharding, window_slices(B, sharding))
    ]
    return McResult(*(np.concatenate([getattr(r, f) for r in parts])
                      for f in ("pvals", "nscores", "hits")))


def _stream_keys(key, B, chroms, slots, stream, dev) -> torch.Tensor:
    """The run-level key (shared) or the [B, 2] window keys (window)."""
    if stream not in STREAMS:
        raise ValueError(f"stream must be one of {STREAMS}, got {stream!r}")
    key = key.to(dev)
    if stream == "shared":
        return key
    chroms = np.zeros(B, dtype=np.int64) if chroms is None else chroms
    slots = np.arange(B, dtype=np.int64) if slots is None else slots
    return rng.window_keys(key, chroms, slots)


def significance(
    dist: torch.Tensor,     # [B, m, m] distance matrices of the windows
    scores,                 # [B] observed CSS (float64)
    asize: int,
    bsize: int,
    threshold: int,
    runs: int,
    key: torch.Tensor,      # [2] run-level MC key
    chunk: int = 256,
    chroms=None,            # [B] chromosome hashes (window stream)
    slots=None,             # [B] window slots (window stream)
    backend: str = "xla",
    bitgen: str = "mix",
    stream: str = "shared",
    sharding=None,          # a parallel.make_mesh tuple: one share per device
) -> McResult:
    """Adaptive permutation p-values for a set of windows
    (``perm.py:significance``): the kernels on a CUDA ``dist``, the plain
    chunk loops on a CPU one.  Window w of the window stream is keyed by
    (chroms[w], slots[w]); ``backend="native"`` needs that stream and
    ``mix`` draws, as in the JAX package.  With ``sharding`` each device
    takes a contiguous share of the windows."""
    if sharding is not None:
        return _over_shares(
            sharding, dist, scores, chroms, slots,
            lambda d, sc, ch, sl: significance(
                d, sc, asize, bsize, threshold, runs, key, chunk, ch, sl, backend,
                bitgen, stream,
            ),
        )
    if backend not in ("xla", "native"):
        raise ValueError(f"backend must be 'xla' or 'native', got {backend!r}")
    if backend == "native" and stream == "shared":
        raise ValueError(
            f"backend={backend!r} replays per-window streams; use stream='window'"
        )
    if backend == "native" and bitgen != "mix":
        raise ValueError("perm_backend='native' replays the 'mix' stream only")
    _check_bitgen(bitgen)
    B = dist.shape[0]
    keys = _stream_keys(key, B, chroms, slots, stream, dist.device)
    if B == 0:
        z = np.zeros(0, dtype=np.int64)
        return McResult(pvals=np.zeros(0), nscores=z, hits=z.copy())
    if is_cpu(dist):
        if backend == "native":
            pv, n, h = mc_native_plain(dist, scores, keys, asize, bsize, chunk,
                                       runs, threshold)
        else:
            pv, n, h = mc_significance(dist, scores, keys, asize, bsize, chunk, runs,
                                       threshold, stream=stream, bitgen=bitgen)
        return McResult(pvals=pv, nscores=n, hits=h)
    obs = _observed_f32(scores, dist.device)
    if stream == "shared":
        m = dist.shape[-1]
        distf = dist.to(torch.float32).reshape(B, m * m).contiguous()
        nsc, hits = mc_shared(distf, obs, keys, asize, bsize, chunk, runs, threshold,
                              bitgen)
    else:
        nsc, hits = mc_window(dist, obs, keys, asize, bsize, chunk, runs, threshold,
                              bitgen, native=backend == "native")
    n = nsc.cpu().numpy().astype(np.int64)
    h = hits.cpu().numpy().astype(np.int64)
    return McResult(pvals=(h + 1.0) / (n + 1.0), nscores=n, hits=h)


# ---------------------------------------------------------------- approx mode


def null_power_sums_plain(
    dist: torch.Tensor,     # [B, m, m]
    keys: torch.Tensor,     # [2] run-level key (shared) or [B, 2] window keys
    asize: int,
    bsize: int,
    chunk: int,
    k0: int,
    n_chunks: int,
    stream: str = "shared",
    bitgen: str = "mix",
) -> torch.Tensor:
    """Plain torch version of :func:`null_power_sums`
    (``perm.py:_null_power_sums``)."""
    dev = dist.device
    B, m = dist.shape[0], dist.shape[-1]
    distf = dist.to(torch.float32)
    keys = keys.to(dev)
    out = torch.empty((n_chunks, 3, B), dtype=torch.float64, device=dev)
    for i, k in enumerate(range(k0, k0 + n_chunks)):
        if stream == "shared":
            M = _shared_coeff(keys, k, m, asize, bsize, chunk, bitgen)
            with _full_f32_matmul():
                s = distf.reshape(B, m * m) @ M
        else:
            s = _perm_scores(distf, rng.fold_in(keys, k), asize, bsize, chunk, bitgen)
        s64 = s.to(torch.float64)
        out[i, 0] = s64.sum(dim=-1)
        out[i, 1] = (s64 * s64).sum(dim=-1)
        out[i, 2] = (s64 * s64 * s64).sum(dim=-1)
    return out


def null_power_sums(
    dist: torch.Tensor,     # [B, m, m]
    keys: torch.Tensor,     # [2] run-level key (shared) or [B, 2] window keys
    asize: int,
    bsize: int,
    chunk: int,
    k0: int,
    n_chunks: int,
    stream: str = "shared",
    bitgen: str = "mix",
) -> torch.Tensor:
    """Power sums of the permutation null per chunk: [n_chunks, 3, B]
    float64, rows (sum s, sum s^2, sum s^3) over the float32 scores of
    chunks ``k0 .. k0+n_chunks-1`` (``perm.py:_null_power_sums``).  K9
    on a CUDA ``dist``, the plain version on a CPU one."""
    if stream not in STREAMS:
        raise ValueError(f"stream must be one of {STREAMS}, got {stream!r}")
    gen = _check_bitgen(bitgen)
    if is_cpu(dist):
        return null_power_sums_plain(dist, keys, asize, bsize, chunk, k0, n_chunks,
                                     stream, bitgen)
    dev = dist.device
    B, m = dist.shape[0], dist.shape[-1]
    distf = _flat_f32(dist, "css_mc_power")
    out = torch.empty((n_chunks, 3, B), dtype=torch.float64, device=dev)
    if B == 0 or n_chunks == 0:
        return out
    if stream == "shared":
        M = coeff_range(keys, k0, n_chunks, m, asize, bsize, chunk, dev, bitgen)
        cs = chunk_stride(chunk)
        tiles = -(-cs // TILE_COLUMNS)
        partial = torch.empty((n_chunks, tiles, 3, B), dtype=torch.float64, device=dev)
        launch(
            LAUNCHES, "css_mc_power", "css_mc_power_shared", dev,
            ptr(distf), B, m, ptr(M), n_chunks, chunk, cs, ptr(partial), ptr(out),
        )
    else:
        wk = _window_key_words(keys, dev)
        between, ca, cb = _coeff_constants(asize, bsize)
        launch(
            LAUNCHES, "css_mc_power", "css_mc_power_window", dev,
            ptr(distf), ptr(wk), B, m, asize, k0, n_chunks, chunk, gen,
            ctypes.c_float(between), ctypes.c_float(ca), ctypes.c_float(cb), ptr(out),
        )
    return out


def _pearson3_tail(scores, s1, s2, s3, n):
    """Upper-tail p under a Pearson-III fit to power sums (host, scipy)."""
    from scipy import stats as sstats

    mean = s1 / n
    var = np.maximum(s2 / n - mean**2, 1e-30)
    mu3 = s3 / n - 3 * mean * var - mean**3
    sd = np.sqrt(var)
    skew = mu3 / np.maximum(sd**3, 1e-30)
    z = (scores - mean) / sd

    small = np.abs(skew) < 1e-3
    p = np.empty(len(scores))
    p[small] = sstats.norm.sf(z[small])
    big = ~small
    if big.any():
        a = 4.0 / (skew[big] ** 2)
        pos = skew[big] > 0
        # X = (Z * sign) * sqrt(a) + a  ~ Gamma(a, 1) under Pearson III
        zz = np.where(pos, z[big], -z[big])
        x = zz * np.sqrt(a) + a
        tail_hi = sstats.gamma.sf(np.maximum(x, 0.0), a)
        tail_lo = sstats.gamma.cdf(np.maximum(x, 0.0), a)
        p[big] = np.where(pos, tail_hi, tail_lo)
        # beyond the distribution's support bound, the tail is 0/1
        p[big] = np.where(x <= 0.0, np.where(pos, 1.0, 0.0), p[big])
    return np.clip(p, 1e-300, 1.0)


def _approx(power, scores, B, chunk, n_chunks, stable_log10, max_rounds) -> McResult:
    """The drift and escalation loop of ``perm.py:approx_significance``
    (host): power(rows, k0, n) gives the [n, 3, len(rows)] power sums of
    chunks k0 .. k0+n-1 for the windows ``rows`` (one device-to-host copy
    each).  A window whose half-sample and full-sample fits differ by more
    than ``stable_log10`` in log10 p extends its stream from chunk
    ``k_done`` by ``k_done`` chunks, up to ``max_rounds`` times."""
    scores = np.asarray(scores, dtype=np.float64)
    pvals = np.zeros(B)
    nsc = np.zeros(B, dtype=np.int64)

    def _drift(sc, half, n_half, tot, n_tot):
        p_full = _pearson3_tail(sc, tot[0], tot[1], tot[2], n_tot)
        p_half = _pearson3_tail(sc, half[0], half[1], half[2], n_half)
        return p_full, np.abs(np.log10(p_full) - np.log10(p_half))

    per_chunk = power(np.arange(B), 0, n_chunks)             # [K0, 3, B]
    tot = per_chunk.sum(axis=0)
    half_k = max(n_chunks // 2, 1)
    half = per_chunk[:half_k].sum(axis=0)
    k_done = n_chunks
    p_full, drift = _drift(scores, half, half_k * chunk, tot, k_done * chunk)
    pvals[:] = p_full
    nsc[:] = k_done * chunk
    active = np.nonzero(drift > stable_log10)[0]
    for _round in range(max_rounds):
        if len(active) == 0:
            break
        new = power(active, k_done, k_done)                  # [k_done, 3, A]
        half2 = tot[:, active]                               # first half = old
        tot2 = half2 + new.sum(axis=0)
        p2, d2 = _drift(scores[active], half2, k_done * chunk, tot2, 2 * k_done * chunk)
        pvals[active] = p2
        nsc[active] = 2 * k_done * chunk
        tot[:, active] = tot2
        drift[active] = d2
        k_done *= 2
        active = active[drift[active] > stable_log10]
    return McResult(pvals=pvals, nscores=nsc, hits=np.zeros(B, dtype=np.int64))


def _approx_dispatch(sums_fn, dist, scores, asize, bsize, key, chunk, chroms, slots,
                     n_chunks, stable_log10, max_rounds, bitgen, stream) -> McResult:
    B = dist.shape[0]
    keys = _stream_keys(key, B, chroms, slots, stream, dist.device)
    if B == 0:
        z = np.zeros(0)
        return McResult(pvals=z, nscores=z.astype(np.int64), hits=z.astype(np.int64))

    def power(rows, k0, n):
        if len(rows) == B:
            d, ks = dist, keys
        else:
            idx = torch.from_numpy(rows).to(dist.device)
            d, ks = dist[idx], keys if stream == "shared" else keys[idx]
        out = sums_fn(d, ks, asize, bsize, chunk, k0, n, stream, bitgen)
        return out.cpu().numpy()

    return _approx(power, scores, B, chunk, n_chunks, stable_log10, max_rounds)


def approx_significance(
    dist: torch.Tensor,     # [B, m, m]
    scores,                 # [B] observed CSS (float64)
    asize: int,
    bsize: int,
    key: torch.Tensor,      # [2] run-level MC key
    chunk: int = 1024,
    chroms=None,
    slots=None,
    n_chunks: int = 2,
    stable_log10: float = 0.5,
    max_rounds: int = 3,
    bitgen: str = "mix",
    stream: str = "shared",
    sharding=None,          # a parallel.make_mesh tuple: one share per device
) -> McResult:
    """Pearson-III (moment-fitted) permutation p-values
    (``perm.py:approx_significance``): the first three moments of each
    window's null from ``n_chunks`` chunks of its permutations, the tail
    from scipy, escalation as :func:`_approx` says.  ``nscores`` records
    the permutations spent; ``hits`` is 0.  K9 on a CUDA ``dist``, the
    plain power sums on a CPU one.  With ``sharding`` each device takes a
    contiguous share of the windows (escalation is per window)."""
    if sharding is not None:
        return _over_shares(
            sharding, dist, scores, chroms, slots,
            lambda d, sc, ch, sl: approx_significance(
                d, sc, asize, bsize, key, chunk, ch, sl, n_chunks, stable_log10,
                max_rounds, bitgen, stream,
            ),
        )
    return _approx_dispatch(null_power_sums, dist, scores, asize, bsize, key, chunk,
                            chroms, slots, n_chunks, stable_log10, max_rounds, bitgen,
                            stream)


def approx_significance_plain(
    dist: torch.Tensor,
    scores,
    asize: int,
    bsize: int,
    key: torch.Tensor,
    chunk: int = 1024,
    chroms=None,
    slots=None,
    n_chunks: int = 2,
    stable_log10: float = 0.5,
    max_rounds: int = 3,
    bitgen: str = "mix",
    stream: str = "shared",
) -> McResult:
    """:func:`approx_significance` with the plain power sums on any device
    (the twin a card run is held against)."""
    return _approx_dispatch(null_power_sums_plain, dist, scores, asize, bsize, key,
                            chunk, chroms, slots, n_chunks, stable_log10, max_rounds,
                            bitgen, stream)


# ------------------------------------------------------- the sharded step's chunk


def permutation_chunk_plain(dist, scores, need, limit, keys, asize, bsize, chunk,
                            bitgen: str = "mix"):
    """Plain torch version of :func:`permutation_chunk`: :func:`_perm_scores`
    and the ``counted``/``cumsum``/``argmax`` epilogue of
    ``perm.py:permutation_chunk``."""
    dev = dist.device
    B = dist.shape[0]
    need = torch.as_tensor(need).to(dev, torch.int64)
    if B == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, z >= need, z.clone()
    new = _perm_scores(dist.to(torch.float32), keys.to(dev, torch.int64), asize, bsize,
                       chunk, bitgen)
    obs = torch.as_tensor(scores).to(dev).to(torch.float32)
    counted = torch.arange(chunk, device=dev)[None, :] < int(limit)
    hit = (new >= obs[:, None]) & counted
    cum = torch.cumsum(hit.to(torch.int32), dim=-1, dtype=torch.int32)
    total = cum[:, -1]
    pos = torch.argmax((cum >= need[:, None]).to(torch.int8), dim=-1)
    return total, total >= need, pos.to(torch.int32)


def permutation_chunk(
    dist: torch.Tensor,     # [B, m, m] distances (scored in float32)
    scores: torch.Tensor,   # [B] observed CSS (compared in float32)
    need: torch.Tensor,     # [B] hits still needed to reach the threshold
    limit: int,             # permutations of the chunk that count: K < limit
    keys: torch.Tensor,     # [B, 2] window keys, used as given (no chunk fold)
    asize: int,
    bsize: int,
    chunk: int,
    bitgen: str = "mix",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fixed-shape chunk of the null per window
    (``perm.py:permutation_chunk``): (chunk_hits [B] int32, reached [B]
    bool, pos [B] int32), ``pos`` the 0-based in-chunk index of the
    permutation that delivered the ``need``-th hit (0 where it is not
    reached).  K11 on a CUDA ``dist`` (m <= 64), the plain version on a
    CPU one."""
    gen = _check_bitgen(bitgen)
    if is_cpu(dist):
        return permutation_chunk_plain(dist, scores, need, limit, keys, asize, bsize,
                                       chunk, bitgen)
    dev = dist.device
    B = dist.shape[0]
    distf = _flat_f32(dist, "css_perm_chunk")
    obs = torch.as_tensor(scores).to(dev).to(torch.float32).contiguous()
    need_d = torch.as_tensor(need).to(dev, torch.int32).contiguous()
    wk = _window_key_words(keys, dev)
    hits = torch.empty(B, dtype=torch.int32, device=dev)
    reached = torch.empty(B, dtype=torch.bool, device=dev)
    pos = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return hits, reached, pos
    between, ca, cb = _coeff_constants(asize, bsize)
    launch(
        LAUNCHES, "css_perm_chunk", "css_perm_chunk", dev,
        ptr(distf), ptr(obs), ptr(need_d), ptr(wk), B, asize + bsize, asize, chunk,
        min(int(limit), chunk), gen, ctypes.c_float(between), ctypes.c_float(ca),
        ctypes.c_float(cb), ptr(hits), ptr(reached), ptr(pos),
    )
    return hits, reached, pos
