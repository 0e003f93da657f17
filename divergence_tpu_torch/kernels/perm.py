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
  columns padded to whole 32-bit hit words (:func:`coeff_range`); past
  m = 64, ``css_mc_coeff_block`` ranks each column once and writes the
  same columns from a table of its facts (:func:`coeff_form`);
* ``css_mc_shared`` (K7) — the product ``D_flat[active] @ M`` of a range
  and its hit test, packed into words (:func:`mc_hit_words`);
* ``css_mc_scan``   (K7) — the adaptive stop through a range's hit words,
  the position of the threshold-th hit (:func:`mc_scan`);
* ``css_mc_window`` (K8) — the hits of a range of the window stream,
  packed in K7's words (:func:`mc_window_hit_words`), in float32 (the
  nonzero terms of :func:`_scores_from_ranks`, in its order) or float64
  (``mc_native``'s order); ``css_mc_scan`` then stops each window
  (:func:`mc_window`);
* ``css_mc_power``  (K9) — per-chunk float64 power sums of the permuted
  scores (:func:`null_power_sums`), shared or window stream, for
  :func:`approx_significance`;
* ``css_perm_chunk`` (K11) — one fixed chunk of the window stream per
  window, keys used as given, with a hit target and its stop epilogue in
  the kernel (:func:`permutation_chunk`), the sharded step's MC, on K8's
  device code;
* ``css_mc_window_block``, ``css_mc_power_window_block`` and
  ``css_perm_chunk_block`` — K8, K9's window stream and K11 past m = 64
  (``csrc/css_perm_block.cuh``: a warp ranks each permutation by a bitonic
  sort of its (draw, index) keys, :func:`rank_network`, and each lane
  walks its permutation's a*b + m - 2 nonzero terms in the twin's order,
  :func:`nonzero_walk`), the same hits and sums, at any m;
  :func:`window_form` says which form a panel size takes.

:func:`significance`, :func:`null_power_sums`,
:func:`approx_significance` and :func:`permutation_chunk` launch them on a
CUDA ``dist`` (or raise) and run the plain torch versions on a CPU one.
``sharding=`` (a ``parallel.make_mesh`` tuple) splits the windows of
:func:`significance` and :func:`approx_significance` into contiguous
shares, one per device, all run at once (a host thread and, on CUDA, a
stream a share, as the JAX package's one SPMD program runs every
device's share; approx mode enqueues every share's power sums from one
thread and fits once): every
window's result depends on its own stream and stop only, so the union
equals the unsharded run.  Each stop is per window, so there is no
window batching, padding or two-stage compaction (the JAX
package's ``lax.map`` slices existed for XLA on the TPU); the results are
those of the JAX package's single-pass loop.  The JAX ``perm_form``
("broadcast" / "matmul") scores the same permutations in two float32
layouts; the port has one.  Each launch adds one to :data:`LAUNCHES`.
The host's steps run under spans (``utils/trace.py``): ``mc_keys`` (the
stream keys and observed scores), ``mc_range`` a range of chunks (a
chunk of the plain loops), ``mc_compact`` (its host sync for the windows
still running) and ``mc_fetch`` (the results read back).
The function defaults follow ``CssConfig`` (``stream="shared"``).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import threading

import numpy as np
import torch

from divergence_tpu_torch import rng
from divergence_tpu_torch.kernels._cuda import count, is_cpu, launch, ptr, query_form
from divergence_tpu_torch.kernels.fet import bitonic_network, bitonic_schedule
from divergence_tpu_torch.utils.trace import span

BITGENS = ("mix", "threefry")   # kernel argument: the index in this tuple
STREAMS = ("shared", "window")
# the shared stream's ranges (range_chunks)
_FIRST_RANGE_CHUNKS = 16        # at most: 4096 permutations at chunk 256
_RANGE_FMAS = 1 << 32           # product work a range reaches where it can
# at most this much of M at once: 64 MB held m = 200 to one chunk a range
# (16 blocks of product, 79 ranges, 441 ms against 82 at 1 GB on 997
# windows x 20,000; tests/measure_large_panels.py)
_RANGE_COEFF_BYTES = 1 << 30
_RANGE_HIT_BYTES = 256 << 20    # at most this much of hit words at once
WORD_BITS = 32                  # a chunk's columns are padded to whole words
TILE_COLUMNS = 128              # columns of a product tile (csrc permk::kTC)
# [b, m, m, K] elements per step of the window-stream twins, by device type
_PLAIN_BATCH_ELEMS = {"cpu": 1 << 24, "cuda": 1 << 28}

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES = {"css_mc_coeff": 0, "css_mc_coeff_block": 0, "css_mc_shared": 0,
            "css_mc_scan": 0, "css_mc_window": 0, "css_mc_power": 0, "css_perm_chunk": 0,
            "css_mc_window_block": 0, "css_mc_power_window_block": 0,
            "css_perm_chunk_block": 0}
# css_mc_coeff and css_mc_coeff_block launches by bitgen
COEFF_LAUNCHES = {name: 0 for name in BITGENS}
# K9's launches by stream (LAUNCHES["css_mc_power"] counts both streams to
# m = 64, LAUNCHES["css_mc_power_window_block"] the window stream past it)
POWER_LAUNCHES = {name: 0 for name in STREAMS}


def reset_launches() -> None:
    for counts in (LAUNCHES, COEFF_LAUNCHES, POWER_LAUNCHES):
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
    package's bit for bit; K8 adds the nonzero ones in the same order."""
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


# the large-panel body's rank network (csrc/css_perm_block.cuh): keys
# (x << 16) | j padded to RANK_KEYS_MIN or the power of two >= m with a key
# above every real one
RANK_KEYS_MIN = 128
RANK_PAD_KEY = (0xFFFFFFFF << 16) | 0xFFFF


def rank_keys(m: int) -> int:
    """Keys of the rank network at panel size m: the power of two >= m, at
    least RANK_KEYS_MIN (``csrc/css_perm_block.cuh:sort_keys``)."""
    p = RANK_KEYS_MIN
    while p < m:
        p *= 2
    return p


def _draw_words(keys: torch.Tensor, chunk: int, m: int, bitgen: str) -> torch.Tensor:
    """[B, chunk, m] int64: the uint32 words the kernels rank, the mix32
    words or threefry's 23 mantissa bits of each float32 uniform (equal
    floats are equal words)."""
    _check_bitgen(bitgen)
    if bitgen == "mix":
        x = rng.mix_bits(keys, chunk * m)
    else:
        x = rng.uniform_bits32(keys, chunk * m) >> 9
    return x.reshape(keys.shape[0], chunk, m)


def network_ranks(x: torch.Tensor) -> torch.Tensor:
    """Ranks [..., m] of the words x [..., m] (uint32 in int64) by the
    large-panel body's sort: the keys (x_j << 16) | j, padded with
    RANK_PAD_KEY to p = max(128, 2^ceil(log2 m)), through the bitonic
    network of ``kernels/fet.py:bitonic_schedule`` (stage (k, j): the
    comparator (g, g ^ j) ascending iff (g & k) == 0); the slot a key lands
    in is its individual's rank.  The keys are distinct, so the ranks are
    the stable order's with ties broken by the index (:func:`_ranks`)."""
    m = x.shape[-1]
    p = rank_keys(m)
    lead = x.shape[:-1]
    k = torch.full((*lead, p), RANK_PAD_KEY, dtype=torch.int64, device=x.device)
    k[..., :m] = (x.to(torch.int64) << 16) | torch.arange(m, device=x.device)
    srt = bitonic_network(k.reshape(-1, p), bitonic_schedule(p, None))
    idx = srt[:, :m] & 0xFFFF
    r = torch.empty((idx.shape[0], m), dtype=torch.int64, device=x.device)
    r.scatter_(1, idx, torch.arange(m, device=x.device).expand_as(idx))
    return r.reshape(*lead, m)


def rank_network(keys: torch.Tensor, chunk: int, m: int, bitgen: str = "mix") -> torch.Tensor:
    """:func:`_ranks` [B, m, K] as the large-panel body computes them
    (:func:`network_ranks` of each permutation's draws)."""
    return network_ranks(_draw_words(keys, chunk, m, bitgen)).transpose(-1, -2)


def coeff_facts(r: torch.Tensor, asize: int, bsize: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's large-panel table of facts (``csrc/css_mc.cu:css_mc_coeff_rank``)
    of the ranks r [m, K] of K columns: (fact [m, K] int64, u [m, K] bool)
    with fact_j = succ_j | cls_j << 16 (succ_j the individual of rank r_j
    + 1, 0xFFFF for none; cls_j 1 on the a-chain, 2 on the b-chain, else 0)
    and u_j = r_j < a."""
    m = asize + bsize
    order = torch.empty_like(r)
    order.scatter_(0, r, torch.arange(m, device=r.device)[:, None].expand_as(r))
    succ = torch.where(r + 1 < m, order.gather(0, (r + 1).clamp(max=m - 1)), 0xFFFF)
    cls = torch.where(r < asize - 1, 1, torch.where((r >= asize) & (r < m - 1), 2, 0))
    return succ | (cls << 16), r < asize


def coeff_from_facts(fact: torch.Tensor, u: torch.Tensor, asize: int,
                     bsize: int) -> torch.Tensor:
    """M [m*m, K] float32 from :func:`coeff_facts` as K7's write pass
    (``css_mc_coeff_write``) builds it: row j*m + l of column c is
    (u_l ? 0 : (u_j ? 1/(ab) : 0)) - (l == succ_j ? cw_j : 0), one float32
    subtraction; a padding column (u = 0, no successor) gives +0.0."""
    m = asize + bsize
    between, ca, cb = _coeff_constants(asize, bsize)
    f32 = torch.float32
    bet = torch.where(u, torch.tensor(between, dtype=f32), torch.tensor(0.0, dtype=f32))
    cls = fact >> 16
    cw = torch.where(cls == 1, torch.tensor(ca, dtype=f32),
                     torch.where(cls == 2, torch.tensor(cb, dtype=f32),
                                 torch.tensor(0.0, dtype=f32)))
    succ = fact & 0xFFFF
    ell = torch.arange(m, device=fact.device)[None, :, None]            # [1, l, 1]
    b = torch.where(u[None, :, :], torch.tensor(0.0, dtype=f32), bet[:, None, :])
    chain = torch.where(ell == succ[:, None, :], cw[:, None, :], torch.tensor(0.0, dtype=f32))
    return (b - chain).reshape(m * m, -1)


def nonzero_walk(distf: torch.Tensor, r: torch.Tensor, asize: int, bsize: int) -> torch.Tensor:
    """CSS [B, K] float32 of the ranks r [B, m, K] against distf [B, m, m]
    as the large-panel body's lanes add them (``csrc/css_perm_block.cuh``
    walk_f32), each permutation a lane: the a-rows in index order, before
    each the b-rows of smaller index (one chain term each, D * -(a+b) w_b,
    where the rank successor is in the b-group), and in an a-row the
    b-group columns by index (D * 1/(ab)) with the star term (D * -(a+b)
    w_a, its rank successor in the a-group) at p = #{b-group index <
    star}; every product rounded, then added in float32.  These are
    :func:`_scores_from_ranks`' nonzero terms in its order, so the sums are
    its sums.  A window with a non-finite entry scores NaN: the kernels
    flag it while staging it (K8 and K11 give it no hits, K9 NaN sums, as
    the twin's NaN sums do)."""
    B, m, K = r.shape
    dev = distf.device
    between, ca, cb = (torch.tensor(v, dtype=torch.float32, device=dev)
                       for v in _coeff_constants(asize, bsize))
    lanes = r.permute(0, 2, 1).reshape(B * K, m)                    # [N, m]
    D = distf.to(torch.float32).repeat_interleave(K, dim=0).reshape(B * K, m * m)
    n = torch.arange(B * K, device=dev)
    idx = torch.arange(m, device=dev)
    isb = lanes >= asize
    grp = torch.argsort(isb.to(torch.int64) * m + idx, dim=1)      # a-group, then b, by index
    AL, BL = grp[:, :asize], grp[:, asize:]
    order = torch.empty_like(lanes)
    order.scatter_(1, lanes, idx.expand_as(lanes))
    nxt = order.gather(1, (lanes + 1).clamp(max=m - 1))
    succ = torch.where(lanes + 1 < torch.where(isb, m, asize), nxt, -1)
    AS, BS = succ.gather(1, AL), succ.gather(1, BL)
    bbefore = torch.cumsum(isb.to(torch.int64), dim=1) - isb.to(torch.int64)

    def d(j, l):
        return D[n, j * m + l]

    acc = torch.zeros(B * K, dtype=torch.float32, device=dev)
    sb = torch.zeros(B * K, dtype=torch.int64, device=dev)

    def b_rows(upto):
        nonlocal acc, sb
        while True:
            go = sb < upto
            if not bool(go.any()):
                return
            s = sb.clamp(max=bsize - 1)
            jb, nx = BL[n, s], BS[n, s]
            has = go & (nx >= 0)
            acc = torch.where(has, acc + d(jb, nx.clamp(min=0)) * -cb, acc)
            sb = sb + go.to(torch.int64)

    for i in range(asize):
        j = AL[:, i]
        b_rows(j - i)
        star = AS[:, i]
        has = star >= 0
        sterm = d(j, star.clamp(min=0)) * -ca
        p = torch.where(has, bbefore[n, star.clamp(min=0)], -1)
        for s in range(bsize):
            v = d(j, BL[:, s]) * between
            acc = torch.where(p == s, acc + sterm, acc)
            acc = acc + v
        acc = torch.where(p == bsize, acc + sterm, acc)
    b_rows(torch.full_like(sb, bsize))
    finite = torch.isfinite(distf).reshape(B, -1).all(dim=1).repeat_interleave(K)
    acc = torch.where(finite, acc, float("nan"))
    return acc.reshape(B, K)


def shared_coeff_plain(key, k0, nk, m, asize, bsize, chunk, device,
                       bitgen: str = "mix") -> torch.Tensor:
    """Plain torch version of :func:`shared_coeff`."""
    key = key.to(device)
    return torch.cat(
        [_shared_coeff(key, k, m, asize, bsize, chunk, bitgen)
         for k in range(k0, k0 + nk)],
        dim=1,
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
    cs = chunk_stride(chunk)
    out = torch.empty((m * m, nk * cs), dtype=torch.float32, device=device)
    between, ca, cb = _coeff_constants(asize, bsize)
    k0w, k1w = (int(w) for w in key.tolist())
    args = (ctypes.c_uint32(k0w), ctypes.c_uint32(k1w), k0, nk, chunk, cs, m, asize, gen,
            ctypes.c_float(between), ctypes.c_float(ca), ctypes.c_float(cb))
    form, words = _coeff_form(m, nk * cs, device)
    if form == "thread":
        launch(LAUNCHES, "css_mc_coeff", "css_mc_coeff", device, *args, ptr(out))
    else:
        scratch = torch.empty(words, dtype=torch.int32, device=device)
        launch(LAUNCHES, "css_mc_coeff_block", "css_mc_coeff_block", device, *args,
               ptr(scratch), ptr(out))
    count(COEFF_LAUNCHES, bitgen)
    return out


def coeff_form(m: int, device: torch.device | None = None) -> str:
    """The kernel :func:`coeff_range` launches at panel size m on
    ``device``, by the kernel library's own reckoning
    (``csrc/css_mc.cu:css_mc_coeff_form``): ``"thread"``
    (``css_mc_coeff``, a column a thread, m <= 64) or ``"block"``
    (``css_mc_coeff_block``: each column ranked once by a warp into a
    table of per-individual facts in device scratch, then M written 16
    bytes a lane from it)."""
    return _coeff_form(m, WORD_BITS, device)[0]


def _coeff_form(m, ncols, device):
    return query_form(("thread", "block"), "css_mc_coeff_form", device, m, ncols)


def shared_coeff(key, k0, nk, m, asize, bsize, chunk, device,
                 bitgen: str = "mix") -> torch.Tensor:
    """:func:`coeff_range` without the padding: [m*m, nk*chunk], column
    ``(k - k0)*chunk + K`` equal to column K of ``_shared_coeff(key, k)``."""
    M = coeff_range(key, k0, nk, m, asize, bsize, chunk, device, bitgen)
    return M.reshape(m * m, nk, -1)[:, :, :chunk].reshape(m * m, nk * chunk)


# TF32 is one setting of the process, and the shares of a sharded MC run
# _full_f32_matmul from threads of their own: the first to enter saves
# and clears it, the last to leave restores it
_F32_LOCK = threading.Lock()
_f32_users = 0
_f32_saved = False


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 products in full float32 on CUDA (no TF32), whatever the
    caller's setting: the hits compare float32 scores."""
    global _f32_users, _f32_saved
    with _F32_LOCK:
        if _f32_users == 0:
            _f32_saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _f32_users += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _f32_users -= 1
            if _f32_users == 0:
                torch.backends.cuda.matmul.allow_tf32 = _f32_saved


def _product_f32(rows: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """``rows`` [b, K] @ ``M`` [K, C] in full float32, each row's result
    the same whatever the other rows (the shares of a sharded MC cut the
    batch elsewhere than one share would): a BLAS multiplies a single row
    by its matrix-vector path, whose sums run in another order than its
    matrix product's (MKL's), so one row goes in as two."""
    with _full_f32_matmul():
        if rows.shape[0] == 1:
            return (torch.cat([rows, rows]) @ M)[:1]
        return rows @ M


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


def _mc_loop(B, dev, chunk, runs, threshold, chunk_hits_of, ranges=None):
    """The host-driven chunk loop shared by the plain MCs: chunk_hits_of(k,
    rows) gives hit [len(rows), chunk] for the windows still running;
    stops once every window is done.  ``ranges``, if given, gets each
    chunk as a range of one chunk, as :func:`mc_shared` gives its ranges.
    Returns (pvals, nscores, hits)."""
    hits = torch.zeros(B, dtype=torch.int64, device=dev)
    nsc = torch.zeros(B, dtype=torch.int64, device=dev)
    active = torch.arange(B, device=dev)
    for k in range((runs + chunk - 1) // chunk):
        if active.numel() == 0:
            break
        with span("mc_range"):
            h, n, reached = _chunk_update(
                chunk_hits_of(k, active), k, chunk, runs, threshold, hits[active], nsc[active]
            )
            hits[active] = h
            nsc[active] = n
            if ranges is not None:
                ranges.append((k, 1, active.numel()))
            with span("mc_compact"):
                active = active[~reached]
    with span("mc_fetch"):
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
    ranges: list | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Plain torch version of the float32 MC (``perm.py:mc_significance``):
    a host-driven chunk loop with the same ``counted``/``cum``/``need``/
    ``pos`` arithmetic, on ``dist``'s device, carrying only the windows
    still running (each window's result depends on its own stream only).
    ``ranges`` as in :func:`_mc_loop`.  Returns (pvals float64, nscores,
    hits) as numpy arrays."""
    dev = dist.device
    B, m = dist.shape[0], dist.shape[-1]
    distf = dist.to(torch.float32)
    obs = _observed_f32(scores, dev)
    key = key.to(dev)
    if stream == "shared":
        flat = distf.reshape(B, m * m)

        def chunk_hits(k, rows):
            M = _shared_coeff(key, k, m, asize, bsize, chunk, bitgen)
            return _product_f32(flat[rows], M) >= obs[rows, None]
    elif stream == "window":
        def chunk_hits(k, rows):
            s = _perm_scores(distf[rows], rng.fold_in(key[rows], k), asize, bsize,
                             chunk, bitgen)
            return s >= obs[rows, None]
    else:
        raise ValueError(f"stream must be one of {STREAMS}, got {stream!r}")
    return _mc_loop(B, dev, chunk, runs, threshold, chunk_hits, ranges)


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
    ranges: list | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Plain torch version of ``perm_backend="native"``
    (``native/mc_native.cpp:mc_native``): the window stream with ``mix``
    draws, float32 distances widened to float64, scored by
    :func:`_native_scores`, a hit when the score is ``>=`` the float32
    observed score widened to float64.  ``ranges`` as in :func:`_mc_loop`.
    Returns (pvals, nscores, hits)."""
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

    return _mc_loop(B, dev, chunk, runs, threshold, chunk_hits, ranges)


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
    s = _product_f32(flat[active], M).reshape(-1, nk, cs)
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


def _nth_hit(w: torch.Tensor, need: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(total, pos) of the words w [A, wpc] (int64 holding uint32 bits),
    word by word as the kernels go: the set bits, and the 0-based index of
    the need-th one, found from the first word whose running count reaches
    ``need`` and the set bit within it that does (0 where need <= 0; any
    value where the words hold fewer than ``need``)."""
    bit = torch.arange(WORD_BITS, device=w.device)
    pc = _popcount32(w)
    cum = torch.cumsum(pc, dim=1)
    q = torch.argmax((cum >= need[:, None]).to(torch.int8), dim=1)
    before = (cum - pc).gather(1, q[:, None])[:, 0]
    word = w.gather(1, q[:, None])[:, 0]
    inword = torch.cumsum((word[:, None] >> bit) & 1, dim=1)
    b = torch.argmax((inword >= (need - before)[:, None]).to(torch.int8), dim=1)
    return cum[:, -1], torch.where(need <= 0, 0, q * WORD_BITS + b)


def mc_scan_plain(words, active, k0, chunk, runs, threshold, hits, nsc, done) -> None:
    """Plain torch version of :func:`mc_scan`, word by word as the kernel
    goes (:func:`_nth_hit` on each chunk's words)."""
    nk = words.shape[1]
    w = words.to(torch.int64) & 0xFFFFFFFF                     # [A, nk, wpc]
    h, n, d = hits[active].long(), nsc[active].long(), done[active] != 0
    for kk in range(nk):
        offset = (k0 + kk) * chunk
        need = threshold - h
        total, pos = _nth_hit(w[:, kk], need)
        reached = ~d & (total >= need)
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


def range_chunks(k: int, n_chunks: int, nact: int, mm: int, chunk: int,
                 per_perm: int | None = None) -> int:
    """Chunks of the range that starts at chunk ``k`` with ``nact``
    windows running.  A range costs nact x nk*chunk x ``per_perm`` (the
    shared stream's product: mm FMAs a permutation) and every running
    window pays for all of it, though it may stop in the first chunk; each
    range ends with one host sync.  So a range takes as many chunks as
    came before it (a window that stops inside pays at most as much again
    as it consumed) and at least enough for ``_RANGE_FMAS`` of work (the
    sync stays small beside it), the first at most
    ``_FIRST_RANGE_CHUNKS``; and never more M (``mm`` > 0: the shared
    stream's coefficients) than ``_RANGE_COEFF_BYTES`` or hit words than
    ``_RANGE_HIT_BYTES`` (one chunk at least)."""
    cs = chunk_stride(chunk)
    nact = max(nact, 1)
    cost = mm if per_perm is None else per_perm
    want = max(k, _RANGE_FMAS // (nact * cost * chunk))
    if k == 0:
        want = min(want, _FIRST_RANGE_CHUNKS)
    cap = _RANGE_HIT_BYTES // (nact * cs // 8)
    if mm:
        cap = min(cap, _RANGE_COEFF_BYTES // (4 * mm * cs))
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
        with span("mc_range"):
            nk = range_chunks(k, n_chunks, active.numel(), mm, chunk)
            M = coeff_range(key, k, nk, m, asize, bsize, chunk, dev, bitgen)
            words = mc_hit_words(distf, obs, active, M, k, nk, chunk, runs)
            mc_scan(words, active, k, chunk, runs, threshold, hits, nsc, done)
            if ranges is not None:
                ranges.append((k, nk, active.numel()))
            k += nk
            if k < n_chunks:
                with span("mc_compact"):
                    active = active[done[active] == 0]
    return nsc, hits


def _flat_f32(dist: torch.Tensor, kernel: str) -> torch.Tensor:
    """[B, m*m] contiguous float32 distances for a kernel."""
    B, m = dist.shape[0], dist.shape[-1]
    if dist.dim() != 3 or dist.shape[1] != m:
        raise ValueError(f"{kernel} takes [B, m, m] distances, got {tuple(dist.shape)}")
    return dist.to(torch.float32).reshape(B, m * m).contiguous()


def window_form(m: int, native: bool = False,
                device: torch.device | None = None) -> str:
    """The form K8 (``native``: its float64 form), K11 and K9's window
    stream take at panel size m on ``device``, by the kernel library's own
    reckoning (``csrc/css_mc_window.cu:css_mc_window_form``): ``"register"``
    (the small forms, m <= 64), or the large-panel body's: ``"shared"`` (the
    window's D and sixteen warps' 8-bit tables in a block's shared
    memory: m <= 128 float32 / 184 float64 on an H100), ``"split"`` (D
    there, the tables in device scratch: to m = 232 / 239) or ``"device"``
    (D read in place, 16-bit tables in device scratch)."""
    return _window_form(m, native, device)[0]


def _window_form(m, native, device):
    return query_form(("register", "shared", "split", "device"), "css_mc_window_form", device,
                      m, int(native))


def _block_scratch(m: int, native: bool, dev: torch.device):
    """(form, device scratch or None) of a launch at panel size m, as the
    kernel library's :func:`window_form` says."""
    name, nbytes = _window_form(m, native, dev)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if name in ("split", "device") else None)
    return name, scratch


def _window_key_words(wkeys: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """[B, 2] int64 key words on the card, contiguous, for the kernels."""
    if wkeys.dim() != 2 or wkeys.shape[1] != 2:
        raise ValueError(f"window keys must be [B, 2], got {tuple(wkeys.shape)}")
    return wkeys.to(device=dev, dtype=torch.int64).contiguous()


def window_perm_cost(m: int, asize: int, bitgen: str = "mix") -> int:
    """Operations of one window-stream permutation in the body K8 runs at
    panel size m, the unit of :func:`range_chunks` (an FMA of the shared
    stream's product): m draws (two mix32, ~12 integer operations each, or
    a threefry-2x32, ~70), the ranks, and a*b + m - 2 float32
    multiply-adds.  The small forms (m <= 64) rank by m(m-1) compares and
    adds, the large-panel body by a bitonic sort of :func:`rank_keys` keys
    (p/2 log2 p (log2 p + 1) / 2 compares)."""
    draws = (70 if bitgen == "threefry" else 12) * m
    if m <= 64:
        ranks = 2 * m * (m - 1)
    else:
        p = rank_keys(m)
        lg = p.bit_length() - 1
        ranks = p // 2 * lg * (lg + 1) // 2
    return draws + ranks + 2 * (asize * (m - asize) + m - 2)


def mc_window_hit_words_plain(distf, obs, keys, active, k0, nk, asize, bsize, chunk,
                              runs, bitgen: str = "mix", native: bool = False):
    """Plain torch version of :func:`mc_window_hit_words`: each chunk's
    scores by :func:`_perm_scores` (float32) or :func:`_native_scores`
    (float64), the hit test, the words packed per chunk."""
    dev = distf.device
    m = asize + bsize
    cs = chunk_stride(chunk)
    A = active.numel()
    D = distf[active].reshape(A, m, m)
    o = obs[active]
    ks = keys[active]
    if native:
        D64 = D.to(torch.float64)
        rowtot = _row_totals(D64)
    hit = torch.zeros((A, nk, cs), dtype=torch.bool, device=dev)
    for kk in range(nk):
        ck = rng.fold_in(ks, k0 + kk)
        if native:
            s = _native_scores(D64, rowtot, _ranks(ck, chunk, m, "mix"), asize, bsize)
            h = s >= o.to(torch.float64)[:, None]
        else:
            h = _perm_scores(D, ck, asize, bsize, chunk, bitgen) >= o[:, None]
        counted = (k0 + kk) * chunk + torch.arange(chunk, device=dev) < runs
        hit[:, kk, :chunk] = h & counted[None, :]
    return _pack_words(hit)


def mc_window_hit_words(
    distf: torch.Tensor,    # [B, m*m] float32 distances
    obs: torch.Tensor,      # [B] float32 observed scores
    keys: torch.Tensor,     # [B, 2] int64 window keys
    active: torch.Tensor,   # [A] int64 rows taking part
    k0: int,
    nk: int,
    asize: int,
    bsize: int,
    chunk: int,
    runs: int,
    bitgen: str = "mix",
    native: bool = False,
) -> torch.Tensor:
    """The hits of a range of the window stream (K8 ``css_mc_window``):
    int32 words [A, nk, cs/32] in :func:`mc_hit_words`' layout, bit b of
    word q of chunk kk set where permutation K = 32 q + b of chunk k0 + kk
    of window ``active[a]``'s stream counts (K < chunk, (k0 + kk)*chunk +
    K < runs) and scores ``>=`` its observed score: float32 scores of the
    ``bitgen`` draws, or (``native``) ``mc_native``'s float64 scores of the
    ``mix`` draws against the float32 observed score widened.  The kernel
    on a CUDA ``distf`` (``css_mc_window`` up to m = 64,
    ``css_mc_window_block`` past it, as :func:`window_form` says), the
    plain version on a CPU one."""
    gen = _check_bitgen(bitgen)
    if native and bitgen != "mix":
        raise ValueError("perm_backend='native' replays the 'mix' stream only")
    if is_cpu(distf):
        return mc_window_hit_words_plain(distf, obs, keys, active, k0, nk, asize, bsize,
                                         chunk, runs, bitgen, native)
    m = asize + bsize
    if (distf.dim() != 2 or distf.shape[1] != m * m or distf.dtype != torch.float32
            or not distf.is_contiguous()):
        raise ValueError("css_mc_window takes contiguous float32 [B, m*m] distances")
    if obs.shape != distf.shape[:1] or obs.dtype != torch.float32 or not obs.is_contiguous():
        raise ValueError("css_mc_window takes contiguous float32 [B] observed scores")
    if keys.shape != (distf.shape[0], 2) or keys.dtype != torch.int64 or not keys.is_contiguous():
        raise ValueError("css_mc_window takes contiguous int64 [B, 2] window keys")
    if active.dtype != torch.int64 or not active.is_contiguous():
        raise ValueError("css_mc_window takes contiguous int64 active rows")
    cs = chunk_stride(chunk)
    words = torch.empty((active.numel(), nk, cs // WORD_BITS), dtype=torch.int32,
                        device=distf.device)
    between, ca, cb = _coeff_constants(asize, bsize)
    wa, wb = _chain_weights(asize, bsize)
    args = (ptr(distf), ptr(obs), ptr(keys), ptr(active), active.numel(), m, asize, k0, nk,
            chunk, cs, runs, gen, int(native), ctypes.c_float(between), ctypes.c_float(ca),
            ctypes.c_float(cb), ctypes.c_double(wa), ctypes.c_double(wb),
            ctypes.c_double(1.0 / (asize * bsize)))
    name, scratch = _block_scratch(m, native, distf.device)
    if name == "register":
        launch(LAUNCHES, "css_mc_window", "css_mc_window", distf.device, *args, ptr(words))
    else:
        launch(LAUNCHES, "css_mc_window_block", "css_mc_window_block", distf.device, *args,
               ptr(scratch), ptr(words))
    return words


def mc_window(
    dist: torch.Tensor,    # [B, m, m]
    obs: torch.Tensor,     # [B] float32 observed scores
    wkeys: torch.Tensor,   # [B, 2] window keys
    asize: int,
    bsize: int,
    chunk: int,
    runs: int,
    threshold: int,
    bitgen: str = "mix",
    native: bool = False,
    ranges: list | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The window-stream MC in ranges of chunks (K8): (nscores, hits)
    int32 [B].  For each range (:func:`range_chunks` at
    :func:`window_perm_cost`) the hit words of every running window
    (:func:`mc_window_hit_words`) and the adaptive stop (:func:`mc_scan`,
    K7's), then the running windows are compacted, one host sync per
    range: the results of the single-pass loop.  ``native=True`` scores
    in float64 in ``mc_native``'s order (``mix`` draws only).  The kernels
    on the card, their plain versions on the CPU.  ``ranges``, if given,
    gets (first chunk, chunks, running windows) of each range."""
    dev = dist.device
    B = dist.shape[0]
    m = asize + bsize
    if dist.dim() != 3 or dist.shape[1:] != (m, m):
        raise ValueError(f"css_mc_window takes [B, m, m] distances, got {tuple(dist.shape)}")
    distf = dist.to(torch.float32).reshape(B, m * m).contiguous()
    keys = _window_key_words(wkeys, dev)
    obs = obs.to(device=dev, dtype=torch.float32).contiguous()
    hits = torch.zeros(B, dtype=torch.int32, device=dev)
    nsc = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.uint8, device=dev)
    n_chunks = (runs + chunk - 1) // chunk
    cost = window_perm_cost(m, asize, bitgen)
    active = torch.arange(B, dtype=torch.int64, device=dev)
    k = 0
    while k < n_chunks and active.numel():
        with span("mc_range"):
            nk = range_chunks(k, n_chunks, active.numel(), 0, chunk, per_perm=cost)
            words = mc_window_hit_words(distf, obs, keys, active, k, nk, asize, bsize,
                                        chunk, runs, bitgen, native)
            mc_scan(words, active, k, chunk, runs, threshold, hits, nsc, done)
            if ranges is not None:
                ranges.append((k, nk, active.numel()))
            k += nk
            if k < n_chunks:
                with span("mc_compact"):
                    active = active[done[active] == 0]
    return nsc, hits


@dataclasses.dataclass
class McResult:
    pvals: np.ndarray      # [B]
    nscores: np.ndarray    # [B] permutations consumed
    hits: np.ndarray       # [B]


# a stream per (CUDA device, share index) for the process: the caching
# allocator keeps a freed block for the stream that used it, so a new
# stream a call would leave every earlier call's blocks idle
_SHARE_STREAMS: dict = {}
_SHARE_STREAMS_LOCK = threading.Lock()


def _share_stream(dev: torch.device, i: int):
    with _SHARE_STREAMS_LOCK:
        if (dev, i) not in _SHARE_STREAMS:
            _SHARE_STREAMS[dev, i] = torch.cuda.Stream(dev)
        return _SHARE_STREAMS[dev, i]


def _shares(sharding, B: int) -> list:
    """(index, device, slice) of every share of B windows that holds one."""
    from divergence_tpu_torch.parallel.mesh import window_slices

    return [(i, dev, sl) for i, (dev, sl) in enumerate(zip(sharding, window_slices(B, sharding)))
            if sl.stop > sl.start]


@contextlib.contextmanager
def _on_share(i: int, dev: torch.device, made):
    """On CUDA, the device and share i's stream (:func:`_share_stream`),
    which first waits for ``made`` (the caller's stream, None for no wait);
    yields the stream, or None on the CPU."""
    if is_cpu(dev):
        yield None
        return
    with torch.cuda.device(dev):
        stream = _share_stream(dev, i)
        if made is not None:
            stream.wait_stream(made)
        with torch.cuda.stream(stream):
            yield stream


def _share_inputs(dist, keys, sl, dev, stream, made):
    """The share's rows of ``dist`` and of ``keys`` ([B, 2] window keys;
    the run-level key is every share's) on ``dev``, for use on
    ``stream``."""
    per_window = keys.dim() == 2
    ks = keys[sl] if per_window else keys
    if stream is not None and dist.device == dev:
        d = dist[sl]
        # read on the share's stream: their memory is not reused before
        # that stream is done with it
        for t in (d, ks) if per_window else (d,):
            t.record_stream(stream)
        return d, ks
    with contextlib.ExitStack() as on_source:
        if made is not None:
            # a copy from another card runs on the source's stream
            on_source.enter_context(torch.cuda.stream(made))
        return dist[sl].to(dev), ks.to(dev) if per_window else ks


def _over_shares(sharding, dist, keys, run) -> list:
    """``run(dist, keys, sl)`` on each device's contiguous share ``sl`` of
    the windows (none for an empty share), every share at once in a host
    thread of its own (as ``torch.nn.parallel.parallel_apply`` runs
    DataParallel's replicas), on CUDA under its device and stream
    (:func:`_on_share`), so that a share's syncs wait for its own launches
    only.  ``keys``: the run-level key or [B, 2] window keys, which the
    callers make over the whole batch (:func:`_stream_keys`: its ~100
    small ops, run in every share's thread at once, queue for the
    interpreter lock; four shares of an H100 then launched first at
    77-146 ms against 9-12, ``tests/measure_mc_shares.py``).
    Returns the results in device order.  A share that raises makes the
    call raise its error once every share has ended."""
    made = None if is_cpu(dist) else torch.cuda.current_stream(dist.device)

    def share(i, dev, sl):
        with _on_share(i, dev, made) as stream:
            return run(*_share_inputs(dist, keys, sl, dev, stream, made), sl)

    work = _shares(sharding, dist.shape[0])
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(len(work), 1),
                                               thread_name_prefix="mc-share") as pool:
        futures = [pool.submit(share, *w) for w in work]
    return [f.result() for f in futures]


def _stream_keys(key, B, chroms, slots, stream, dev) -> torch.Tensor:
    """The run-level key on the host (shared: :func:`coeff_range` reads
    its words there every range, so a copy on the card would cost a sync
    a range) or the [B, 2] window keys on ``dev`` (window)."""
    if stream not in STREAMS:
        raise ValueError(f"stream must be one of {STREAMS}, got {stream!r}")
    if stream == "shared":
        return key.cpu()
    key = key.to(dev)
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
    ranges: list | None = None,
) -> McResult:
    """Adaptive permutation p-values for a set of windows
    (``perm.py:significance``): the kernels on a CUDA ``dist``, the plain
    chunk loops on a CPU one.  Window w of the window stream is keyed by
    (chroms[w], slots[w]); ``backend="native"`` needs that stream and
    ``mix`` draws, as in the JAX package.  With ``sharding`` each device
    takes a contiguous share of the windows, every share at once
    (:func:`_over_shares`).  ``ranges``, if given, gets (first chunk,
    chunks, running windows) of every range run, every share's (the
    plain loops' chunks as ranges of one chunk)."""
    with span("mc_keys"):
        keys = _stream_keys(key, dist.shape[0], chroms, slots, stream, dist.device)
    if sharding is None or dist.shape[0] == 0:
        return _significance(dist, scores, keys, asize, bsize, threshold, runs, chunk,
                             backend, bitgen, stream, ranges)
    scores = np.asarray(scores, dtype=np.float64)
    parts = _over_shares(
        sharding, dist, keys,
        lambda d, ks, sl: _significance(d, scores[sl], ks, asize, bsize, threshold, runs,
                                        chunk, backend, bitgen, stream, ranges),
    )
    return McResult(*(np.concatenate([getattr(r, f) for r in parts])
                      for f in ("pvals", "nscores", "hits")))


def _significance(dist, scores, keys, asize, bsize, threshold, runs, chunk, backend, bitgen,
                  stream, ranges=None) -> McResult:
    """:func:`significance` on one device (a share of a sharded call), the
    keys made (:func:`_stream_keys`)."""
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
    if B == 0:
        z = np.zeros(0, dtype=np.int64)
        return McResult(pvals=np.zeros(0), nscores=z, hits=z.copy())
    if is_cpu(dist):
        if backend == "native":
            pv, n, h = mc_native_plain(dist, scores, keys, asize, bsize, chunk,
                                       runs, threshold, ranges)
        else:
            pv, n, h = mc_significance(dist, scores, keys, asize, bsize, chunk, runs,
                                       threshold, stream=stream, bitgen=bitgen,
                                       ranges=ranges)
        return McResult(pvals=pv, nscores=n, hits=h)
    with span("mc_keys"):
        obs = _observed_f32(scores, dist.device)
    if stream == "shared":
        m = dist.shape[-1]
        distf = dist.to(torch.float32).reshape(B, m * m).contiguous()
        nsc, hits = mc_shared(distf, obs, keys, asize, bsize, chunk, runs, threshold,
                              bitgen, ranges)
    else:
        nsc, hits = mc_window(dist, obs, keys, asize, bsize, chunk, runs, threshold,
                              bitgen, native=backend == "native", ranges=ranges)
    with span("mc_fetch"):
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
            s = _product_f32(distf.reshape(B, m * m), M)
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
    on a CUDA ``dist`` (the shared stream at any m; the window stream's
    ``css_mc_power_window`` up to m = 64, on K8's small-panel body with
    the sums in :func:`window_power_order`'s order, and
    ``css_mc_power_window_block`` past it, as :func:`window_form` says),
    the plain version on a CPU one.  Each call adds one to
    :data:`POWER_LAUNCHES` under its stream."""
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
        args = (ptr(distf), ptr(wk), B, m, asize, k0, n_chunks, chunk, gen,
                ctypes.c_float(between), ctypes.c_float(ca), ctypes.c_float(cb))
        name, scratch = _block_scratch(m, False, dev)
        if name == "register":
            launch(LAUNCHES, "css_mc_power", "css_mc_power_window", dev, *args, ptr(out))
        else:
            launch(LAUNCHES, "css_mc_power_window_block", "css_mc_power_window_block", dev,
                   *args, ptr(scratch), ptr(out))
    count(POWER_LAUNCHES, stream)
    return out


# the warps of a K9 window-stream block to m = 64 (csrc/css_mc_window.cu
# kWarps), which its sum order follows
POWER_WARPS = 8


def window_power_order(s: torch.Tensor) -> torch.Tensor:
    """[n_chunks, 3, B] power sums of the float32 scores s [B, n_chunks,
    chunk] (:func:`_perm_scores` or :func:`nonzero_walk` of each chunk) in
    the order K9's window stream adds them to m = 64
    (``csrc/css_mc_window.cu:power_sums``): permutation K on lane K % 32 of
    warp (K // 32) % POWER_WARPS, each lane's s, s*s and (s*s)*s added in
    float64 in word order from +0.0, the xor tree (16, 8, 4, 2, 1) over a
    warp's lanes, then the warps' sums in warp order from +0.0.  Every add
    is a tensor op of its own in that order.  A lane past the chunk adds
    nothing (here it adds +0.0 to a partial that is never -0.0: the same
    bits).  A window with a NaN score gets NaN sums, as the kernel's
    flagged windows do.  For tests: the kernel equals it bit for bit."""
    B, nk, chunk = s.shape
    wpc = -(-chunk // WORD_BITS)
    v = torch.nn.functional.pad(s.to(torch.float64), (0, WORD_BITS * wpc - chunk))
    v = v.reshape(B, nk, wpc, WORD_BITS)
    v2 = v * v
    terms = (v, v2, v2 * v)
    lanes = torch.arange(WORD_BITS, device=s.device)
    out = torch.empty((nk, 3, B), dtype=torch.float64, device=s.device)
    for e, t in enumerate(terms):
        total = torch.zeros((B, nk), dtype=torch.float64, device=s.device)
        for warp in range(POWER_WARPS):
            acc = torch.zeros((B, nk, WORD_BITS), dtype=torch.float64, device=s.device)
            for q in range(warp, wpc, POWER_WARPS):
                acc = acc + t[:, :, q]
            for o in (16, 8, 4, 2, 1):
                acc = acc + acc[..., lanes ^ o]
            total = total + acc[..., 0]
        out[:, e] = total.T
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


def _approx_dispatch(sums_fn, dist, scores, keys, asize, bsize, chunk, n_chunks,
                     stable_log10, max_rounds, bitgen, stream) -> McResult:
    """Approx p-values on one device (a share of a sharded call), the keys
    made (:func:`_stream_keys`), ``sums_fn`` the power sums."""
    B = dist.shape[0]
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
    contiguous share of every round's windows, all enqueued before any is
    read back (:func:`_sums_over_shares`; escalation is per window)."""
    keys = _stream_keys(key, dist.shape[0], chroms, slots, stream, dist.device)
    sums = null_power_sums if sharding is None else _sums_over_shares(sharding, null_power_sums)
    return _approx_dispatch(sums, dist, scores, keys, asize, bsize, chunk, n_chunks,
                            stable_log10, max_rounds, bitgen, stream)


def _sums_over_shares(sharding, sums_fn):
    """``sums_fn`` (:func:`null_power_sums`' signature) with each call's
    windows cut over the mesh: every share's sums enqueued on its own
    stream from the calling thread (:func:`_on_share`), then each brought
    to the host, joined in window order.  Approx mode shards its power
    sums this way and fits and escalates once over all windows on the
    calling thread.  Threads lose here: a round's sums are well under a
    millisecond of K9 a share, and the fit a thread would run takes turns
    at the interpreter lock (approx shared at 16x, four shares of an
    H100: 80.1 ms with a thread a share fitting its windows, 26.8 ms so,
    23.6 unsharded; ``tests/measure_mc_shares.py``)."""
    def sums(dist, keys, *args):
        made = None if is_cpu(dist) else torch.cuda.current_stream(dist.device)
        pending = []
        for i, dev, sl in _shares(sharding, dist.shape[0]):
            with _on_share(i, dev, made) as stream:
                pending.append((i, dev, sums_fn(*_share_inputs(dist, keys, sl, dev, stream, made),
                                                *args)))
        parts = []
        for i, dev, out in pending:
            with _on_share(i, dev, None):
                parts.append(out.cpu())
        return torch.cat(parts, dim=2)

    return sums


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
    keys = _stream_keys(key, dist.shape[0], chroms, slots, stream, dist.device)
    return _approx_dispatch(null_power_sums_plain, dist, scores, keys, asize, bsize, chunk,
                            n_chunks, stable_log10, max_rounds, bitgen, stream)


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


def perm_chunk_words_plain(dist, scores, keys, limit, asize, bsize, chunk,
                           bitgen: str = "mix") -> torch.Tensor:
    """K11's hit words as plain torch (tests hold the kernel's composition
    to :func:`permutation_chunk_plain` with it): int32 [B, ceil(chunk/32)],
    bit b of word q set where permutation K = 32 q + b < min(limit, chunk)
    of the chunk keyed by ``keys`` as given scores ``>=`` the float32
    observed score; a window with a non-finite distance has none (the
    kernel's staging flag; the twin's NaN sums give the same)."""
    dev = dist.device
    B = dist.shape[0]
    distf = dist.to(torch.float32)
    new = _perm_scores(distf, keys.to(dev, torch.int64), asize, bsize, chunk, bitgen)
    obs = torch.as_tensor(scores).to(dev).to(torch.float32)
    hit = torch.zeros((B, chunk_stride(chunk)), dtype=torch.bool, device=dev)
    finite = torch.isfinite(distf).reshape(B, -1).all(dim=1)
    counted = torch.arange(chunk, device=dev) < int(limit)
    hit[:, :chunk] = (new >= obs[:, None]) & counted[None, :] & finite[:, None]
    return _pack_words(hit)


def chunk_epilogue_plain(words: torch.Tensor, need: torch.Tensor):
    """K11's stop epilogue as plain torch: (chunk_hits, reached, pos) of a
    window's chunk words [B, wpc] folded in permutation order
    (:func:`_nth_hit`); pos 0 where ``need`` is never reached or <= 0."""
    need = torch.as_tensor(need).to(words.device, torch.int64)
    total, pos = _nth_hit(words.to(torch.int64) & 0xFFFFFFFF, need)
    reached = total >= need
    return (total.to(torch.int32), reached,
            torch.where(reached, pos, 0).to(torch.int32))


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
    reached).  K11 on a CUDA ``dist`` (the hit words of
    :func:`perm_chunk_words_plain` folded by :func:`chunk_epilogue_plain`,
    in one launch: ``css_perm_chunk`` up to m = 64, ``css_perm_chunk_block``
    past it, as :func:`window_form` says), the plain version on a CPU
    one."""
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
    args = (ptr(distf), ptr(obs), ptr(need_d), ptr(wk), B, asize + bsize, asize, chunk,
            min(int(limit), chunk), gen, ctypes.c_float(between), ctypes.c_float(ca),
            ctypes.c_float(cb))
    outs = (ptr(hits), ptr(reached), ptr(pos))
    name, scratch = _block_scratch(asize + bsize, False, dev)
    if name == "register":
        launch(LAUNCHES, "css_perm_chunk", "css_perm_chunk", dev, *args, *outs)
    else:
        launch(LAUNCHES, "css_perm_chunk_block", "css_perm_chunk_block", dev, *args,
               ptr(scratch), *outs)
    return hits, reached, pos
