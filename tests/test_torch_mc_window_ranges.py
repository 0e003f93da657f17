"""The window-stream MC's range loop (divergence_tpu_torch.kernels.perm:
mc_window, K8's design) with its plain pieces on the CPU: the hit words of
a range (mc_window_hit_words_plain), K7's stop scan (mc_scan_plain) and the
range schedule at the window stream's cost per permutation.

The range loop equals the JAX package's mc_significance(stream="window")
in (p, n, hits) on every window under several range schedules, except
where a permuted float32 score ties the observed one within the rounding
of two summation orders (tests/test_torch_mc_window.py's near-tie rule,
at most one window); the float64 form equals mc_native_plain exactly.  The
kernel's float32 score adds only the nonzero terms, in the twin's order:
for finite distances the same sums but for the sign of a zero, shown
here, and for non-finite ones the rule that gives such a window no hits."""

import functools

import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.kernels import perm as jperm
from divergence_tpu_torch import rng
from divergence_tpu_torch.kernels import perm as tperm
from test_torch_mc_window import _explain_differences, _keys, _phase1
from test_torch_smacof import one_torch_thread  # noqa: F401 (autouse)

THRESHOLD = 10
# each schedule: the module constants of kernels/perm.py it sets (the
# window stream has no coefficient matrix: its bound is the hit words)
SCHEDULES = {
    "default": {},
    "one_chunk_each": {"_FIRST_RANGE_CHUNKS": 1, "_RANGE_FMAS": 0, "_RANGE_HIT_BYTES": 1},
    "doubling_from_one": {"_FIRST_RANGE_CHUNKS": 1, "_RANGE_FMAS": 0},
    "hit_bytes_bound": {"_RANGE_HIT_BYTES": 64 * 100},
}
CASES = [(11, 10, 256, 3000), (5, 4, 100, 1777), (1, 6, 256, 1000)]


@functools.lru_cache(maxsize=None)
def _case(asize, bsize, chunk, runs, bitgen, poison=False):
    """Windows of a small panel, their window keys and JAX's single-pass
    result; ``poison`` gives window 0 a NaN row and window 1 a NaN only
    on the diagonal."""
    dist, scores, chroms, slots = _phase1(asize, bsize, seed=asize + 2)
    dist = dist.float().clone()
    if poison:
        dist[0, 2, :] = float("nan")
        dist[0, :, 2] = float("nan")
        dist[1, 1, 1] = float("nan")
    jkey, tkey = _keys(7)
    wkeys = rng.window_keys(tkey, chroms, slots)
    want = jperm.significance(np.asarray(dist), scores, asize, bsize, THRESHOLD, runs, jkey,
                              chunk=chunk, chroms=chroms, slots=slots, bitgen=bitgen,
                              stream="window")
    return dist, scores, wkeys, want


def _run_ranges(dist, scores, wkeys, asize, bsize, chunk, runs, bitgen="mix",
                native=False):
    ranges = []
    nsc, hits = tperm.mc_window(dist, torch.as_tensor(scores).float(), wkeys, asize, bsize,
                                chunk, runs, THRESHOLD, bitgen, native=native, ranges=ranges)
    got = tperm.McResult(((hits.double() + 1) / (nsc.double() + 1)).numpy(),
                         nsc.long().numpy(), hits.long().numpy())
    return got, ranges


def _check_ranges(ranges, got, chunk, runs):
    """The ranges tile the chunks the longest window ran, in order, and
    computed at least the permutations consumed."""
    assert [k for k, _, _ in ranges] == list(np.cumsum([0] + [nk for _, nk, _ in ranges])[:-1])
    assert sum(nk for _, nk, _ in ranges) * chunk >= got.nscores.max()
    computed = sum(a * (min(runs, (k + nk) * chunk) - k * chunk) for k, nk, a in ranges)
    assert computed >= got.nscores.sum()


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("asize,bsize,chunk,runs", CASES)
def test_range_loop_matches_jax(monkeypatch, schedule, asize, bsize, chunk, runs, bitgen):
    for name, value in SCHEDULES[schedule].items():
        monkeypatch.setattr(tperm, name, value)
    dist, scores, wkeys, want = _case(asize, bsize, chunk, runs, bitgen)
    got, ranges = _run_ranges(dist, scores, wkeys, asize, bsize, chunk, runs, bitgen)
    n_ties = _explain_differences(dist, scores, wkeys, got, want, asize, bsize, chunk, bitgen)
    same = (got.nscores == want.nscores) & (got.hits == want.hits)
    assert np.array_equal(got.pvals[same], want.pvals[same]) and n_ties <= 1
    assert (want.nscores < runs).any()
    assert asize == 1 or (want.nscores == runs).any()
    _check_ranges(ranges, got, chunk, runs)
    if schedule == "one_chunk_each":
        assert all(nk == 1 for _, nk, _ in ranges)


@pytest.mark.parametrize("schedule", ["default", "doubling_from_one", "hit_bytes_bound"])
@pytest.mark.parametrize("asize,bsize,chunk,runs", CASES)
def test_native_range_loop_equals_mc_native_plain(monkeypatch, schedule, asize, bsize, chunk,
                                                  runs):
    for name, value in SCHEDULES[schedule].items():
        monkeypatch.setattr(tperm, name, value)
    dist, scores, wkeys, _ = _case(asize, bsize, chunk, runs, "mix")
    pv, n, h = tperm.mc_native_plain(dist, scores, wkeys, asize, bsize, chunk, runs,
                                     THRESHOLD)
    got, ranges = _run_ranges(dist, scores, wkeys, asize, bsize, chunk, runs, native=True)
    assert np.array_equal(got.nscores, n) and np.array_equal(got.hits, h)
    assert np.array_equal(got.pvals, pv)
    _check_ranges(ranges, got, chunk, runs)


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
def test_range_loop_non_finite_windows(bitgen):
    """A NaN row and a NaN only on the diagonal: no hits, n = runs, in JAX
    and in the range loop; the other windows as before."""
    asize, bsize, chunk, runs = 11, 10, 256, 3000
    dist, scores, wkeys, want = _case(asize, bsize, chunk, runs, bitgen, poison=True)
    got, _ = _run_ranges(dist, scores, wkeys, asize, bsize, chunk, runs, bitgen)
    assert (want.hits[:2] == 0).all() and (want.nscores[:2] == runs).all()
    assert (got.hits[:2] == 0).all() and (got.nscores[:2] == runs).all()
    n_ties = _explain_differences(dist, scores, wkeys, got, want, asize, bsize, chunk, bitgen)
    assert n_ties <= 1
    pv, n, h = tperm.mc_native_plain(dist, scores, wkeys, asize, bsize, chunk, runs,
                                     THRESHOLD)
    nat, _ = _run_ranges(dist, scores, wkeys, asize, bsize, chunk, runs, native=True)
    assert np.array_equal(nat.nscores, n) and np.array_equal(nat.hits, h)


def _nonzero_term_scores(distf, r, asize, bsize):
    """The kernel's float32 score (css_perm_common.cuh score_f32_nonzero)
    as torch: the products of the nonzero coefficients only, added in
    row-major (j, l) order from 0."""
    C = tperm._rank_coeff(r, asize, bsize)                   # [B, m, m, K]
    prod = distf[..., None] * C
    m = distf.shape[-1]
    acc = torch.zeros_like(prod[:, 0, 0])
    for j in range(m):
        for l in range(m):
            acc = torch.where(C[:, j, l] != 0, acc + prod[:, j, l], acc)
    return acc, C


@pytest.mark.parametrize("asize,bsize", [(11, 10), (5, 4), (1, 6), (2, 2)])
def test_nonzero_terms_give_the_twins_scores(asize, bsize):
    """Over the a*b + m - 2 nonzero coefficients the float32 sums equal
    _scores_from_ranks' (every product added) as values, so every hit
    test agrees; a non-finite entry turns the twin's sum NaN but not
    necessarily the kernel's, hence its flag."""
    dist, _, chroms, slots = _phase1(asize, bsize, seed=asize + 11)
    distf = dist.float()
    m = asize + bsize
    _, tkey = _keys(3)
    wk = rng.fold_in(rng.window_keys(tkey, chroms, slots), 2)
    r = tperm._ranks(wk, 128, m, "mix")
    got, C = _nonzero_term_scores(distf, r, asize, bsize)
    want = tperm._scores_from_ranks(distf, r, asize, bsize)
    assert torch.equal(got, want)
    assert ((C != 0).sum(dim=(1, 2)) == asize * bsize + m - 2).all()
    diag = distf.clone()
    diag[:, 0, 0] = float("nan")
    assert tperm._scores_from_ranks(diag, r, asize, bsize).isnan().all()
    assert not _nonzero_term_scores(diag, r, asize, bsize)[0].isnan().any()


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("chunk", [100, 256])
def test_window_hit_words_are_the_counted_hits(chunk, native):
    dist, scores, chroms, slots = _phase1(5, 4, seed=4)
    _, tkey = _keys(2)
    wkeys = rng.window_keys(tkey, chroms, slots)
    B, m = dist.shape[0], 9
    flat = dist.float().reshape(B, m * m).contiguous()
    obs = torch.as_tensor(scores).float()
    active = torch.arange(1, B, 2)
    k0, nk, runs = 1, 4, 4 * chunk + 17
    words = tperm.mc_window_hit_words(flat, obs, wkeys, active, k0, nk, 5, 4, chunk, runs,
                                      native=native)
    cs = tperm.chunk_stride(chunk)
    assert words.dtype == torch.int32 and words.shape == (len(active), nk, cs // 32)
    bits = tperm._unpack_words(words)
    assert not bits[:, :, chunk:].any()                       # the pad never hits
    D = dist[active].float()
    for kk in range(nk):
        ck = rng.fold_in(wkeys[active], k0 + kk)
        if native:
            D64 = D.double()
            s = tperm._native_scores(D64, tperm._row_totals(D64),
                                     tperm._ranks(ck, chunk, m, "mix"), 5, 4)
            want = s >= obs[active].double()[:, None]
        else:
            want = tperm._perm_scores(D, ck, 5, 4, chunk) >= obs[active][:, None]
        want &= ((k0 + kk) * chunk + torch.arange(chunk)) < runs
        assert torch.equal(bits[:, kk, :chunk], want)
    assert bits.any() and not bits[:, :, :chunk].all()


def test_window_hit_words_refuse_native_threefry():
    dist, scores, chroms, slots = _phase1(5, 4, seed=4)
    flat = dist.float().reshape(dist.shape[0], 81)
    with pytest.raises(ValueError, match="mix"):
        tperm.mc_window_hit_words(flat, torch.as_tensor(scores).float(),
                                  torch.zeros((len(scores), 2), dtype=torch.int64),
                                  torch.arange(2), 0, 1, 5, 4, 256, 256, "threefry",
                                  native=True)


@pytest.mark.parametrize("m,asize", [(21, 11), (2, 1), (64, 32)])
@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
def test_window_schedule_covers_every_chunk_once(m, asize, bitgen):
    """At the window stream's cost the ranges tile the chunks, reach the
    work target with fewer chunks than the shared stream's product, and
    take no coefficient bound (no M)."""
    cost = tperm.window_perm_cost(m, asize, bitgen)
    assert cost > m * m
    n_chunks, chunk = 782, 256
    for nact in ([997] * 30, [15_997] * 30, [40_000, 900, 30, 1]):
        k, sizes = 0, []
        while k < n_chunks:
            a = nact[min(len(sizes), len(nact) - 1)]
            nk = tperm.range_chunks(k, n_chunks, a, 0, chunk, per_perm=cost)
            assert 1 <= nk <= n_chunks - k
            assert a * nk * tperm.chunk_stride(chunk) // 8 <= max(
                tperm._RANGE_HIT_BYTES, a * tperm.chunk_stride(chunk) // 8)
            sizes.append(nk)
            k += nk
        assert sum(sizes) == n_chunks and sizes[0] <= tperm._FIRST_RANGE_CHUNKS
        shared = tperm.range_chunks(0, n_chunks, nact[0], m * m, chunk)
        assert sizes[0] <= shared
