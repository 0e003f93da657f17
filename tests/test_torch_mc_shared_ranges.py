"""The shared-stream MC's range loop (divergence_tpu_torch.kernels.perm:
mc_shared) with its plain pieces on the CPU: the padded coefficient range,
the packed hit words of K7's ``css_mc_shared``, the stop scan of
``css_mc_scan`` and the range schedule.

The scan over packed words equals ``_chunk_update`` iterated over the
unpacked hits exactly (integer logic).  The range loop equals the JAX
package's ``mc_significance(stream="shared")`` in (p, n, hits) on every
window under several range schedules, except where a permuted float32
score ties the observed one within the rounding of two summation orders
(tests/test_torch_mc.py's near-tie rule, at most one window)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.kernels import perm as jperm
from divergence_tpu_torch.kernels import perm as tperm
from test_torch_mc import _explain_differences, _keys, _phase1
from test_torch_smacof import one_torch_thread  # noqa: F401 (autouse)

THRESHOLD = 10


def _pad_chunks(hit: torch.Tensor, chunk: int) -> torch.Tensor:
    """[A, nk, chunk] -> [A, nk, chunk_stride(chunk)], False in the pad."""
    return torch.nn.functional.pad(hit, (0, tperm.chunk_stride(chunk) - chunk))


def _scan_case(chunk, nk, k0, runs, seed):
    """Hits [A, nk, chunk] (counted columns only) and the state entering
    the range: random windows of hit rates 0-20 %, and windows that reach
    the threshold in the first word, in the middle of a chunk, on a
    chunk's last column, in the next chunk after carried-in hits, never,
    and one already done."""
    rs = np.random.default_rng(seed)
    A = 40
    hit = torch.from_numpy(rs.random((A, nk, chunk)) < rs.uniform(0, 0.2, (A, 1, 1)))
    hits = torch.from_numpy(rs.integers(0, THRESHOLD, A).astype(np.int32))
    nsc = torch.full((A,), k0 * chunk, dtype=torch.int32)
    done = torch.zeros(A, dtype=torch.uint8)
    hit[:6] = False
    hits[:6] = 0
    hit[0, 0, :THRESHOLD + 3] = True                       # first word
    mid = min(chunk // 2 + 3, chunk - 1)
    hit[1, 0, mid - THRESHOLD + 1: mid + 1] = True         # middle of the chunk
    hit[2, 0, :THRESHOLD - 1] = True                       # the last column
    hit[2, 0, chunk - 1] = True
    if nk > 1:                                             # carried in, next chunk
        hits[3] = THRESHOLD - 2
        hit[3, 1, [1, 5]] = True
    hits[5], nsc[5], done[5] = THRESHOLD, 3, 1             # done on entry
    hit[5] = True
    offset = (k0 + torch.arange(nk))[:, None] * chunk + torch.arange(chunk)[None, :]
    return hit & (offset < runs), hits, nsc, done


def _iterate_chunk_update(hit, k0, chunk, runs, hits, nsc, done):
    hits, nsc, done = hits.long(), nsc.long(), done.bool()
    for kk in range(hit.shape[1]):
        rows = torch.nonzero(~done)[:, 0]
        h, n, reached = tperm._chunk_update(hit[rows, kk], k0 + kk, chunk, runs, THRESHOLD,
                                            hits[rows], nsc[rows])
        hits[rows], nsc[rows] = h, n
        done[rows] = reached
    return hits, nsc, done


@pytest.mark.parametrize("chunk,nk,k0,runs", [
    (256, 4, 0, 1024),          # runs a multiple of chunk
    (256, 3, 0, 3 * 256 - 37),  # the last chunk partly counted
    (100, 5, 0, 487),           # words not a multiple of 32 columns
    (256, 8, 2, 10 * 256),      # a range starting at chunk 2
    (512, 2, 1, 1300),
    (32, 6, 0, 200),            # one word per chunk
    (33, 6, 0, 198),            # a one-column last word
])
def test_scan_plain_equals_chunk_update_iterated(chunk, nk, k0, runs):
    hit, hits, nsc, done = _scan_case(chunk, nk, k0, runs, seed=chunk + nk)
    words = tperm._pack_words(_pad_chunks(hit, chunk))
    assert words.shape == (hit.shape[0], nk, tperm.chunk_stride(chunk) // 32)
    want = _iterate_chunk_update(hit, k0, chunk, runs, hits, nsc, done)
    h, n, d = hits.clone(), nsc.clone(), done.clone()
    rows = torch.arange(hit.shape[0])
    tperm.mc_scan(words, rows, k0, chunk, runs, THRESHOLD, h, n, d)
    assert torch.equal(h.long(), want[0]) and torch.equal(n.long(), want[1])
    assert torch.equal(d.bool(), want[2])
    # the planted windows stopped where they were planted
    assert d[:3].all() and n[0] == k0 * chunk + THRESHOLD
    assert n[2] == k0 * chunk + chunk
    assert (h[5], n[5], d[5]) == (THRESHOLD, 3, 1)
    # a subset of the rows: the others are untouched
    sub = rows[::3].contiguous()
    h2, n2, d2 = hits.clone(), nsc.clone(), done.clone()
    tperm.mc_scan(words[sub], sub, k0, chunk, runs, THRESHOLD, h2, n2, d2)
    assert torch.equal(h2[sub], h[sub]) and torch.equal(n2[sub], n[sub])
    rest = torch.ones(len(rows), dtype=torch.bool)
    rest[sub] = False
    assert torch.equal(h2[rest], hits[rest]) and torch.equal(d2[rest], done[rest])


@pytest.mark.parametrize("chunk", [100, 256])
def test_hit_words_are_the_counted_hits_packed_per_chunk(chunk):
    dist, scores = _phase1(5, 4, 500, 25_000, seed=4)
    _, tkey = _keys(2)
    B, m = dist.shape[0], dist.shape[-1]
    flat = dist.float().reshape(B, m * m).contiguous()
    obs = torch.as_tensor(scores).float()
    active = torch.arange(1, B, 2)
    k0, nk, runs = 1, 4, 4 * chunk + 17
    M = tperm.coeff_range(tkey, k0, nk, m, 5, 4, chunk, "cpu")
    words = tperm.mc_hit_words(flat, obs, active, M, k0, nk, chunk, runs)
    cs = tperm.chunk_stride(chunk)
    assert words.dtype == torch.int32 and words.shape == (len(active), nk, cs // 32)
    bits = tperm._unpack_words(words)                         # [A, nk, cs]
    assert torch.equal(tperm._pack_words(bits), words)
    assert not bits[:, :, chunk:].any()                       # the pad never hits
    s = flat[active] @ tperm.shared_coeff(tkey, k0, nk, m, 5, 4, chunk, "cpu")
    counted = (k0 * chunk + torch.arange(nk * chunk)) < runs
    want = (s >= obs[active, None]) & counted
    assert torch.equal(bits[:, :, :chunk].reshape(len(active), -1), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("chunk", [100, 256])
def test_coeff_range_pads_whole_words(chunk):
    _, tkey = _keys(1)
    M = tperm.coeff_range(tkey, 2, 3, 9, 5, 4, chunk, "cpu")
    cs = tperm.chunk_stride(chunk)
    assert cs % 32 == 0 and cs - chunk < 32 and M.shape == (81, 3 * cs)
    M3 = M.reshape(81, 3, cs)
    assert not M3[:, :, chunk:].any()
    assert torch.equal(tperm.shared_coeff(tkey, 2, 3, 9, 5, 4, chunk, "cpu"),
                       tperm.shared_coeff_plain(tkey, 2, 3, 9, 5, 4, chunk, "cpu"))


# each schedule: the module constants of kernels/perm.py it sets
SCHEDULES = {
    "default": {},
    "one_chunk_each": {"_FIRST_RANGE_CHUNKS": 1, "_RANGE_FMAS": 0,
                       "_RANGE_COEFF_BYTES": 1},
    "doubling_from_one": {"_FIRST_RANGE_CHUNKS": 1, "_RANGE_FMAS": 0},
    "hit_bytes_bound": {"_RANGE_HIT_BYTES": 64 * 100},
}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("asize,bsize,chunk,runs", [
    (11, 10, 256, 3000), (5, 4, 100, 1777), (1, 1, 256, 1000),
])
def test_range_loop_matches_jax(monkeypatch, schedule, asize, bsize, chunk, runs):
    for name, value in SCHEDULES[schedule].items():
        monkeypatch.setattr(tperm, name, value)
    dist, scores = _phase1(asize, bsize, 500, 25_000, seed=asize + 2)
    jkey, tkey = _keys(7)
    B, m = dist.shape[0], asize + bsize
    pv, n, h, _ = jperm.mc_significance(
        jnp.asarray(np.asarray(dist)), jnp.asarray(scores), jkey, asize, bsize, chunk, runs,
        THRESHOLD, stream="shared")
    want = jperm.McResult(np.asarray(pv), np.asarray(n), np.asarray(h))
    ranges = []
    nsc, hits = tperm.mc_shared(dist.float().reshape(B, m * m).contiguous(),
                                torch.as_tensor(scores), tkey, asize, bsize, chunk, runs,
                                THRESHOLD, ranges=ranges)
    got = tperm.McResult(((hits.double() + 1) / (nsc.double() + 1)).numpy(),
                         nsc.long().numpy(), hits.long().numpy())
    n_ties = _explain_differences(dist, scores, got, want, tkey, asize, bsize, chunk)
    same = (got.nscores == want.nscores) & (got.hits == want.hits)
    assert np.array_equal(got.pvals[same], want.pvals[same]) and n_ties <= 1
    if asize == bsize == 1:   # every permutation reproduces the grouping
        assert (got.pvals == 1.0).all() and (got.nscores == THRESHOLD).all()
    else:
        assert (want.nscores < runs).any() and (want.nscores == runs).any()
    # the ranges tile the chunks the longest window ran, in order
    assert [k for k, _, _ in ranges] == list(np.cumsum([0] + [nk for _, nk, _ in ranges])[:-1])
    assert sum(nk for _, nk, _ in ranges) * chunk >= got.nscores.max()
    if schedule == "one_chunk_each":
        assert all(nk == 1 for _, nk, _ in ranges)
    computed = sum(a * (min(runs, (k + nk) * chunk) - k * chunk) for k, nk, a in ranges)
    assert computed >= got.nscores.sum()


@pytest.mark.parametrize("n_chunks,mm,chunk,nact", [
    (782, 441, 256, [15_997] + [15_809] * 20),   # the 16x case
    (782, 441, 256, [997] * 20),                 # the 10 k workload
    (782, 441, 256, [49_997, 3_000, 500, 80]),   # most windows stop early
    (782, 4096, 256, [800_000] * 40),            # m = 64, many windows
    (5, 4, 100, [10]),
    (25_000, 4, 32, [1]),                        # m = 2, tiny chunks
])
def test_range_schedule_covers_every_chunk_once(n_chunks, mm, chunk, nact):
    cs = tperm.chunk_stride(chunk)
    k, sizes = 0, []
    while k < n_chunks:
        a = nact[min(len(sizes), len(nact) - 1)]
        nk = tperm.range_chunks(k, n_chunks, a, mm, chunk)
        assert 1 <= nk <= n_chunks - k
        if nk > 1:
            assert 4 * mm * cs * nk <= tperm._RANGE_COEFF_BYTES
            assert a * cs // 8 * nk <= tperm._RANGE_HIT_BYTES
        if k == 0:
            assert nk <= tperm._FIRST_RANGE_CHUNKS
        else:   # a range grows to as many chunks as came before it, caps allowing
            cap = min(tperm._RANGE_COEFF_BYTES // (4 * mm * cs),
                      tperm._RANGE_HIT_BYTES // (a * cs // 8))
            assert nk >= min(k, cap, n_chunks - k)
        sizes.append(nk)
        k += nk
    assert sum(sizes) == n_chunks
