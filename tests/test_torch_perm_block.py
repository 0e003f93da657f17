"""The orders of the MC's large-panel body (csrc/css_perm_block.cuh, K8,
K11 and K9's window stream past m = 64) in their plain torch mirrors, on
the CPU:

* the rank network (kernels/perm.py:rank_network, network_ranks): a
  bitonic sort of the (draw, index) keys gives _ranks' ranks exactly, for
  mix and threefry draws and for words forced equal;
* the nonzero term walk (kernels/perm.py:nonzero_walk): each lane's a*b +
  m - 2 nonzero products, added in the body's order, give
  _scores_from_ranks' float32 sums bit for bit (the same values; a zero's
  sign aside), so K8's and K11's hits and K9's power sums are the plain
  versions';
* a window with a NaN or an Inf distance: the walk scores it NaN (the
  kernels' flag), which gives it the plain versions' NaN power sums and
  their empty hit words.

Panel sizes m = 65 .. 300 around the body's switches (p = 128 / 256 keys
in registers, 512 in the key slab; 8-bit tables to m = 232), at a = 1,
b = 1 and an uneven split.  Only the port's plain path runs here: the
kernels are held to these functions' twins on the card
(tests/test_torch_kernels_gpu.py).  Run: python -m pytest -q
tests/test_torch_perm_block.py (~20 s, one torch thread)."""

import numpy as np
import pytest
import torch

from divergence_tpu_torch import rng
from divergence_tpu_torch.kernels import perm as kperm

M_VALUES = [65, 96, 128, 129, 200, 256, 257, 300]


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _keys(seed: int, nwin: int = 2) -> torch.Tensor:
    chroms = np.full(nwin, rng.chrom_hash("chrP"), dtype=np.int64)
    slots = np.arange(nwin, dtype=np.int64) * 5 + seed
    return rng.window_keys(rng.fold_in(rng.prng_key(seed), 2), chroms, slots)


def _dist(m: int, nwin: int, seed: int) -> torch.Tensor:
    """[nwin, m, m] float32 distances of random points in the plane."""
    pts = np.random.default_rng(seed).normal(size=(nwin, m, 2))
    d = np.sqrt(((pts[:, :, None] - pts[:, None]) ** 2).sum(-1))
    return torch.from_numpy(d).float()


def _stable_ranks(x: torch.Tensor) -> torch.Tensor:
    """r_j = #{l : x_l < x_j, or x_l == x_j and l < j} of x [..., m]."""
    m = x.shape[-1]
    xj, xl = x[..., :, None], x[..., None, :]
    idx = torch.arange(m)
    return ((xl < xj) | ((xl == xj) & (idx[None, :] < idx[:, None]))).sum(-1)


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("m", M_VALUES)
def test_rank_network_gives_the_ranks(m, bitgen):
    keys = rng.fold_in(_keys(m), 3)
    assert torch.equal(kperm.rank_network(keys, 32, m, bitgen),
                       kperm._ranks(keys, 32, m, bitgen))


@pytest.mark.parametrize("m", [65, 129, 256, 257])
def test_network_ranks_break_ties_by_index(m):
    """Words forced equal (a handful of values, as threefry's equal float32
    uniforms are equal words): the sort's ranks are the stable order's."""
    x = torch.from_numpy(np.random.default_rng(m).integers(0, 5, size=(3, 7, m)))
    x[0, 0] = 0xFFFFFFFF                      # every word the largest there is
    got = kperm.network_ranks(x)
    assert torch.equal(got, _stable_ranks(x))
    assert torch.equal(got[0, 0], torch.arange(m))


def _splits(m: int) -> list[tuple[int, int]]:
    a = m * 11 // 20
    return [(1, m - 1), (m - 1, 1), (a, m - a)]


@pytest.mark.parametrize("m", M_VALUES)
def test_nonzero_walk_gives_the_twins_scores(m):
    dist = _dist(m, 2, seed=m)
    for asize, bsize in _splits(m):
        r = kperm.rank_network(rng.fold_in(_keys(m + asize), 1), 16, m, "mix")
        got = kperm.nonzero_walk(dist, r, asize, bsize)
        want = kperm._scores_from_ranks(dist, r, asize, bsize)
        assert torch.equal(got, want), (asize, bsize)
        assert got.dtype == torch.float32 and got.isfinite().all()


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("m", [65, 200, 257])
def test_non_finite_windows(m, bitgen):
    """Window 1 NaN in individual 1's row and column, window 2 +Inf at (0,
    2) and (2, 0): the walk scores them NaN, so K9's sums are the plain
    version's NaN and K8's hit words (K11's hits) the plain versions'
    empty ones; window 0's sums and words as the plain versions'."""
    asize, bsize = m * 11 // 20, m - m * 11 // 20
    chunk, k0 = 64, 2
    dist = _dist(m, 3, seed=m + 1)
    dist[1, 1, :] = dist[1, :, 1] = float("nan")
    dist[2, 0, 2] = dist[2, 2, 0] = float("inf")
    wkeys = _keys(m + 2, 3)
    s = kperm.nonzero_walk(dist, kperm.rank_network(rng.fold_in(wkeys, k0), chunk, m, bitgen),
                           asize, bsize)
    assert s[1:].isnan().all() and s[0].isfinite().all()
    s64 = s.double()
    sums = torch.stack([s64.sum(-1), (s64 * s64).sum(-1), (s64 * s64 * s64).sum(-1)])
    want = kperm.null_power_sums_plain(dist, wkeys, asize, bsize, chunk, k0, 1, "window",
                                       bitgen)[0]
    assert want[:, 1:].isnan().all() and sums[:, 1:].isnan().all()
    assert torch.allclose(sums[:, 0], want[:, 0], rtol=1e-12, atol=0.0)

    # K8's words of chunk k0 and K11's chunk, against scores a little below
    # the null's middle so window 0 hits
    obs = torch.full((3,), float(s[0].median()), dtype=torch.float32)
    flat = dist.reshape(3, m * m).contiguous()
    words = kperm.mc_window_hit_words_plain(flat, obs, wkeys, torch.arange(3), k0, 1, asize,
                                            bsize, chunk, 10_000, bitgen)
    hit = kperm._unpack_words(words)[:, 0, :chunk]
    assert torch.equal(hit, s >= obs[:, None])
    assert hit[0].any() and not hit[1:].any()
    hits, _, _ = kperm.permutation_chunk_plain(dist, obs, torch.ones(3, dtype=torch.int64),
                                               chunk, rng.fold_in(wkeys, k0), asize, bsize,
                                               chunk, bitgen)
    assert hits.tolist() == [int(hit[0].sum()), 0, 0]


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("m", M_VALUES)
def test_window_perm_cost_counts_the_sort(m, bitgen):
    """Past m = 64 a window-stream permutation costs the body's sort of
    rank_keys(m) keys, not m(m-1) rank compares: the range loop's ranges
    still tile the chunks, each no shorter than the old count's."""
    asize = m * 11 // 20
    p = kperm.rank_keys(m)
    assert p >= max(m, kperm.RANK_KEYS_MIN) and p & (p - 1) == 0 and p < 2 * max(m, 64)
    lg = p.bit_length() - 1
    draws = (70 if bitgen == "threefry" else 12) * m
    terms = 2 * (asize * (m - asize) + m - 2)
    cost = kperm.window_perm_cost(m, asize, bitgen)
    assert cost == draws + p // 2 * lg * (lg + 1) // 2 + terms
    old = draws + 2 * m * (m - 1) + terms
    assert cost < old
    n_chunks, chunk = 79, 256
    for nact in (997, 40):
        k = 0
        while k < n_chunks:
            nk = kperm.range_chunks(k, n_chunks, nact, 0, chunk, per_perm=cost)
            assert 1 <= nk <= n_chunks - k
            assert nk >= kperm.range_chunks(k, n_chunks, nact, 0, chunk, per_perm=old)
            k += nk
        assert k == n_chunks


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("m", [65, 128, 200, 300])
def test_coeff_facts_rebuild_the_coefficients(m, bitgen):
    """K7's large-panel passes mirrored (kernels/perm.py:coeff_facts of the
    network's ranks, then coeff_from_facts): M bit-equal to _shared_coeff
    for a chunk of 100 columns, and +0.0 in a padding column (u = 0, no
    successor)."""
    asize, bsize = (m + 1) // 2, m // 2
    key = rng.fold_in(rng.prng_key(5), 2)
    kc = rng.fold_in(key, 3)
    r = kperm.rank_network(kc[None], 100, m, bitgen)[0]                  # [m, K]
    fact, u = kperm.coeff_facts(r, asize, bsize)
    got = kperm.coeff_from_facts(fact, u, asize, bsize)
    want = kperm._shared_coeff(key, 3, m, asize, bsize, 100, bitgen)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    pad = kperm.coeff_from_facts(torch.full((m, 1), 0xFFFF), torch.zeros((m, 1), dtype=torch.bool),
                                 asize, bsize)
    assert torch.equal(pad.view(torch.int32), torch.zeros_like(pad).view(torch.int32))
