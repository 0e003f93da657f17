"""K11's composition (divergence_tpu_torch.kernels.perm: the hit words of
perm_chunk_words_plain folded by chunk_epilogue_plain, as the kernel
css_perm_chunk composes them in one launch) on the CPU, against the JAX
package's permutation_chunk and against the port's twin
permutation_chunk_plain.

The composition equals the twin on every window (both score the same
float32 sums; the words are the twin's hits packed, and the fold picks the
need-th hit word by word).  Against JAX the hits agree except where a
permuted float32 score ties the observed one within the rounding of two
summation orders (tests/test_torch_parallel.py's near-tie rule; at most
two windows, and at m <= 3, where a permuted score often equals the
observed one in exact arithmetic, any number).  The
kernel scores only the a*b + m - 2 nonzero terms and flags a window with a
non-finite distance; the words built that way equal the twin's words
(tests/test_torch_mc_window_ranges.py shows the sums agree as values)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.kernels import perm as jperm
from divergence_tpu_torch import rng
from divergence_tpu_torch.kernels import perm as tperm
from test_torch_mc_window import _phase1
from test_torch_mc_window_ranges import _nonzero_term_scores
from test_torch_parallel import _near_ties
from test_torch_smacof import one_torch_thread  # noqa: F401 (autouse)

PANELS = {2: (1, 1), 3: (2, 1), 21: (11, 10), 33: (17, 16), 64: (32, 32)}
# (chunk, limit): the step's chunk, a chunk of partial words with limit <
# chunk, one word, nothing counted, a negative limit
CHUNKS = [(128, 128), (100, 60), (16, 16), (64, 0), (64, -5)]
NEEDS = (-2, 0, 1, 3, 1000)


def _windows(m, seed=None, limit=48):
    """(dist [B, m, m] float64, observed scores, window keys [B, 2]) of at
    most ``limit`` valid windows of a small stickleback-shaped panel."""
    asize, bsize = PANELS[m]
    dist, scores, chroms, slots = _phase1(asize, bsize, seed=seed)
    dist, scores, chroms, slots = dist[:limit], scores[:limit], chroms[:limit], slots[:limit]
    keys = rng.window_keys(rng.fold_in(rng.prng_key(4), 2), chroms, slots)
    return dist, scores, keys


def _composed(dist, scores, keys, need, limit, asize, bsize, chunk, bitgen="mix"):
    words = tperm.perm_chunk_words_plain(dist, scores, keys, limit, asize, bsize, chunk,
                                         bitgen)
    assert words.shape == (dist.shape[0], -(-chunk // 32)) and words.dtype == torch.int32
    return tperm.chunk_epilogue_plain(words, need)


def _assert_equal(got, want):
    assert [t.dtype for t in got] == [torch.int32, torch.bool, torch.int32]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("m", sorted(PANELS))
def test_composition_matches_jax_and_twin(m, bitgen):
    asize, bsize = PANELS[m]
    dist, scores, keys = _windows(m, limit=24 if m > 32 else 48)
    B = dist.shape[0]
    assert B >= 8
    jkeys = jax.random.wrap_key_data(jnp.asarray(keys.numpy().astype(np.uint32)))
    need = np.random.default_rng(m).integers(-1, 6, size=B).astype(np.int32)
    n_ties = 0
    for chunk, limit in ((128, 128), (100, 60)):
        got = _composed(dist, scores, keys, torch.from_numpy(need), limit, asize, bsize,
                        chunk, bitgen)
        _assert_equal(got, tperm.permutation_chunk_plain(
            dist, scores, torch.from_numpy(need), limit, keys, asize, bsize, chunk, bitgen))
        want = jperm.permutation_chunk(
            jnp.asarray(dist.numpy()), jnp.asarray(scores), jnp.asarray(need),
            jnp.asarray(limit), jkeys, asize, bsize, chunk, bitgen=bitgen)
        n_ties += _near_ties(dist, scores, keys, want[0], got[0].numpy(), asize, bsize, chunk,
                             bitgen)
        same = got[0].numpy() == np.asarray(want[0])
        for g, w in zip(got[1:], want[1:]):
            assert np.array_equal(g.numpy()[same], np.asarray(w)[same])
    # at m <= 3 a permutation often relabels the observed grouping, so its
    # score equals the observed one in exact arithmetic: every window may tie
    assert n_ties <= (2 if m > 3 else 2 * B)
    if m == 2:
        assert (got[0] == 60).all()   # drosophila: every permutation ties


@pytest.mark.parametrize("chunk,limit", CHUNKS)
def test_epilogue_rules(chunk, limit):
    """need <= 0 (reached at 0), reached inside the chunk, never reached,
    limit < chunk, nothing counted: the fold equals the twin's cumsum /
    argmax, and pos is the need-th hit's index where it is reached."""
    dist, scores, keys = _windows(21, seed=3)
    B = dist.shape[0]
    words = tperm.perm_chunk_words_plain(dist, scores, keys, limit, 11, 10, chunk)
    bits = tperm._unpack_words(words)
    assert not bits[:, max(limit, 0):].any()
    for need in NEEDS:
        nd = torch.full((B,), need)
        got = tperm.chunk_epilogue_plain(words, nd)
        _assert_equal(got, tperm.permutation_chunk_plain(dist, scores, nd, limit, keys,
                                                         11, 10, chunk))
        for w in range(B):
            idx = torch.nonzero(bits[w])[:, 0]
            assert got[2][w] == (idx[need - 1] if 0 < need <= len(idx) else 0)
    if limit == 128:
        assert 0 < int(got[0].sum()) and not bool(tperm.chunk_epilogue_plain(
            words, torch.full((B,), 1000))[1].any())


def test_epilogue_words_by_hand():
    """Bits set by hand across word edges, one window each."""
    hit = torch.zeros((6, 96), dtype=torch.bool)
    hit[0, [0, 31, 32, 95]] = True
    hit[1, [40]] = True
    hit[3, :] = True
    hit[4, [31]] = True
    hit[5, [63, 64]] = True
    words = tperm._pack_words(hit)
    need = torch.tensor([3, 1, 1, 96, 2, 2])
    hits, reached, pos = tperm.chunk_epilogue_plain(words, need)
    assert hits.tolist() == [4, 1, 0, 96, 1, 2]
    assert reached.tolist() == [True, True, False, True, False, True]
    assert pos.tolist() == [32, 40, 0, 95, 0, 64]


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
def test_non_finite_windows_get_no_hits(bitgen):
    """A NaN row, a NaN only on the diagonal, a symmetric +Inf, a -Inf on
    the diagonal: no hits in the composition (the kernel's flag), in the
    twin and in JAX, even against a score far below the null; the kernel's
    nonzero-term sums alone would give the last three hits."""
    dist, scores, keys = _windows(21, seed=5)
    dist = dist.clone()
    dist[3, 5, :] = float("nan")
    dist[3, :, 5] = float("nan")
    dist[7, 2, 2] = float("nan")
    dist[11, 4, 9] = dist[11, 9, 4] = float("inf")
    dist[13, 0, 0] = -float("inf")
    poisoned = [3, 7, 11, 13]
    B = dist.shape[0]
    low = scores - 1e3
    need = torch.ones(B, dtype=torch.int32)
    got = _composed(dist, low, keys, need, 128, 11, 10, 128, bitgen)
    _assert_equal(got, tperm.permutation_chunk_plain(dist, low, need, 128, keys, 11, 10, 128,
                                                     bitgen))
    jkeys = jax.random.wrap_key_data(jnp.asarray(keys.numpy().astype(np.uint32)))
    want = jperm.permutation_chunk(jnp.asarray(dist.numpy()), jnp.asarray(low),
                                   jnp.asarray(need.numpy()), jnp.asarray(128), jkeys, 11, 10,
                                   128, bitgen=bitgen)
    assert (got[0][poisoned] == 0).all() and (np.asarray(want[0])[poisoned] == 0).all()
    assert (got[0][[0, 1, 2]] == 128).all()
    r = tperm._ranks(keys[poisoned], 128, 21, bitgen)
    nz, _ = _nonzero_term_scores(dist[poisoned].float(), r, 11, 10)
    assert (nz[1:] >= torch.as_tensor(low[poisoned[1:]]).float()[:, None]).any(dim=1).all()


@pytest.mark.parametrize("m", [2, 3, 21, 33, 64])
def test_nonzero_term_words_equal_the_twins(m):
    """Words from the kernel's arithmetic (the nonzero terms only, in the
    twin's order, non-finite windows flagged) equal
    perm_chunk_words_plain's (every product added)."""
    asize, bsize = PANELS[m]
    dist, scores, keys = _windows(m, seed=m + 7, limit=8 if m > 32 else 24)
    B = dist.shape[0]
    distf = dist.float()
    for chunk, limit in ((128, 128), (100, 60)):
        r = tperm._ranks(keys, chunk, m, "mix")
        nz, _ = _nonzero_term_scores(distf, r, asize, bsize)
        hit = torch.zeros((B, tperm.chunk_stride(chunk)), dtype=torch.bool)
        obs = torch.as_tensor(scores).float()
        hit[:, :chunk] = (nz >= obs[:, None]) & (torch.arange(chunk) < limit)
        want = tperm.perm_chunk_words_plain(dist, scores, keys, limit, asize, bsize, chunk)
        assert torch.equal(tperm._pack_words(hit), want)


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
def test_words_are_k8s_first_chunk(bitgen):
    """On the keys fold_in(wkey, 0) the words are K8's first chunk's
    (mc_window_hit_words_plain), and the fold at need = threshold stops
    where K8's scan does."""
    dist, scores, keys = _windows(21, seed=9)
    B = dist.shape[0]
    flat = dist.float().reshape(B, -1)
    obs = torch.as_tensor(scores).float()
    k8 = tperm.mc_window_hit_words_plain(flat, obs, keys, torch.arange(B), 0, 1, 11, 10, 256,
                                         256, bitgen)[:, 0]
    words = tperm.perm_chunk_words_plain(dist, scores, rng.fold_in(keys, 0), 256, 11, 10,
                                         256, bitgen)
    assert torch.equal(words, k8)
    hits = torch.zeros(B, dtype=torch.int32)
    nsc = torch.zeros(B, dtype=torch.int32)
    done = torch.zeros(B, dtype=torch.uint8)
    tperm.mc_scan_plain(k8[:, None], torch.arange(B), 0, 256, 256, 10, hits, nsc, done)
    h, reached, pos = tperm.chunk_epilogue_plain(words, torch.full((B,), 10))
    assert torch.equal(reached, done.bool())
    assert torch.equal((pos + 1)[reached], nsc[reached])
    assert torch.equal(h[~reached], hits[~reached])
