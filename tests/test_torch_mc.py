"""The shared-stream permutation Monte-Carlo of the port
(divergence_tpu_torch.kernels.perm, CPU path) against the JAX package's
(divergence_tpu/kernels/perm.py, stream="shared", run on the CPU).

The permutations are bit-equal: the ranks and the coefficient matrix M of
every chunk.  The estimator's outputs (pvals, nscores, hits) are equal on
every window, except where a permuted float32 score ties the observed one
within the rounding of two summation orders; such a window is shown to be
one by rescoring its permutations in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.kernels import perm as jperm
from divergence_tpu_torch import rng
from divergence_tpu_torch.core.windows import plan_windows
from divergence_tpu_torch.kernels import css as tcss
from divergence_tpu_torch.kernels import perm as tperm
from divergence_tpu_torch.tools.synth import make_chromosome, make_panel

PANELS = [(11, 10), (5, 4), (1, 6), (2, 2)]
TIE_RTOL = 1e-5   # a differing window must hold a permuted score this close


def _keys(seed):
    return (
        jax.random.fold_in(jax.random.PRNGKey(seed), 2),
        rng.fold_in(rng.prng_key(seed), 2),
    )


@pytest.mark.parametrize("asize,bsize", PANELS)
def test_ranks_bit_equal(asize, bsize):
    m = asize + bsize
    jkey, tkey = _keys(5)
    keys = jnp.stack([jax.random.fold_in(jkey, k) for k in range(3)])
    tkeys = torch.stack([rng.fold_in(tkey, k) for k in range(3)])
    want = np.asarray(jperm._ranks(keys, 64, m, "mix"))
    got = tperm._ranks(tkeys, 64, m).numpy()
    assert np.array_equal(got, want)
    # ranks are permutations of 0..m-1
    assert (np.sort(got, axis=1) == np.arange(m)[None, :, None]).all()


@pytest.mark.parametrize("chunk", [256, 512])
@pytest.mark.parametrize("asize,bsize", PANELS)
def test_shared_coeff_bit_equal(asize, bsize, chunk):
    m = asize + bsize
    jkey, tkey = _keys(3)
    for k in (0, 1, 17):
        want = np.asarray(jperm._shared_coeff(jkey, k, m, asize, bsize, chunk))
        got = tperm._shared_coeff(tkey, k, m, asize, bsize, chunk).numpy()
        assert got.dtype == want.dtype == np.float32 and got.shape == (m * m, chunk)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), k


def test_shared_coeff_range_is_side_by_side_chunks():
    _, tkey = _keys(1)
    got = tperm.shared_coeff(tkey, 2, 3, 9, 5, 4, 100, "cpu")
    assert got.shape == (81, 300)
    for i, k in enumerate(range(2, 5)):
        assert torch.equal(got[:, 100 * i: 100 * (i + 1)],
                           tperm._shared_coeff(tkey, k, 9, 5, 4, 100))


def _phase1(asize, bsize, npos, region, seed, maker=make_panel):
    pos, am, bm = maker(npos, region, asize, bsize, seed=seed)
    vals = np.concatenate([am, bm], axis=1)
    plan = plan_windows(pos, region, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    s, d, v = tcss.css_phase1(torch.from_numpy(vals), plan.lo[ids], plan.npos[ids],
                              asize, bsize)
    return d[v], s[v].numpy()


def _explain_differences(dist, scores, got, want, key, asize, bsize, chunk):
    """Every window whose (nscores, hits) differ must hold a permutation,
    among those either run consumed, whose float64 score lies within
    TIE_RTOL of the float32 observed score: a near tie."""
    bad = np.nonzero((got.nscores != want.nscores) | (got.hits != want.hits))[0]
    m = asize + bsize
    for w in bad:
        n = int(max(got.nscores[w], want.nscores[w]))
        M = tperm.shared_coeff(key, 0, -(-n // chunk), m, asize, bsize, chunk, "cpu")
        s64 = dist[w].reshape(-1).double() @ M.double()
        obs = float(np.float32(scores[w]))
        gap = float((s64[:n] - obs).abs().min()) / max(abs(obs), 1.0)
        assert gap <= TIE_RTOL, (w, gap)
    return len(bad)


@pytest.mark.parametrize("asize,bsize,chunk,runs", [
    (11, 10, 256, 2000), (11, 10, 512, 1500), (5, 4, 100, 777), (1, 6, 256, 1000),
])
def test_significance_matches_jax(asize, bsize, chunk, runs):
    dist, scores = _phase1(asize, bsize, 500, 25_000, seed=asize + 2)
    jkey, tkey = _keys(7)
    want = jperm.significance(
        np.asarray(dist), scores, asize, bsize, 10, runs, jkey, chunk=chunk,
        stream="shared",
    )
    got = tperm.significance(dist, scores, asize, bsize, 10, runs, tkey, chunk=chunk)
    assert got.pvals.dtype == np.float64 and got.pvals.shape == scores.shape
    # the runs are not trivial: windows stop early, and (with two real
    # groups) some reach the cap
    assert (want.nscores < runs).any()
    assert asize == 1 or (want.nscores == runs).any()
    n_ties = _explain_differences(dist, scores, got, want, tkey, asize, bsize, chunk)
    same = (got.nscores == want.nscores) & (got.hits == want.hits)
    assert np.array_equal(got.pvals[same], want.pvals[same])
    assert n_ties <= 1


def test_mc_significance_stops_every_window_by_the_rule():
    dist, scores = _phase1(11, 10, 400, 20_000, seed=9, maker=make_chromosome)
    _, tkey = _keys(0)
    pv, n, h = tperm.mc_significance(dist, scores, tkey, 11, 10, 256, 3000, 10)
    assert ((h == 10) | (n == 3000)).all()
    assert (h <= 10).all() and (n >= h).all() and (n <= 3000).all()
    np.testing.assert_array_equal(pv, (h + 1.0) / (n + 1.0))


def test_significance_of_no_windows():
    _, tkey = _keys(0)
    empty = tperm.significance(torch.zeros((0, 4, 4)), np.zeros(0), 2, 2, 10, 100, tkey)
    assert empty.pvals.shape == (0,) and empty.nscores.shape == (0,)


def test_chain_weights_and_coeff_constants():
    for a, b in PANELS + [(48, 16)]:
        assert tperm._chain_weights(a, b) == jperm._chain_weights(a, b)
        between, ca, cb = tperm._coeff_constants(a, b)
        assert between == float(np.float32(1) / np.float32(a * b))
    assert tcss.chain_weights_host(11, 10)[0] == tperm._chain_weights(11, 10)[0]
