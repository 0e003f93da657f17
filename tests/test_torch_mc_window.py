"""The per-window-stream permutation Monte-Carlo of the port
(divergence_tpu_torch.kernels.perm, CPU path) against the JAX package's
(divergence_tpu/kernels/perm.py, stream="window", run on the CPU), for
both draw streams (bitgen "mix" and "threefry"), and the port's float64
"native" evaluator against divergence_tpu.native.mc_native.

The permutations are bit-equal: the ranks of every chunk, threefry ties
included.  The float32 scores are the same products summed in another
order than XLA's fused reduction, so the estimator's outputs (pvals,
nscores, hits) are equal on every window except where a permuted float32
score ties the observed one within that rounding; such a window is shown
to be one by rescoring its permutations in float64 (TIE_RTOL, as in
tests/test_torch_mc.py).  The native form sums in mc_native's order in
float64 and is equal on every window."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu import native
from divergence_tpu.kernels import perm as jperm
from divergence_tpu_torch import rng
from divergence_tpu_torch.core.windows import plan_windows
from divergence_tpu_torch.kernels import css as tcss
from divergence_tpu_torch.kernels import perm as tperm
from divergence_tpu_torch.tools.synth import make_panel
from test_torch_mc import TIE_RTOL
from test_torch_smacof import one_torch_thread  # noqa: F401 (autouse)

PANELS = [(11, 10), (5, 4), (1, 6)]


def _keys(seed):
    return (
        jax.random.fold_in(jax.random.PRNGKey(seed), 2),
        rng.fold_in(rng.prng_key(seed), 2),
    )


def _phase1(asize, bsize, npos=500, region=25_000, seed=None):
    pos, am, bm = make_panel(npos, region, asize, bsize, seed=asize + 2 if seed is None else seed)
    vals = np.concatenate([am, bm], axis=1)
    plan = plan_windows(pos, region, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    s, d, v = tcss.css_phase1(torch.from_numpy(vals), plan.lo[ids], plan.npos[ids],
                              asize, bsize)
    vn = v.numpy()
    chroms = np.full(int(vn.sum()), rng.chrom_hash("chrW"), dtype=np.int64)
    return d[v], s[v].numpy(), chroms, plan.slot[ids][vn]


def _window_keys(jkey, tkey, chroms, slots):
    jk = jperm.window_keys(jkey, jnp.asarray(chroms), jnp.asarray(slots))
    return jk, rng.window_keys(tkey, chroms, slots)


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("asize,bsize", PANELS + [(2, 2), (32, 32)])
def test_ranks_bit_equal(asize, bsize, bitgen):
    """_ranks of per-window chunk keys fold_in(window_key, k)."""
    m = asize + bsize
    jkey, tkey = _keys(5)
    chroms = np.array([3, 2**31 - 1, 77], dtype=np.int64)
    slots = np.array([0, 40_001, 2**31 - 1], dtype=np.int64)
    jk, tk = _window_keys(jkey, tkey, chroms, slots)
    for k in (0, 1, 781):
        want = np.asarray(jperm._ranks(jperm._fold_chunk(jk, k), 128, m, bitgen))
        got = tperm._ranks(rng.fold_in(tk, k), 128, m, bitgen).numpy()
        assert np.array_equal(got, want), k
    assert (np.sort(got, axis=1) == np.arange(m)[None, :, None]).all()


def test_threefry_ranks_bit_equal_with_ties():
    """Equal float32 uniforms tie on the index: 64 draws per permutation
    over 4 x 4096 permutations hold tied draws, and the ranks still equal
    JAX's."""
    m, chunk = 64, 4096
    jkey, tkey = _keys(3)
    slots = np.arange(4, dtype=np.int64)
    jk, tk = _window_keys(jkey, tkey, np.zeros(4, np.int64), slots)
    u = tperm._draws(rng.fold_in(tk, 3), chunk, m, "threefry").numpy()
    s = np.sort(u, axis=-1)
    tied = int((np.diff(s, axis=-1) == 0).any(axis=-1).sum())
    assert tied > 0
    want = np.asarray(jperm._ranks(jperm._fold_chunk(jk, 3), chunk, m, "threefry"))
    got = tperm._ranks(rng.fold_in(tk, 3), chunk, m, "threefry").numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("chunk", [256, 512])
@pytest.mark.parametrize("asize,bsize", PANELS + [(2, 2)])
def test_shared_coeff_threefry_bit_equal(asize, bsize, chunk):
    m = asize + bsize
    jkey, tkey = _keys(3)
    for k in (0, 1, 17):
        want = np.asarray(jperm._shared_coeff(jkey, k, m, asize, bsize, chunk,
                                              bitgen="threefry"))
        got = tperm._shared_coeff(tkey, k, m, asize, bsize, chunk, "threefry").numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), k


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("asize,bsize", PANELS)
def test_perm_scores_match_jax(asize, bsize, bitgen):
    """The float32 scores of _perm_scores: the same products as JAX's,
    summed in another order (a few float32 ulps)."""
    dist, _, chroms, slots = _phase1(asize, bsize)
    jkey, tkey = _keys(2)
    jk, tk = _window_keys(jkey, tkey, chroms, slots)
    want = np.asarray(jperm._perm_scores(jnp.asarray(dist.float().numpy()),
                                         jperm._fold_chunk(jk, 4), asize, bsize, 256,
                                         bitgen=bitgen))
    got = tperm._perm_scores(dist.float(), rng.fold_in(tk, 4), asize, bsize, 256,
                             bitgen).numpy()
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-3)
    assert err.max() <= 1e-5, err.max()


def _explain_differences(dist, scores, wkeys, got, want, asize, bsize, chunk, bitgen):
    """Every window whose (nscores, hits) differ must hold a permutation,
    among those either run consumed, whose float64 score lies within
    TIE_RTOL of the float32 observed score: a near tie."""
    bad = np.nonzero((got.nscores != want.nscores) | (got.hits != want.hits))[0]
    m = asize + bsize
    for w in bad:
        n = int(max(got.nscores[w], want.nscores[w]))
        ks = [rng.fold_in(wkeys[w:w + 1], k) for k in range(-(-n // chunk))]
        r = torch.cat([tperm._ranks(k, chunk, m, bitgen) for k in ks], dim=-1)[0]
        C = tperm._rank_coeff(r, asize, bsize).double()            # [m, m, K]
        s64 = (dist[w].double()[..., None] * C).sum(dim=(0, 1))
        obs = float(np.float32(scores[w]))
        gap = float((s64[:n] - obs).abs().min()) / max(abs(obs), 1.0)
        assert gap <= TIE_RTOL, (w, gap)
    return len(bad)


def _run_both(asize, bsize, chunk, runs, bitgen, seed=None):
    dist, scores, chroms, slots = _phase1(asize, bsize, seed=seed)
    jkey, tkey = _keys(7)
    want = jperm.significance(
        np.asarray(dist), scores, asize, bsize, 10, runs, jkey, chunk=chunk,
        chroms=chroms, slots=slots, bitgen=bitgen, stream="window",
    )
    got = tperm.significance(dist, scores, asize, bsize, 10, runs, tkey, chunk=chunk,
                             chroms=chroms, slots=slots, bitgen=bitgen, stream="window")
    wkeys = rng.window_keys(tkey, chroms, slots)
    return dist, scores, wkeys, got, want


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("asize,bsize,chunk,runs", [
    (11, 10, 256, 2000), (11, 10, 100, 1500), (5, 4, 100, 777), (1, 6, 256, 1000),
])
def test_window_significance_matches_jax(asize, bsize, chunk, runs, bitgen):
    dist, scores, wkeys, got, want = _run_both(asize, bsize, chunk, runs, bitgen)
    assert got.pvals.dtype == np.float64 and got.pvals.shape == scores.shape
    assert (want.nscores < runs).any()
    assert asize == 1 or (want.nscores == runs).any()
    n_ties = _explain_differences(dist, scores, wkeys, got, want, asize, bsize, chunk,
                                  bitgen)
    same = (got.nscores == want.nscores) & (got.hits == want.hits)
    assert np.array_equal(got.pvals[same], want.pvals[same])
    assert n_ties <= 1


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
def test_window_significance_small_panel_differs_only_on_ties(bitgen):
    """At 2 + 2 a window has 24 permutations, some of which reproduce its
    observed grouping: their float32 scores tie the observed one within
    rounding, and the summation order decides many windows.  Every window
    that differs is such a near tie."""
    dist, scores, wkeys, got, want = _run_both(2, 2, 256, 1500, bitgen)
    _explain_differences(dist, scores, wkeys, got, want, 2, 2, 256, bitgen)


def test_window_stream_is_per_window():
    """A window's result depends on its own (chromosome, slot) stream only:
    any subset of the windows, in any order, gets the full run's results —
    why the engine leaves invalid windows out of the MC."""
    dist, scores, chroms, slots = _phase1(11, 10)
    _, tkey = _keys(1)
    full = tperm.significance(dist, scores, 11, 10, 10, 1500, tkey, chroms=chroms,
                              slots=slots, stream="window")
    sel = np.arange(len(scores))[::-3]
    part = tperm.significance(dist[sel.copy()], scores[sel], 11, 10, 10, 1500, tkey,
                              chroms=chroms[sel], slots=slots[sel], stream="window")
    for f in ("pvals", "nscores", "hits"):
        assert np.array_equal(getattr(part, f), getattr(full, f)[sel])


def test_mc_window_stops_every_window_by_the_rule():
    dist, scores, chroms, slots = _phase1(11, 10, seed=9)
    _, tkey = _keys(0)
    wkeys = rng.window_keys(tkey, chroms, slots)
    for bitgen in ("mix", "threefry"):
        pv, n, h = tperm.mc_significance(dist, scores, wkeys, 11, 10, 256, 3000, 10,
                                         stream="window", bitgen=bitgen)
        assert ((h == 10) | (n == 3000)).all()
        assert (h <= 10).all() and (n >= h).all() and (n <= 3000).all()
        np.testing.assert_array_equal(pv, (h + 1.0) / (n + 1.0))


needs_native = pytest.mark.skipif(
    not native.native_available(), reason="the JAX package's native toolchain is unavailable"
)


@needs_native
@pytest.mark.parametrize("asize,bsize,chunk,runs", [
    (11, 10, 256, 3000), (11, 10, 96, 1000), (5, 4, 100, 777), (1, 6, 64, 700),
    (2, 2, 256, 1500), (6, 5, 7, 300),
])
def test_native_plain_equals_mc_native(asize, bsize, chunk, runs):
    """(pvals, nscores, hits) identical to native/mc_native.cpp on every
    window, runs not a multiple of chunk included."""
    dist, scores, chroms, slots = _phase1(asize, bsize)
    _, tkey = _keys(4)
    wkeys = rng.window_keys(tkey, chroms, slots)
    want = native.mc_native(dist.numpy(), scores, wkeys.numpy().astype(np.uint32), asize,
                            chunk, runs, 10)
    got = tperm.significance(dist, scores, asize, bsize, 10, runs, tkey, chunk=chunk,
                             chroms=chroms, slots=slots, backend="native", stream="window")
    assert (want[1] < runs).any()
    for g, w in zip((got.pvals, got.nscores, got.hits), want):
        assert np.array_equal(g, w)


@needs_native
def test_native_backend_matches_jax_significance():
    """Through the JAX package's own entry point: significance(backend=
    "native") with its window keys."""
    dist, scores, chroms, slots = _phase1(11, 10, seed=21)
    jkey, tkey = _keys(8)
    want = jperm.significance(np.asarray(dist), scores, 11, 10, 7, 2500, jkey, chunk=128,
                              chroms=chroms, slots=slots, backend="native", stream="window")
    got = tperm.significance(dist, scores, 11, 10, 7, 2500, tkey, chunk=128, chroms=chroms,
                             slots=slots, backend="native", stream="window")
    for f in ("pvals", "nscores", "hits"):
        assert np.array_equal(getattr(got, f), getattr(want, f))


def test_native_scores_follow_mc_native_order():
    """_native_scores in float64 equals the float64 score of the same
    permutations computed directly from the definition to round-off."""
    dist, _, chroms, slots = _phase1(5, 4)
    _, tkey = _keys(2)
    wk = rng.window_keys(tkey, chroms, slots)
    D = dist.float().double()
    r = tperm._ranks(rng.fold_in(wk, 0), 64, 9, "mix")
    got = tperm._native_scores(D, tperm._row_totals(D), r, 5, 4)
    want = (D[..., None] * tperm._rank_coeff(r, 5, 4).double()).sum(dim=(1, 2))
    # the float32 coefficients (a+b) w are rounded: compare at float32 level
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-7)


def test_significance_argument_checks():
    dist, scores, chroms, slots = _phase1(5, 4)
    _, tkey = _keys(0)
    with pytest.raises(ValueError, match="per-window"):
        tperm.significance(dist, scores, 5, 4, 10, 100, tkey, backend="native",
                           stream="shared")
    with pytest.raises(ValueError, match="mix"):
        tperm.significance(dist, scores, 5, 4, 10, 100, tkey, backend="native",
                           bitgen="threefry", stream="window")
    with pytest.raises(ValueError, match="bitgen"):
        tperm.significance(dist, scores, 5, 4, 10, 100, tkey, bitgen="philox")
    with pytest.raises(ValueError, match="stream"):
        tperm.significance(dist, scores, 5, 4, 10, 100, tkey, stream="global")
    empty = tperm.significance(dist[:0], scores[:0], 5, 4, 10, 100, tkey, stream="window")
    assert empty.pvals.shape == (0,)
