"""Approx p-values of the port (kernels/perm.py: null_power_sums,
approx_significance; CPU path) against the JAX package's
(divergence_tpu/kernels/perm.py: _null_power_sums, approx_significance),
for both permutation streams and both draw streams.

The bands were measured on the CPU before the comparison was written down
(PERF.md §2): the power sums are float64 sums of float32 scores whose
last ulps depend on the summation order (the shared stream's product, the
window stream's score; m^2 float32 terms a score, so the band grows with
m), so they lie within POWER_RTOL of JAX's (measured at most 7.5e-7 for
m <= 21, 2.45e-6 for m = 48 and 64); on windows whose nscores agree (all
of them, measured) |log10 p - log10 p_jax| stays within LOG10_P_BAND
(measured at most 1.56e-5 for m <= 21 over 3,994 bench-like windows, and
2.45e-4 for m = 48 and 64 over 1,191 windows).  Both are keyed by the
largest panel they cover (:func:`band`).  A
window on the drift line |log10 p_full - log10 p_half| = 0.5 could
escalate in one and not the other, so nscores must agree on at least
99.9 % of windows.  The 2 + 2 panel is left out of the bands: its null
takes a few distinct values, the fitted variance cancels catastrophically
and an ulp moves p by decades."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.kernels import perm as jperm
from divergence_tpu_torch import rng
from divergence_tpu_torch.kernels import perm as tperm
from divergence_tpu_torch.tools.synth import make_chromosome, make_panel
from test_torch_mc_window import _keys, _phase1
from test_torch_smacof import one_torch_thread  # noqa: F401 (autouse)

POWER_RTOL = {21: 1e-6, 64: 3e-6}
LOG10_P_BAND = {21: 2e-5, 64: 3e-4}
NSCORES_SAME_SHARE = 0.999
CASES = [(11, 10, make_panel, 13), (11, 10, make_chromosome, 3), (5, 4, make_panel, 7),
         (1, 6, make_panel, 3)]
# the widest panel the kernels take, mix draws only (threefry ranks the
# same way, tests/test_torch_mc_window.py)
WIDE = [(32, 32, make_panel, 5, "mix")]


def _windows(asize, bsize, maker, seed):
    if maker is make_panel:
        return _phase1(asize, bsize, seed=seed)
    from divergence_tpu_torch.core.windows import plan_windows
    from divergence_tpu_torch.kernels import css as tcss

    pos, am, bm = maker(500, 25_000, asize, bsize, seed)
    plan = plan_windows(pos, 25_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    s, d, v = tcss.css_phase1(torch.from_numpy(np.concatenate([am, bm], axis=1)),
                              plan.lo[ids], plan.npos[ids], asize, bsize)
    vn = v.numpy()
    return d[v], s[v].numpy(), np.zeros(int(vn.sum()), np.int64), plan.slot[ids][vn]


def band(table: dict, m: int) -> float:
    """The band of the smallest measured panel size >= m."""
    return table[min(k for k in table if k >= m)]


def assert_approx_in_band(got, want, m):
    same = got.nscores == want.nscores
    assert same.mean() >= NSCORES_SAME_SHARE, int((~same).sum())
    assert (got.hits == 0).all()
    dl = np.abs(np.log10(got.pvals[same]) - np.log10(want.pvals[same]))
    assert dl.max(initial=0.0) <= band(LOG10_P_BAND, m), dl.max()
    assert ((got.pvals > 0) & (got.pvals <= 1)).all()


@pytest.mark.parametrize("stream", ["shared", "window"])
@pytest.mark.parametrize("asize,bsize,maker,seed,bitgen",
                         [c + (g,) for c in CASES for g in ("mix", "threefry")] + WIDE)
def test_null_power_sums_within_band(asize, bsize, maker, seed, stream, bitgen):
    dist, _, chroms, slots = _windows(asize, bsize, maker, seed)
    jkey, tkey = _keys(7)
    B = len(slots)
    if stream == "window":
        jk = jperm.window_keys(jkey, jnp.asarray(chroms), jnp.asarray(slots))
        tk = rng.window_keys(tkey, chroms, slots)
    else:
        jk, tk = jkey, tkey
    want = np.asarray(jperm._null_power_sums(jnp.asarray(np.asarray(dist)), jk, asize, bsize,
                                             512, 2, jnp.int32(3), bitgen=bitgen,
                                             stream=stream))
    got = tperm.null_power_sums(dist, tk, asize, bsize, 512, 3, 2, stream, bitgen).numpy()
    assert got.shape == want.shape == (2, 3, B) and got.dtype == np.float64
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() <= band(POWER_RTOL, asize + bsize), rel.max()


@pytest.mark.parametrize("stream", ["shared", "window"])
@pytest.mark.parametrize("asize,bsize,maker,seed,bitgen",
                         [c + (g,) for c in CASES for g in ("mix", "threefry")] + WIDE)
def test_approx_matches_jax(asize, bsize, maker, seed, stream, bitgen):
    dist, scores, chroms, slots = _windows(asize, bsize, maker, seed)
    jkey, tkey = _keys(7)
    want = jperm.approx_significance(np.asarray(dist), scores, asize, bsize, jkey,
                                     chunk=512, chroms=chroms, slots=slots, bitgen=bitgen,
                                     stream=stream)
    got = tperm.approx_significance(dist, scores, asize, bsize, tkey, chunk=512,
                                    chroms=chroms, slots=slots, bitgen=bitgen,
                                    stream=stream)
    assert_approx_in_band(got, want, asize + bsize)
    assert (got.nscores >= 1024).all()


@pytest.mark.parametrize("stream", ["shared", "window"])
def test_approx_escalation_matches_jax(stream):
    """After tests/test_approx_pvalues.py:126: forced escalation extends
    the chunk-indexed streams (2 rounds: 2 -> 4 -> 8 chunks), lands on
    the single-shot fit over the same chunks, and stays in JAX's band."""
    dist, scores, chroms, slots = _windows(11, 10, make_panel, 13)
    jkey, tkey = _keys(17)
    kw = dict(chunk=256, chroms=chroms, slots=slots, stream=stream)
    forced = tperm.approx_significance(dist, scores, 11, 10, tkey, n_chunks=2,
                                       stable_log10=-1.0, max_rounds=2, **kw)
    assert (forced.nscores == 2 * 256 * 4).all(), forced.nscores
    single = tperm.approx_significance(dist, scores, 11, 10, tkey, n_chunks=8,
                                       max_rounds=0, stable_log10=1e9, **kw)
    # the same 8 chunks' float64 sums, grouped ((2 + 2) + 4) against one
    # running sum: round-off, which the fitted variance's cancellation
    # lifts to ~1e-11 relative in p on these significant windows
    np.testing.assert_allclose(forced.pvals, single.pvals, rtol=1e-10)
    want = jperm.approx_significance(np.asarray(dist), scores, 11, 10, jkey, n_chunks=2,
                                     stable_log10=-1.0, max_rounds=2, **kw)
    assert_approx_in_band(forced, want, 21)


def test_approx_escalates_unstable_windows_only():
    """Round 0 gives every window n_chunks chunks; only windows whose
    half-vs-full drift exceeds stable_log10 spend more."""
    dist, scores, chroms, slots = _windows(11, 10, make_chromosome, 3)
    _, tkey = _keys(7)
    res = tperm.approx_significance(dist, scores, 11, 10, tkey, chunk=512, chroms=chroms,
                                    slots=slots, stream="window")
    assert set(np.unique(res.nscores)) <= {1024, 2048, 4096, 8192}
    assert (res.nscores == 1024).any() and (res.nscores > 1024).any()


def test_pearson3_tail_equals_jax():
    rs = np.random.default_rng(0)
    n = 1024.0
    s1 = rs.normal(0, 5, 200)
    s2 = s1**2 / n + rs.uniform(0.1, 3.0, 200) * n
    s3 = rs.normal(0, 50, 200)
    s3[:20] = s1[:20] ** 3 / n**2 + 3 * (s1[:20] / n) * (s2[:20] - s1[:20] ** 2 / n)
    scores = rs.normal(0, 3, 200)
    assert np.array_equal(tperm._pearson3_tail(scores, s1, s2, s3, n),
                          jperm._pearson3_tail(scores, s1, s2, s3, n))


def test_approx_of_no_windows():
    _, tkey = _keys(0)
    for stream in ("shared", "window"):
        res = tperm.approx_significance(torch.zeros((0, 4, 4)), np.zeros(0), 2, 2, tkey,
                                        stream=stream)
        assert res.pvals.shape == (0,) and res.nscores.dtype == np.int64


def test_plain_entry_equals_dispatch_on_cpu():
    """approx_significance_plain (the card's twin) is the CPU path."""
    dist, scores, chroms, slots = _windows(5, 4, make_panel, 7)
    _, tkey = _keys(3)
    a = tperm.approx_significance(dist, scores, 5, 4, tkey, chunk=512, chroms=chroms,
                                  slots=slots, stream="window")
    b = tperm.approx_significance_plain(dist, scores, 5, 4, tkey, chunk=512, chroms=chroms,
                                        slots=slots, stream="window")
    assert np.array_equal(a.pvals, b.pvals) and np.array_equal(a.nscores, b.nscores)
