"""Drosophila mode in the port (frequency tracks: two pseudo-individuals,
reference statistics/css/css.c:245-264) against the JAX package run on
the CPU: dissimilarity_freq, its per-window batched form, css_phase1 in
all three MDS modes against css_gather_all, and run_css / run_css_multi
against the JAX engine and the serial oracle.

Tolerances, relative to max(|reference|, 1): exact (float64) 1e-9; fast
(float32) the CMDS band of tests/test_torch_css.py (rtol 2e-3, atol 1e-4)
for mds 0 and the measured SMACOF band of tests/test_torch_smacof.py for
mds 1 and 2.  The permutation p is 1 on every scored window: both
permutations of two pseudo-individuals score alike (the reference's
quirk, tests/test_engines.py::test_drosophila_engine_matches_oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.config import CssConfig as JCssConfig
from divergence_tpu.config import WindowConfig as JWindowConfig
from divergence_tpu.engine import run_css as jax_run_css
from divergence_tpu.engine.css_engine import run_css_multi as jax_run_css_multi
from divergence_tpu.engine.snp import SnpPair as JSnpPair
from divergence_tpu.kernels import css as jcss
from divergence_tpu.oracle import reference as orc
from divergence_tpu_torch import rng
from divergence_tpu_torch.config import CssConfig, WindowConfig
from divergence_tpu_torch.core.windows import plan_windows
from divergence_tpu_torch.engine import SnpPair, run_css, run_css_multi
from divergence_tpu_torch.kernels import css as tcss
from divergence_tpu_torch.tools.synth import make_freq_chromosome
from test_torch_smacof import assert_in_fast_band, one_torch_thread  # noqa: F401 (autouse)

WCFG = {"wsize": 2500, "wstep": 500}
REGION = 20_000


def _close(got, want, tol=1e-9):
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max(initial=0.0) <= tol, err.max()


def _windows(npos=300, region=REGION, seed=2):
    pos, fa, fb = make_freq_chromosome(npos, region, seed)
    plan = plan_windows(pos, region, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    return pos, fa, fb, plan.lo[ids], plan.npos[ids], plan.slot[ids]


def _gather(fa, fb, lo, npos):
    P = 32
    while P < npos.max():
        P *= 2
    offs = np.arange(P)[None, :]
    mask = offs < npos[:, None]
    idx = np.where(mask, lo[:, None] + offs, 0)
    return fa[idx], fb[idx], mask


def test_make_freq_chromosome():
    pos, fa, fb = make_freq_chromosome(500, 10_000, 4)
    assert pos.dtype == np.int64 and len(np.unique(pos)) == 500
    assert (np.diff(pos) > 0).all() and pos.min() >= 1 and pos.max() < 10_000
    assert fa.shape == fb.shape == (500, 1)
    assert ((fa >= 0) & (fa < 1)).all() and not np.array_equal(fa, fb)
    again = make_freq_chromosome(500, 10_000, 4)
    assert all(np.array_equal(a, b) for a, b in zip(again, (pos, fa, fb)))


def test_dissimilarity_freq_matches_jax(rng):
    B, P = 7, 32
    fa = rng.random((B, P, 1))
    fb = rng.random((B, P, 1))
    npos = np.array([0, 1, 5, 17, 32, 31, 2])
    mask = np.arange(P)[None, :] < npos[:, None]
    want = np.asarray(jcss.dissimilarity_freq(
        jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(npos), jnp.asarray(mask)))
    got = tcss.dissimilarity_freq(torch.from_numpy(fa), torch.from_numpy(fb),
                                  torch.from_numpy(npos), torch.from_numpy(mask))
    assert got.dtype == torch.float64 and got.shape == (B, 2, 2)
    _close(got.numpy(), want, 1e-15)
    assert (got[:, 0, 0] == 0).all() and (got[0] == 0).all()


def test_dissimilarity_freq_windows_batches(monkeypatch):
    """The per-window form over several batches equals the gathered JAX
    metric (float32 frequencies are summed in float64 too)."""
    _, fa, fb, lo, npos, _ = _windows(npos=600, seed=3)
    ga, gb, mask = _gather(fa, fb, lo, npos)
    want = np.asarray(jcss.dissimilarity_freq(
        jnp.asarray(ga), jnp.asarray(gb), jnp.asarray(npos), jnp.asarray(mask)))
    monkeypatch.setattr(tcss, "_COUNT_BATCH_ELEMS", 64 * 5)     # several batches
    got = tcss.dissimilarity_freq_windows(torch.from_numpy(fa[:, 0]),
                                          torch.from_numpy(fb[:, 0]),
                                          torch.from_numpy(lo), torch.from_numpy(npos))
    _close(got.numpy(), want, 1e-15)
    got32 = tcss.dissimilarity_freq_windows(torch.from_numpy(fa[:, 0]).float(),
                                            torch.from_numpy(fb[:, 0]).float(),
                                            torch.from_numpy(lo), torch.from_numpy(npos))
    assert got32.dtype == torch.float64
    empty = tcss.dissimilarity_freq_windows(torch.zeros(4), torch.zeros(4),
                                            torch.zeros(0, dtype=torch.int64),
                                            torch.zeros(0, dtype=torch.int64))
    assert empty.shape == (0, 2, 2)


def test_drosophila_window_batch_vs_oracle(rng):
    """tests/test_css_kernel.py::test_drosophila_window_batch through the
    port: CMDS at m = 2 (an exactly-zero second eigenvalue)."""
    B, P = 4, 32
    fa = rng.random((B * P, 1))
    fb = rng.random((B * P, 1))
    npos = rng.integers(2, P + 1, size=B)
    lo = np.arange(B) * P
    s, d, v = tcss.css_phase1(torch.from_numpy(np.concatenate([fa, fb], 1)), lo, npos,
                              1, 1, drosophila=True)
    assert d.shape == (B, 2, 2) and v.all()
    for b in range(B):
        sl = slice(lo[b], lo[b] + npos[b])
        score, dist = orc.window_css(fa[sl], fb[sl], drosophila=True, mds=0)
        assert float(s[b]) == pytest.approx(score, rel=1e-8)
        np.testing.assert_allclose(d[b].numpy(), dist, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("mds", [0, 1, 2])
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_drosophila_phase1_matches_jax(mds, prec):
    """css_phase1(drosophila=True) against the JAX gather program, with a
    multi-column panel: drosophila reads the first column of each group."""
    fast = prec == "fast"
    _, fa, fb, lo, npos, slots = _windows(npos=500, seed=5)
    extra = np.random.default_rng(0).random((len(fa), 2))
    vals = np.concatenate([fa, extra[:, :1], fb, extra[:, 1:]], axis=1)   # 2 + 2 columns
    Bp = 64
    rows = np.zeros((3, -(-len(lo) // Bp) * Bp), dtype=np.int64)
    rows[:, :len(lo)] = lo, npos, slots
    P = 32
    while P < npos.max():
        P *= 2
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 9)
    js, jd, jv = jcss.css_gather_all(
        jnp.asarray(vals[:, :2]), jnp.asarray(vals[:, 2:]), jnp.asarray(rows), jkey,
        Bp=Bp, P=P, asize=2, bsize=2, drosophila=True, mds=mds, fast=fast,
    )
    n = len(lo)
    js, jd, jv = np.asarray(js)[:n], np.asarray(jd)[:n], np.asarray(jv)[:n]
    ts, td, tv = tcss.css_phase1(
        torch.from_numpy(vals), lo, npos, 2, 2, fast, mds=mds,
        key=rng.fold_in(rng.prng_key(3), 9), slots=slots, drosophila=True,
    )
    ts, td, tv = ts.numpy(), td.numpy(), tv.numpy()
    assert td.shape == (n, 2, 2)
    assert np.array_equal(tv, jv) and tv.sum() > 20
    assert np.array_equal(np.isnan(ts), np.isnan(js)) and not np.isnan(ts).any()
    if prec == "exact":
        _close(ts, js)
        _close(td[tv], jd[tv])
    elif mds == 0:
        np.testing.assert_allclose(ts, js, rtol=2e-3, atol=1e-4)
    else:
        assert_in_fast_band(ts[jv], js[jv], mds)


def _pair(seed=7, npos=300):
    pos, fa, fb = make_freq_chromosome(npos, REGION, seed)
    return pos, fa, fb


@pytest.mark.parametrize("mds", [0, 1])
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_css_drosophila_matches_jax(mds, prec):
    pos, fa, fb = _pair()
    kw = dict(drosophila=True, mds=mds, mc_runs=500, precision=prec, seed=1)
    s, p = run_css(SnpPair(pos, fa, fb), REGION,
                   CssConfig(window=WindowConfig(**WCFG), **kw), device="cpu", seqid="2L")
    js, jp = jax_run_css(JSnpPair(pos, fa, fb), REGION,
                         JCssConfig(window=JWindowConfig(**WCFG), **kw), seqid="2L")
    assert np.array_equal(s != 0, js != 0) and (s != 0).sum() > 20
    if prec == "exact":
        _close(s, js)
    else:
        np.testing.assert_allclose(s, js, rtol=2e-3, atol=1e-4)
    nz = s != 0
    assert (p[nz] == 1.0).all() and np.array_equal(p, jp)


def test_run_css_drosophila_matches_oracle():
    """tests/test_engines.py::test_drosophila_engine_matches_oracle."""
    pos, fa, fb = _pair(seed=8)
    cfg = CssConfig(window=WindowConfig(**WCFG), drosophila=True, mc_runs=500)
    scores, pvals = run_css(SnpPair(pos, fa, fb), REGION, cfg, device="cpu")
    want_s, want_p = orc.compute_css(
        fa.ravel(), fb.ravel(), pos, pos, REGION, 2500, 500, runs=500, drosophila=True,
    )
    np.testing.assert_allclose(scores, want_s, rtol=1e-9, atol=1e-12)
    nz = scores != 0
    assert nz.any()
    np.testing.assert_allclose(pvals[nz], 1.0)
    np.testing.assert_allclose(want_p[nz], 1.0)


def test_run_css_multi_drosophila_matches_jax():
    genome = {f"chr{k}": (*_pair(seed=20 + k, npos=200 + 50 * k), REGION + 2000 * k)
              for k in range(3)}
    cfg = CssConfig(window=WindowConfig(**WCFG), drosophila=True, mds=1, mc_runs=300)
    jcfg = JCssConfig(window=JWindowConfig(**WCFG), drosophila=True, mds=1, mc_runs=300)
    got = run_css_multi({k: (SnpPair(p, a, b), r) for k, (p, a, b, r) in genome.items()},
                        cfg, device="cpu")
    want = jax_run_css_multi(
        {k: (JSnpPair(p, a, b), r) for k, (p, a, b, r) in genome.items()}, jcfg)
    for seqid in want:
        _close(got[seqid][0], want[seqid][0])
        assert np.array_equal(got[seqid][1], want[seqid][1])
        assert (got[seqid][1][got[seqid][0] != 0] == 1.0).all()


def test_fast_mode_m2_has_no_nan():
    """float32 CMDS at m = 2: the exactly-zero second eigenvalue rounds to
    dust, which the float32 clamp (1e-5 relative) keeps from becoming NaN."""
    _, fa, fb, lo, npos, _ = _windows(npos=2000, region=100_000, seed=11)
    s, _, v = tcss.css_phase1(torch.from_numpy(np.concatenate([fa, fb], 1)), lo, npos,
                              1, 1, fast=True, drosophila=True)
    assert v.all() and not s.isnan().any() and (s > 0).all()
