"""The port's CPU engines against the JAX engines on the differential fuzz
lane's panels (divergence_tpu_torch/tools/fuzz_ref.py ``draw_trial``):
the default lane's trials t0-t7 from seed 5000 (random panel sizes to
13 + 13, three genotype mixes with missing codes, drosophila frequency
tracks on t5, window steps to wsize) and the big-panel lane's first two
trials (m = 133 and 158, off the FET LUT).

Relative to max(|ref|, 1): FET exact 1e-12, fast 1e-5, scores and
stddev, the zero pattern equal; CSS by CMDS (the lane's draws give mds
0 or 2; SMACOF is held to the oracle by the lane itself) exact 1e-9, fast
rtol 2e-3 / atol 1e-4, on windows whose eigengap exceeds 1e-6, the zero
and NaN patterns equal.  A trial with no slot gives empty columns on
both sides."""

import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.config import CssConfig as JCssConfig
from divergence_tpu.config import FetConfig as JFetConfig
from divergence_tpu.config import WindowConfig as JWindowConfig
from divergence_tpu.engine import run_css as jax_run_css
from divergence_tpu.engine import run_fet as jax_run_fet
from divergence_tpu.engine.snp import SnpPair as JSnpPair
from divergence_tpu_torch.config import CssConfig, FetConfig, WindowConfig
from divergence_tpu_torch.core.windows import plan_windows
from divergence_tpu_torch.engine import SnpPair, run_css, run_fet
from divergence_tpu_torch.kernels import css as tcss
from divergence_tpu_torch.tools.fuzz_ref import draw_trial
from test_torch_css import FAST_ATOL, FAST_RTOL, GAP_BOUND, eigengap
from test_torch_smacof import one_torch_thread  # noqa: F401 (autouse)

TOL_FET = {"exact": 1e-12, "fast": 1e-5}
TOL_CSS_EXACT = 1e-9
# (seed, big, trial index): the lane's default trials t0-t7 and the first
# two big-panel trials
ENGINE_TRIALS = [(5000 + t, False, t) for t in range(8)] + [(5000, True, 0), (5001, True, 1)]


def _trial(seed, big, t):
    rng = np.random.default_rng(seed)
    dros = t % 6 == 5
    positions, amat, bmat, _, _, wsize, wstep = draw_trial(rng, dros, big=big)
    return dros, positions, amat, bmat, wsize, wstep, int(positions[-1]) + 1


def _slot_gap(positions, amat, bmat, regend, wsize, wstep):
    """Each slot's eigengap (inf where the window has no third eigenvalue
    or no counts), from the plain counts."""
    plan = plan_windows(positions, regend, wsize, wstep)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    gap = np.full(regend // wstep, np.inf)
    if len(ids) and regend // wstep:
        dis = tcss.dissimilarity_plain(torch.from_numpy(np.concatenate([amat, bmat], axis=1)),
                                       torch.from_numpy(plan.lo[ids]),
                                       torch.from_numpy(plan.npos[ids]))
        gap[plan.slot[ids]] = eigengap(dis)
    return gap


def _rel_err(got, want):
    return np.abs(got - want) / np.maximum(np.abs(want), 1.0)


@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("seed,big,t", ENGINE_TRIALS,
                         ids=[f"{s}{'-big' if b else ''}" for s, b, _ in ENGINE_TRIALS])
def test_engines_match_jax_on_lane_panels(seed, big, t, prec):
    dros, positions, amat, bmat, wsize, wstep, regend = _trial(seed, big, t)
    w, jw = WindowConfig(wsize=wsize, wstep=wstep), JWindowConfig(wsize=wsize, wstep=wstep)
    pair, jpair = SnpPair(positions, amat, bmat), JSnpPair(positions, amat, bmat)
    if not dros:
        s, d = run_fet(pair, regend, FetConfig(window=w, precision=prec), device="cpu")
        js, jd = jax_run_fet(jpair, regend, JFetConfig(window=jw, precision=prec))
        assert s.shape == js.shape == (regend // wstep,)
        assert np.array_equal(s != 0, js != 0)
        assert _rel_err(s, js).max(initial=0) <= TOL_FET[prec]
        assert _rel_err(d, jd).max(initial=0) <= TOL_FET[prec]
    kw = dict(mc_threshold=1, mc_runs=2, mds=0, drosophila=dros, precision=prec)
    c, _ = run_css(pair, regend, CssConfig(window=w, **kw), device="cpu")
    jc, _ = jax_run_css(jpair, regend, JCssConfig(window=jw, **kw))
    assert c.shape == jc.shape == (regend // wstep,)
    assert np.array_equal(c != 0, jc != 0)
    gap_ok = np.ones(len(jc), bool)
    if not dros:
        gap_ok = _slot_gap(positions, amat, bmat, regend, wsize, wstep) > GAP_BOUND
    assert np.array_equal(np.isnan(c[gap_ok]), np.isnan(jc[gap_ok]))
    ok = gap_ok & (jc != 0) & ~np.isnan(jc)
    if prec == "exact":
        assert _rel_err(c[ok], jc[ok]).max(initial=0) <= TOL_CSS_EXACT
    else:
        np.testing.assert_allclose(c[ok], jc[ok], rtol=FAST_RTOL, atol=FAST_ATOL)


