"""The port's CSS engine (divergence_tpu_torch.engine.css_engine, CPU
path) against the JAX engine: run_css and run_css_multi in both
precisions, all three MDS modes and every phase-2 option (approx mode,
the window streams, threefry draws, the native evaluator), the run
counters, the empty region and multi against looped.

Tolerances, relative to max(|reference|, 1): exact 1e-9 on windows with
eigengap above 1e-6, fast the JAX package's fast-vs-exact band (rtol
2e-3, atol 1e-4) for CMDS and the measured SMACOF band of
tests/test_torch_smacof.py for mds 1 and 2; valid and NaN patterns
identical; p-values equal except on near-tie windows, which
tests/test_torch_mc.py explains; approx p within the band of
tests/test_torch_approx.py."""

import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu import native
from divergence_tpu.config import CssConfig as JCssConfig
from divergence_tpu.config import MdsAlgorithm as JMds
from divergence_tpu.config import WindowConfig as JWindowConfig
from divergence_tpu.engine import run_css as jax_run_css
from divergence_tpu.engine.css_engine import run_css_multi as jax_run_css_multi
from divergence_tpu.engine.snp import SnpPair as JSnpPair
from divergence_tpu.utils.summary import RunSummary as JRunSummary
from divergence_tpu_torch.config import CssConfig, MdsAlgorithm, SmacofConfig, WindowConfig
from divergence_tpu_torch.engine import SnpPair, run_css, run_css_multi
from divergence_tpu_torch.tools.synth import make_panel
from divergence_tpu_torch.utils.summary import RunSummary
from test_torch_approx import LOG10_P_BAND
from test_torch_smacof import assert_in_fast_band, one_torch_thread  # noqa: F401 (autouse)

REGEND = 20_000
MAX_P_DIFF_SHARE = 0.02   # near-tie windows allowed, relative to scored windows


def _cfgs(prec, **kw):
    wkw = kw.pop("window", {})
    return (
        CssConfig(window=WindowConfig(**wkw), precision=prec, **kw),
        JCssConfig(window=JWindowConfig(**wkw), precision=prec, **kw),
    )


def assert_scores_close(got, want, prec):
    assert got.shape == want.shape and got.dtype == np.float64
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got != 0, want != 0)
    ok = ~np.isnan(want)
    if prec == "exact":
        err = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1.0)
        assert err.max(initial=0.0) <= 1e-9, err.max()
    else:
        np.testing.assert_allclose(got[ok], want[ok], rtol=2e-3, atol=1e-4)


def assert_pvals_match(got, want):
    scored = want != 0
    differ = (got != want) & scored
    assert differ.sum() <= MAX_P_DIFF_SHARE * scored.sum(), differ.sum()
    assert np.array_equal(got != 0, want != 0)


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_css_matches_jax(panel, prec):
    _, _, _, _, positions, amat, bmat = panel
    cfg, jcfg = _cfgs(prec, mc_runs=2000, seed=4)
    summary, jsummary = RunSummary(), JRunSummary()
    s, p = run_css(SnpPair(positions, amat, bmat), REGEND, cfg, device="cpu",
                   summary=summary, seqid="chrT")
    js, jp = jax_run_css(JSnpPair(positions, amat, bmat), REGEND, jcfg,
                         summary=jsummary, seqid="chrT")
    assert s.shape == (REGEND // 500,)
    assert (s != 0).sum() > 10
    assert_scores_close(s, js, prec)
    assert_pvals_match(p, jp)
    assert ((p > 0) & (p <= 1))[s != 0].all()
    for name in ("windows_planned", "windows_scored", "windows_discarded"):
        assert summary.counters[name] == jsummary.counters[name], name
    if np.array_equal(p, jp):
        assert summary.counters["mc_permutations"] == jsummary.counters["mc_permutations"]
    assert {"css_dispatch", "css_phase1_sync", "css_collect", "css_mc"} <= set(summary.timings_s)


def _genome(panels=((11, 10), (11, 10), (5, 4)), npos=300, region=15_000):
    genome = {}
    for i, (a, b) in enumerate(panels):
        pos, am, bm = make_panel(npos + 40 * i, region, a, b, seed=60 + i)
        genome[f"chr{i + 1}"] = (pos, am, bm, region + 1000 * i)
    return genome


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_css_multi_matches_jax(prec):
    """Three chromosomes in two panel-size groups (one MC per group)."""
    genome = _genome()
    cfg, jcfg = _cfgs(prec, mc_runs=1500, mc_chunk=128, window={"wsize": 2000, "wstep": 400})
    summary, jsummary = RunSummary(), JRunSummary()
    got = run_css_multi(
        {k: (SnpPair(p, a, b), r) for k, (p, a, b, r) in genome.items()},
        cfg, device="cpu", summary=summary,
    )
    want = jax_run_css_multi(
        {k: (JSnpPair(p, a, b), r) for k, (p, a, b, r) in genome.items()},
        jcfg, summary=jsummary,
    )
    assert sorted(got) == sorted(want)
    for seqid in want:
        assert_scores_close(got[seqid][0], want[seqid][0], prec)
        assert_pvals_match(got[seqid][1], want[seqid][1])
    for name in ("windows_planned", "windows_scored", "windows_discarded"):
        assert summary.counters[name] == jsummary.counters[name], name


def test_multi_equals_per_chromosome():
    """The shared stream is keyed by (seed, chunk) alone: a chromosome
    inside run_css_multi gets exactly its run_css result."""
    genome = _genome(panels=((11, 10), (11, 10), (6, 6)))
    cfg = CssConfig(mc_runs=1000, seed=2)
    multi = run_css_multi(
        {k: (SnpPair(p, a, b), r) for k, (p, a, b, r) in genome.items()},
        cfg, device="cpu",
    )
    for seqid, (p, a, b, r) in genome.items():
        s, pv = run_css(SnpPair(p, a, b), r, cfg, device="cpu", seqid=seqid)
        assert np.array_equal(s, multi[seqid][0])
        assert np.array_equal(pv, multi[seqid][1])


def test_empty_region_gives_zero_tracks():
    pos = np.array([50_000, 60_000], dtype=np.int64)
    mat = np.full((2, 3), 3, dtype=np.int16)
    s, p = run_css(SnpPair(pos, mat, mat), 10_000, CssConfig(), device="cpu")
    assert s.shape == (20,) and not s.any() and not p.any()
    s, p = run_css(SnpPair(pos, mat, mat), 100, CssConfig(), device="cpu")
    assert s.shape == (0,)
    assert run_css_multi({}, CssConfig(), device="cpu") == {}


def test_all_windows_discarded_gives_zero_tracks():
    pos = np.arange(1, 200, dtype=np.int64) * 50
    mat = np.full((199, 3), -10000, dtype=np.int16)
    summary = RunSummary()
    s, p = run_css(SnpPair(pos, mat, mat), 10_000, CssConfig(), device="cpu",
                   summary=summary)
    assert not s.any() and not p.any()
    assert summary.counters["windows_discarded"] == summary.counters["windows_planned"] > 0
    assert summary.counters["mc_permutations"] == 0


NEW_OPTIONS = [
    {"p_mode": "approx"},
    {"p_mode": "approx", "mc_stream": "window"},
    {"mc_stream": "window"},
    {"mc_stream": "window", "rng": "threefry"},
    {"rng": "threefry"},
    {"perm_backend": "native"},
]


def assert_new_option_pvals_match(got, want, kw):
    """approx: LOG10_P_BAND (tests/test_torch_approx.py) on >= 99.9 % of
    the scored windows; native: equal (float64 in mc_native's order, when
    the JAX package's native build exists); the float32 MCs: equal except
    on near ties (assert_pvals_match)."""
    assert np.array_equal(got != 0, want != 0)
    scored = want != 0
    if kw.get("p_mode") == "approx":
        dl = np.abs(np.log10(got[scored]) - np.log10(want[scored]))
        assert (dl > LOG10_P_BAND[21]).sum() <= 1e-3 * scored.sum(), dl.max()
    elif kw.get("perm_backend") == "native" and native.native_available():
        assert np.array_equal(got, want)
    else:
        assert_pvals_match(got, want)


@pytest.fixture(scope="module")
def gap_panel(panel):
    """The conftest panel with every genotype of 8-12.5 kbp missing: the
    windows inside the gap are discarded, and the JAX engine carries them
    through its MC as padded rows while the port leaves them out."""
    _, _, _, _, positions, amat, bmat = panel
    gap = (positions >= 8_000) & (positions < 12_500)
    amat, bmat = amat.copy(), bmat.copy()
    amat[gap] = -10000
    bmat[gap] = -10000
    return positions, amat, bmat


@pytest.mark.parametrize("kw", NEW_OPTIONS, ids=[str(k) for k in NEW_OPTIONS])
def test_new_options_match_jax(gap_panel, kw):
    """Each run-css option the port runs since the per-window streams and
    approx mode were ported, against the JAX engine: scores 1e-9 (exact),
    p by the option's rule, the run counters equal.  The window-stream
    results on the valid windows equal JAX's although JAX's MC also holds
    the discarded windows' rows: a window's stream is keyed by its own
    (chromosome, slot)."""
    positions, amat, bmat = gap_panel
    cfg, jcfg = _cfgs("exact", mc_runs=2000, seed=4, **kw)
    summary, jsummary = RunSummary(), JRunSummary()
    s, p = run_css(SnpPair(positions, amat, bmat), REGEND, cfg, device="cpu",
                   summary=summary, seqid="chrT")
    js, jp = jax_run_css(JSnpPair(positions, amat, bmat), REGEND, jcfg,
                         summary=jsummary, seqid="chrT")
    assert (s != 0).sum() > 10 and jsummary.counters["windows_discarded"] > 0
    assert_scores_close(s, js, "exact")
    assert_new_option_pvals_match(p, jp, kw)
    assert ((p > 0) & (p <= 1))[s != 0].all()
    for name in ("windows_planned", "windows_scored", "windows_discarded"):
        assert summary.counters[name] == jsummary.counters[name], name
    if np.array_equal(p, jp) or kw.get("p_mode") == "approx":
        assert summary.counters["mc_permutations"] == jsummary.counters["mc_permutations"]


@pytest.mark.parametrize("kw", NEW_OPTIONS, ids=[str(k) for k in NEW_OPTIONS])
def test_new_options_multi_match_jax(kw):
    """Three chromosomes in two panel-size groups: the window streams are
    keyed by (chromosome, slot) across the genome-wide phase 2."""
    genome = _genome()
    cfg, jcfg = _cfgs("exact", mc_runs=1500, mc_chunk=128,
                      window={"wsize": 2000, "wstep": 400}, **kw)
    got = run_css_multi(
        {k: (SnpPair(p, a, b), r) for k, (p, a, b, r) in genome.items()},
        cfg, device="cpu",
    )
    want = jax_run_css_multi(
        {k: (JSnpPair(p, a, b), r) for k, (p, a, b, r) in genome.items()}, jcfg,
    )
    for seqid in want:
        assert_scores_close(got[seqid][0], want[seqid][0], "exact")
        assert_new_option_pvals_match(got[seqid][1], want[seqid][1], kw)
    single = run_css(SnpPair(*genome["chr3"][:3]), genome["chr3"][3], cfg,
                     device="cpu", seqid="chr3")
    assert np.array_equal(single[1], got["chr3"][1])


PORTED = [
    {"mds": MdsAlgorithm.SMACOF},
    {"mds": MdsAlgorithm.CMDS_SMACOF},
    {"drosophila": True},
]


@pytest.mark.parametrize("kw", PORTED, ids=[str(k) for k in PORTED])
def test_ported_options_run(panel, kw):
    """The SMACOF modes and drosophila mode run (they raised before the
    port covered them); drosophila reads the first column of each group
    as its value track."""
    _, _, _, _, positions, amat, bmat = panel
    cfg = CssConfig(mc_runs=300, smacof=SmacofConfig(max_iters=30), **kw)
    s, p = run_css(SnpPair(positions, amat, bmat), REGEND, cfg, device="cpu")
    assert s.shape == p.shape == (REGEND // 500,)
    assert (s != 0).sum() > 10 and not np.isnan(s).any()
    assert ((p > 0) & (p <= 1))[s != 0].all()


@pytest.mark.parametrize("mds", [1, 2])
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_css_smacof_matches_jax(panel, mds, prec):
    _, _, _, _, positions, amat, bmat = panel
    cfg, jcfg = _cfgs(prec, mc_runs=2000, seed=6, mds=mds)
    summary, jsummary = RunSummary(), JRunSummary()
    s, p = run_css(SnpPair(positions, amat, bmat), REGEND, cfg, device="cpu",
                   summary=summary, seqid="chrS")
    js, jp = jax_run_css(JSnpPair(positions, amat, bmat), REGEND, jcfg,
                         summary=jsummary, seqid="chrS")
    assert (s != 0).sum() > 10
    if prec == "exact":
        assert_scores_close(s, js, prec)
        assert_pvals_match(p, jp)
    else:
        assert np.array_equal(np.isnan(s), np.isnan(js))
        assert np.array_equal(s != 0, js != 0)
        assert_in_fast_band(s[js != 0], js[js != 0], mds)
        assert np.array_equal(p != 0, jp != 0)
    for name in ("windows_planned", "windows_scored", "windows_discarded"):
        assert summary.counters[name] == jsummary.counters[name], name


def test_run_css_multi_smacof_matches_jax():
    """SMACOF restarts are keyed by (seed, chromosome, slot): three
    chromosomes in one run_css_multi get the JAX package's scores."""
    genome = _genome()
    cfg, jcfg = _cfgs("exact", mc_runs=1000, mc_chunk=128, mds=1)
    got = run_css_multi(
        {k: (SnpPair(p, a, b), r) for k, (p, a, b, r) in genome.items()},
        cfg, device="cpu",
    )
    want = jax_run_css_multi(
        {k: (JSnpPair(p, a, b), r) for k, (p, a, b, r) in genome.items()}, jcfg,
    )
    for seqid in want:
        assert_scores_close(got[seqid][0], want[seqid][0], "exact")
        assert_pvals_match(got[seqid][1], want[seqid][1])
    single = run_css(SnpPair(*genome["chr2"][:3]), genome["chr2"][3], cfg,
                     device="cpu", seqid="chr2")
    assert np.array_equal(single[0], got["chr2"][0])


def test_config_enum_matches_jax():
    assert [(e.name, int(e)) for e in MdsAlgorithm] == [(e.name, int(e)) for e in JMds]


def test_cuda_device_without_cuda_raises(panel):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, _, _, positions, amat, bmat = panel
    with pytest.raises(RuntimeError, match="is_available"):
        run_css(SnpPair(positions, amat, bmat), REGEND, device="cuda")
