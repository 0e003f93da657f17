"""The port's engine (divergence_tpu_torch.engine, CPU path) against the JAX
engine: run_fet and run_fet_multi, exact and fast precision.

Tolerances, relative to max(|reference|, 1): exact 1e-12, fast 1e-5."""

import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.config import FetConfig as JFetConfig
from divergence_tpu.config import WindowConfig as JWindowConfig
from divergence_tpu.engine import run_fet as jax_run_fet
from divergence_tpu.engine.fet_engine import run_fet_multi as jax_run_fet_multi
from divergence_tpu.engine.snp import SnpPair as JSnpPair
from divergence_tpu_torch import FetConfig, WindowConfig
from divergence_tpu_torch.engine import SnpPair, run_fet, run_fet_multi
from divergence_tpu_torch.tools.synth import make_panel
from divergence_tpu_torch.utils.summary import RunSummary

TOL = {"exact": 1e-12, "fast": 1e-5}
REGEND = 20_000


def assert_close(got, want, tol):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max(initial=0.0) <= tol, (err.max(), np.argmax(err))


def _cfgs(prec, **kw):
    wkw = kw.pop("window", {})
    return (
        FetConfig(window=WindowConfig(**wkw), precision=prec, **kw),
        JFetConfig(window=JWindowConfig(**wkw), precision=prec, **kw),
    )


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_fet_matches_jax(panel, prec):
    _, _, _, _, positions, amat, bmat = panel
    cfg, jcfg = _cfgs(prec, seed=3)
    s, d = run_fet(SnpPair(positions, amat, bmat), REGEND, cfg, device="cpu", seqid="chrT")
    js, jd = jax_run_fet(JSnpPair(positions, amat, bmat), REGEND, jcfg, seqid="chrT")
    assert s.dtype == np.float64 and s.shape == js.shape
    assert np.array_equal(s != 0, js != 0)
    assert (d > 0).sum() > 10
    assert_close(s, js, TOL[prec])
    assert_close(d, jd, TOL[prec])


def _genome(n_chrom=3, asize=11, bsize=10, npos=300, region=15_000):
    pairs = {}
    for i in range(n_chrom):
        pos, am, bm = make_panel(npos + 50 * i, region, asize, bsize, seed=40 + i)
        pairs[f"chr{i + 1}"] = (pos, am, bm, region + 1000 * i)
    return pairs


@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("panel_sizes", [(11, 10), (48, 48)])
def test_run_fet_multi_matches_jax(prec, panel_sizes):
    genome = _genome(asize=panel_sizes[0], bsize=panel_sizes[1])
    cfg, jcfg = _cfgs(prec, window={"wsize": 2000, "wstep": 400})
    summary = RunSummary()
    got = run_fet_multi(
        {k: (SnpPair(p, a, b), r) for k, (p, a, b, r) in genome.items()},
        cfg, device="cpu", summary=summary,
    )
    want = jax_run_fet_multi(
        {k: (JSnpPair(p, a, b), r) for k, (p, a, b, r) in genome.items()}, jcfg
    )
    assert sorted(got) == sorted(want)
    for seqid in want:
        assert_close(got[seqid][0], want[seqid][0], TOL[prec])
        assert_close(got[seqid][1], want[seqid][1], TOL[prec])
    assert summary.counters["windows_evaluated"] > 0
    assert {"fet_dispatch", "fet_sync", "fet_scatter"} <= set(summary.timings_s)


def test_multi_equals_per_chromosome_bitwise():
    """run_fet_multi's per-chromosome result IS run_fet's: the streams are
    (seed, chromosome, slot)-pinned."""
    genome = _genome()
    cfg = FetConfig(seed=9)
    multi = run_fet_multi(
        {k: (SnpPair(p, a, b), r) for k, (p, a, b, r) in genome.items()},
        cfg, device="cpu",
    )
    for seqid, (p, a, b, r) in genome.items():
        s, d = run_fet(SnpPair(p, a, b), r, cfg, device="cpu", seqid=seqid)
        assert np.array_equal(s, multi[seqid][0])
        assert np.array_equal(d, multi[seqid][1])


def test_seed_and_chromosome_change_the_stream(panel):
    _, _, _, _, positions, amat, bmat = panel
    pair = SnpPair(positions, amat, bmat)
    base = run_fet(pair, REGEND, FetConfig(seed=1), device="cpu", seqid="chrA")
    other_seed = run_fet(pair, REGEND, FetConfig(seed=2), device="cpu", seqid="chrA")
    other_chrom = run_fet(pair, REGEND, FetConfig(seed=1), device="cpu", seqid="chrB")
    assert np.array_equal(base[0], other_seed[0])          # scores: no RNG
    assert not np.array_equal(base[1], other_seed[1])
    assert not np.array_equal(base[1], other_chrom[1])


def test_empty_region_and_tiny_regend():
    pos = np.array([50_000, 60_000], dtype=np.int64)
    mat = np.full((2, 3), 3, dtype=np.int16)
    s, d = run_fet(SnpPair(pos, mat, mat), 10_000, FetConfig(), device="cpu")
    assert s.shape == (20,) and not s.any() and not d.any()
    s, d = run_fet(SnpPair(pos, mat, mat), 100, FetConfig(), device="cpu")
    assert s.shape == (0,)


def test_to_device_compact_and_float_fallback():
    pos = np.arange(1, 5, dtype=np.int64) * 100
    codes = np.array([[3, -3], [0, -10000], [3, 3], [-3, 0]], dtype=np.float64)
    pair = SnpPair(pos, codes, codes[:, :1])
    t = pair.to_device("cpu")
    assert t.dtype == torch.int16 and t.shape == (4, 3)
    assert pair.to_device("cpu") is t                       # cached
    freq = SnpPair(pos, codes + 0.5, codes[:, :1])
    assert freq.to_device("cpu").dtype == torch.float64


def test_misaligned_populations_rejected():
    from divergence_tpu_torch.io.gtrack import PopulationTrack

    a = PopulationTrack("c", np.repeat([1, 2], 2), np.zeros(4), 2)
    b = PopulationTrack("c", np.repeat([1, 3], 2), np.zeros(4), 2)
    with pytest.raises(ValueError, match="position sets differ"):
        SnpPair.from_tracks(a, b)


def test_cuda_device_without_cuda_raises(panel):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, _, _, positions, amat, bmat = panel
    with pytest.raises(RuntimeError, match="is_available"):
        run_fet(SnpPair(positions, amat, bmat), REGEND, device="cuda")
