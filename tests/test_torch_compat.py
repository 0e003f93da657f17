"""The port's HyperBrowser ``analysisDef`` protocol
(``divergence_tpu_torch/compat``): ``tests/test_compat.py``'s cases on the
port's copy, and the same configs (``dataclasses.asdict``) and strings as
the JAX package's for the reference strings (reference
tools/FisherExactTestSNPTool.py:169, tools/ClusterSeparationScore.py:187)."""

import dataclasses

import pytest

from divergence_tpu import compat as jcompat
from divergence_tpu import config as jconfig
from divergence_tpu_torch.compat import (
    build_analysis_def,
    config_from_analysis_def,
    parse_analysis_def,
)
from divergence_tpu_torch.config import CssConfig, FetConfig, MdsAlgorithm, WindowConfig

REFERENCE_STRINGS = [
    "Dummy: dummy name ([wStep=500] [wSize=2500] [percentile=0.95])"
    "-> FisherExactScoreStat",
    "Dummy: dummy name ([wStep=500] [wSize=2500] [func=True] [mds=2] "
    "[mcT=10] [mcR=200000])-> CategoryClusterSeparationStat",
    "Dummy: dummy name ([wStep=500] [wSize=2500] [func=False] [mds=0] "
    "[mcT=10] [mcR=200000])-> CategoryClusterSeparationStat",
    "x ([wStep=1e+03] [wSize=1e+04] [percentile=0.9])-> FisherExactScoreStat",
    "x ([wStep=250] [wSize=5000] [func=False] [mds=1] [mcT=5] [mcR=1e+04])"
    "-> CategoryClusterSeparationStat",
]


def as_dict(cfg):
    d = dataclasses.asdict(cfg)
    if "mds" in d:
        d["mds"] = int(d["mds"])
    return d


@pytest.mark.parametrize("s", REFERENCE_STRINGS)
def test_configs_equal_jax(s):
    got, want = config_from_analysis_def(s), jcompat.config_from_analysis_def(s)
    assert type(got).__name__ == type(want).__name__
    assert as_dict(got) == as_dict(want)
    assert parse_analysis_def(s) == jcompat.parse_analysis_def(s)
    assert build_analysis_def(got) == jcompat.build_analysis_def(want)


@pytest.mark.parametrize("kind", ["fet", "css", "fet_large"])
def test_build_strings_equal_jax(kind):
    if kind == "css":
        t = CssConfig(window=WindowConfig(2500, 500), drosophila=True,
                      mds=MdsAlgorithm.SMACOF, mc_threshold=5, mc_runs=1000)
        j = jconfig.CssConfig(window=jconfig.WindowConfig(2500, 500), drosophila=True,
                              mds=jconfig.MdsAlgorithm.SMACOF, mc_threshold=5, mc_runs=1000)
    else:
        w = (1_234_567, 500) if kind == "fet_large" else (5000, 1000)
        t = FetConfig(window=WindowConfig(*w), percentile=0.9)
        j = jconfig.FetConfig(window=jconfig.WindowConfig(*w), percentile=0.9)
    assert build_analysis_def(t) == jcompat.build_analysis_def(j)


def test_parse_reference_fet_string():
    stat, kw = parse_analysis_def(REFERENCE_STRINGS[0])
    assert stat == "FisherExactScoreStat"
    assert kw == {"wStep": "500", "wSize": "2500", "percentile": "0.95"}
    cfg = config_from_analysis_def(REFERENCE_STRINGS[0])
    assert isinstance(cfg, FetConfig)
    assert (cfg.window.wsize, cfg.window.wstep, cfg.percentile) == (2500, 500, 0.95)


def test_parse_reference_css_string():
    cfg = config_from_analysis_def(REFERENCE_STRINGS[1])
    assert isinstance(cfg, CssConfig)
    assert cfg.drosophila is True
    assert cfg.mds == MdsAlgorithm.CMDS_SMACOF
    assert (cfg.mc_threshold, cfg.mc_runs) == (10, 200_000)


def test_percent_g_formatting():
    cfg = config_from_analysis_def(REFERENCE_STRINGS[3])
    assert (cfg.window.wsize, cfg.window.wstep) == (10_000, 1_000)


def test_roundtrip():
    for cfg in (
        FetConfig(window=WindowConfig(5000, 1000), percentile=0.9),
        CssConfig(window=WindowConfig(2500, 500), drosophila=True, mds=MdsAlgorithm.SMACOF,
                  mc_threshold=5, mc_runs=1000),
    ):
        back = config_from_analysis_def(build_analysis_def(cfg))
        assert back.window == cfg.window
        if isinstance(cfg, CssConfig):
            assert (back.drosophila, back.mds, back.mc_threshold, back.mc_runs) == (
                cfg.drosophila, cfg.mds, cfg.mc_threshold, cfg.mc_runs)
        else:
            assert back.percentile == cfg.percentile


def test_errors():
    with pytest.raises(ValueError):
        parse_analysis_def("no stat name here")
    with pytest.raises(ValueError):
        config_from_analysis_def("x ([wSize=10])-> UnknownStat")


@pytest.mark.parametrize("s,key", [
    ("x ([wStep=500] [wSize=2500])-> FisherExactScoreStat", "percentile"),
    ("x ([wsize=5000] [wStep=500] [percentile=0.95])-> FisherExactScoreStat", "wSize"),
    ("x ([wStep=500] [wSize=2500] [func=False] [mds=0] [mcR=200000])"
     "-> CategoryClusterSeparationStat", "mcT"),
])
def test_missing_and_case_sensitive_kwargs_raise(s, key):
    with pytest.raises(ValueError, match=key):
        config_from_analysis_def(s)
    with pytest.raises(ValueError, match=key):
        jcompat.config_from_analysis_def(s)


def test_build_large_geometry_roundtrips_exactly():
    cfg = FetConfig(window=WindowConfig(wsize=1_234_567, wstep=500))
    s = build_analysis_def(cfg)
    assert "[wSize=1234567]" in s
    assert config_from_analysis_def(s).window.wsize == 1_234_567
