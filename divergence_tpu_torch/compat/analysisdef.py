"""HyperBrowser ``analysisDef`` kwarg-string protocol (compatibility).

The reference configures its statistic adapters through strings like::

    "Dummy: dummy name ([wStep=500] [wSize=2500] [percentile=0.95])
        -> FisherExactScoreStat"
    "Dummy: dummy name ([wStep=500] [wSize=2500] [func=False] [mds=0]
        [mcT=10] [mcR=200000])-> CategoryClusterSeparationStat"

(reference tools/FisherExactTestSNPTool.py:169,
tools/ClusterSeparationScore.py:187, parsed at
statistics/FisherExactScoreStat.py:44-50 and
statistics/CategoryClusterSeparationStat.py:44-67).  This module parses /
builds those strings and maps them to the framework's typed configs so
existing HyperBrowser workflows translate 1:1.

Copied from ``divergence_tpu/compat/analysisdef.py``; only the imports
differ (the port's verbatim configs of ``divergence_tpu_torch/config.py``).
``tests/test_torch_host_copies.py`` holds the copy equal to the original.
"""

from __future__ import annotations

import re

from divergence_tpu_torch.config import (
    CssConfig,
    FetConfig,
    MdsAlgorithm,
    WindowConfig,
)

_KWARG_RE = re.compile(r"\[([A-Za-z_]\w*)=([^\]]*)\]")
_STAT_RE = re.compile(r"->\s*(\w+)\s*$")

FET_STAT = "FisherExactScoreStat"
CSS_STAT = "CategoryClusterSeparationStat"


def parse_analysis_def(s: str) -> tuple[str, dict[str, str]]:
    """(stat_name, raw kwargs) from an analysisDef string."""
    m = _STAT_RE.search(s)
    if not m:
        raise ValueError(f"no '-> StatName' suffix in analysisDef: {s!r}")
    kwargs = {k: v for k, v in _KWARG_RE.findall(s)}
    return m.group(1), kwargs


def _require(kw: dict[str, str], keys: list[str], stat: str) -> None:
    """The reference adapters index their kwargs directly
    (``self._kwArgs['wSize']``, reference
    statistics/FisherExactScoreStat.py:44-50), so a missing or typo'd
    (case-sensitive) key fails loudly there; silently defaulting here
    would run a wrong-geometry scan with no diagnostic."""
    missing = [k for k in keys if k not in kw]
    if missing:
        raise ValueError(
            f"analysisDef for {stat} is missing kwargs {missing} "
            f"(got {sorted(kw)}; keys are case-sensitive)"
        )


def config_from_analysis_def(s: str) -> FetConfig | CssConfig:
    """Typed engine config from an analysisDef string.

    Numeric kwargs accept the ``%g`` formatting the reference emits
    (``2500`` or ``2.5e+03``); the CSS ``func`` flag is the string
    ``"True"``/``"False"`` exactly as the adapter compares it
    (reference statistics/CategoryClusterSeparationStat.py:60).
    Missing keys raise, mirroring the reference adapters' direct
    ``_kwArgs[...]`` lookups."""
    stat, kw = parse_analysis_def(s)
    if stat == FET_STAT:
        _require(kw, ["wSize", "wStep", "percentile"], stat)
        window = WindowConfig(
            wsize=int(float(kw["wSize"])), wstep=int(float(kw["wStep"]))
        )
        return FetConfig(window=window, percentile=float(kw["percentile"]))
    if stat == CSS_STAT:
        _require(kw, ["wSize", "wStep", "mcT", "mcR", "func", "mds"], stat)
        window = WindowConfig(
            wsize=int(float(kw["wSize"])), wstep=int(float(kw["wStep"]))
        )
        return CssConfig(
            window=window,
            mc_threshold=int(float(kw["mcT"])),
            mc_runs=int(float(kw["mcR"])),
            drosophila=kw["func"] == "True",
            mds=MdsAlgorithm(int(float(kw["mds"]))),
        )
    raise ValueError(f"unknown statistic {stat!r} in analysisDef")


def build_analysis_def(cfg: FetConfig | CssConfig) -> str:
    """The reference-format analysisDef string for a typed config.

    Integer fields are emitted as plain integers: the reference's own
    ``%g`` (reference tools/FisherExactTestSNPTool.py:169) switches to
    exponent notation above 6 significant digits, which its adapter's
    bare ``int(...)`` cannot parse back and which silently rounds the
    geometry — for the values the GUI defaults produce the two formats
    are byte-identical."""
    w = cfg.window
    if isinstance(cfg, FetConfig):
        return (
            "Dummy: dummy name ([wStep=%d] [wSize=%d] [percentile=%g])"
            "-> %s" % (w.wstep, w.wsize, cfg.percentile, FET_STAT)
        )
    return (
        "Dummy: dummy name ([wStep=%d] [wSize=%d] [func=%s] [mds=%d] "
        "[mcT=%d] [mcR=%d])-> %s"
        % (
            w.wstep,
            w.wsize,
            cfg.drosophila,
            int(cfg.mds),
            cfg.mc_threshold,
            cfg.mc_runs,
            CSS_STAT,
        )
    )
