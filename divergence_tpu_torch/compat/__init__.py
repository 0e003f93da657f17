"""Compatibility shims for reference-platform protocols (copied from
``divergence_tpu/compat``)."""

from divergence_tpu_torch.compat.analysisdef import (
    build_analysis_def,
    config_from_analysis_def,
    parse_analysis_def,
)

__all__ = [
    "parse_analysis_def",
    "config_from_analysis_def",
    "build_analysis_def",
]
