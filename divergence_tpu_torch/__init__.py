"""divergence_tpu_torch — the FET and CSS window scans of ``divergence_tpu``
in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package stays the reference; every module here mirrors the JAX
module of the same name.  This package imports ``torch`` (and numpy /
scipy) and never ``jax``.

Layers (bottom up):

* :mod:`divergence_tpu_torch.rng`     — threefry-2x32 replica of
  ``jax.random`` (keys, ``fold_in``, uniform bits) and the MC's counter
  mix, bit-equal
* :mod:`divergence_tpu_torch.kernels` — per-SNP FET scores (K1), the
  window percentile + bootstrap stddev (K2), their LUT-rank forms for
  exact mode (K1r, K2r), CSS window dissimilarities
  (K3/K4), CMDS (K5) and SMACOF (K6) scoring, the permutation MC on the
  shared (K7) and the per-window stream (K8), approx mode's null power
  sums (K9), FET on pre-gathered windows (K10) and one fixed MC chunk per
  window (K11): a CUDA kernel for CUDA tensors, the plain torch version
  for CPU tensors
* :mod:`divergence_tpu_torch.core`    — window planning
* :mod:`divergence_tpu_torch.engine`  — ``run_fet`` / ``run_fet_multi``,
  ``run_css`` / ``run_css_multi``
* :mod:`divergence_tpu_torch.parallel` — device meshes, the sharded
  divergence step (``make_divergence_step``), multi-host partitioning
* :mod:`divergence_tpu_torch.io`      — GTrack reading / score-track and
  segments writing
* :mod:`divergence_tpu_torch.stats`   — region calling (Burke limit, BH-FDR,
  top-N) over score tracks, host numpy
* :mod:`divergence_tpu_torch.tools`   — the CLI (``run-fet``, ``run-css``,
  ``filter-fet``, ``call-css-regions``, ``report``, ``run-all``,
  ``merge-tracks``, ``bench-scaling``) and the HTML report

No device is global: every entry point takes ``device=`` or a
``sharding=`` mesh.
"""

from __future__ import annotations

import torch

from divergence_tpu_torch.config import CssConfig, FetConfig, WindowConfig

__version__ = "0.1.0"


def compute_dtype(precision: str) -> torch.dtype:
    """Working float type of a precision mode: ``exact`` is float64 end
    to end (the reference C is all doubles), ``fast`` is float32
    (``divergence_tpu/config.py`` ``FetConfig.precision``)."""
    if precision == "exact":
        return torch.float64
    if precision == "fast":
        return torch.float32
    raise ValueError("precision must be 'exact' or 'fast'")


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and none is present (there is no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain torch path"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


__all__ = [
    "CssConfig",
    "FetConfig",
    "WindowConfig",
    "compute_dtype",
    "resolve_device",
    "__version__",
]
