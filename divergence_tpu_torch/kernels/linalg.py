"""Top-2 eigenpairs of a batch of small symmetric matrices
(``divergence_tpu/kernels/linalg.py:top2_eig``).

The JAX package routes ``top2_eig`` by backend: batched Jacobi variants
on the TPU (lane-major, chunked; TPU workarounds), LAPACK ``eigh`` on the
CPU (``linalg.py:316-319``).  The port's plain version is the CPU route,
``torch.linalg.eigh``; on the card the CMDS kernel (``csrc/css_cmds.cu``)
runs its own Jacobi solver in shared memory.
"""

from __future__ import annotations

import torch


def top2_eig(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-2 eigenpairs (descending) of ``a`` ``[..., m, m]`` symmetric:
    (vals ``[..., 2]``, vecs ``[..., m, 2]``), the reference's "keep the
    dims largest eigenvalues" (reference statistics/css/css.c:543-553)."""
    w, v = torch.linalg.eigh(a)        # ascending
    return w.flip(-1)[..., :2], v.flip(-1)[..., :2]
