"""The CUDA kernels of divergence_tpu_torch against their plain torch
versions on the card.  Marked ``gpu``: they skip without a CUDA device (a
CUDA kernel has no CPU mode).  Run on a machine with one GPU:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports jax for the JAX tests.)

Tolerances, relative to max(|reference|, 1): exact 1e-12, fast 1e-5."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from divergence_tpu_torch import FetConfig, rng
from divergence_tpu_torch.core.windows import plan_windows
from divergence_tpu_torch.engine import SnpPair, run_fet
from divergence_tpu_torch.kernels import _build
from divergence_tpu_torch.kernels import fet as kfet
from divergence_tpu_torch.tools.synth import make_panel

TOL = {"exact": 1e-12, "fast": 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rel(got, ref) -> float:
    got, ref = got.double().cpu(), ref.double().cpu()
    return float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())


def _codes(n, width, seed):
    rs = np.random.default_rng(seed)
    return torch.from_numpy(
        rs.choice(np.array([3, -3, 0, -10000], np.int16), size=(n, width),
                  p=[0.4, 0.3, 0.25, 0.05])
    )


def test_nvcc_missing_raises(monkeypatch):
    """Without nvcc the build raises; nothing falls back."""
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", Path("/nonexistent/nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize", [(11, 10), (4, 3)])
def test_lut_kernel(cuda, prec, asize, bsize):
    dt = torch.float64 if prec == "exact" else torch.float32
    maxs, nmax = kfet.support_size(asize, bsize), asize + bsize + 2
    before = kfet.LAUNCHES["fet_lut_build"]
    k = kfet.fet_lut(asize, bsize, maxs, nmax, dt, cuda)
    p = kfet.fet_lut_plain(asize, bsize, maxs, nmax, dt, cuda)
    torch.cuda.synchronize()
    assert kfet.LAUNCHES["fet_lut_build"] == before + 1
    assert k.dtype == dt and bool(torch.isfinite(k).all())
    assert _rel(k, p) <= TOL[prec]


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize", [(11, 10), (48, 48)])
def test_snp_logs_kernel(cuda, prec, asize, bsize):
    vals = _codes(50_000, asize + bsize, 1).to(cuda)
    maxs, nmax = kfet.support_size(asize, bsize), asize + bsize + 2
    fast = prec == "fast"
    k = kfet.fet_snp_logs(vals, asize, maxs, nmax, fast)
    p = kfet.fet_snp_logs_plain(vals, asize, maxs, nmax, fast)
    torch.cuda.synchronize()
    assert _rel(k, p) <= TOL[prec]
    with pytest.raises(TypeError, match="int16"):
        kfet.fet_snp_logs(vals.float(), asize, maxs, nmax, fast)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_aggregate_kernel(cuda, prec):
    pos, am, bm = make_panel(40_000, 2_000_000, 11, 10, seed=3)
    vals = torch.from_numpy(np.concatenate([am, bm], axis=1)).to(cuda)
    logs = kfet.fet_snp_logs(vals, 11, kfet.support_size(11, 10), 23, prec == "fast")
    plan = plan_windows(pos, 2_000_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    lo, npos, slot = (torch.from_numpy(a[ids].copy()) for a in (plan.lo, plan.npos, plan.slot))
    key = rng.fold_in(rng.prng_key(2), rng.chrom_hash("chrG"))
    k = kfet.fet_aggregate(logs, lo, npos, slot, key, 0.95, 100)
    p = kfet.fet_aggregate_plain(logs, lo, npos, slot, key, 0.95, 100)
    torch.cuda.synchronize()
    assert _rel(k[0], p[0]) <= TOL[prec]
    assert _rel(k[1], p[1]) <= TOL[prec]


@pytest.mark.gpu
def test_aggregate_kernel_refuses_oversized_windows(cuda):
    logs = torch.zeros(5000, dtype=torch.float64, device=cuda)
    one = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="at most"):
        kfet.fet_aggregate(logs, one, one + 4500, one, rng.prng_key(0), 0.95, 100)
    with pytest.raises(ValueError, match="outside"):
        kfet.fet_aggregate(logs, one + 4990, one + 20, one, rng.prng_key(0), 0.95, 100)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_fet_cuda_matches_cpu(cuda, prec):
    pos, am, bm = make_panel(20_000, 1_000_000, 11, 10, seed=8)
    cfg = FetConfig(precision=prec)
    kfet.reset_launches()
    g = run_fet(SnpPair(pos, am, bm), 1_000_000, cfg, device=cuda, seqid="c")
    assert all(v == 1 for v in kfet.LAUNCHES.values()), kfet.LAUNCHES
    c = run_fet(SnpPair(pos, am, bm), 1_000_000, cfg, device="cpu", seqid="c")
    for a, b in zip(g, c):
        assert np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)) <= TOL[prec]
