"""The CUDA kernels of divergence_tpu_torch against their plain torch
versions on the card.  Marked ``gpu``: they skip without a CUDA device (a
CUDA kernel has no CPU mode).  Run on a machine with one GPU:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports jax for the JAX tests.)

Tolerances, relative to max(|reference|, 1): FET exact 1e-12, fast 1e-5.
CSS: counts and the MC coefficients exactly equal; CMDS scores exact 1e-9
on windows with eigengap above 1e-6, fast rtol 2e-3 atol 1e-4 (the JAX
package's fast-vs-exact band); MC (nscores, hits) equal on >= 99.9 % of
windows (a float32 near tie may flip between summation orders)."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from divergence_tpu_torch import FetConfig, rng
from divergence_tpu_torch.config import CssConfig
from divergence_tpu_torch.core.windows import plan_windows
from divergence_tpu_torch.engine import SnpPair, run_css, run_fet
from divergence_tpu_torch.kernels import _build
from divergence_tpu_torch.kernels import css as kcss
from divergence_tpu_torch.kernels import fet as kfet
from divergence_tpu_torch.kernels import perm as kperm
from divergence_tpu_torch.tools.synth import make_chromosome, make_panel

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


def _css_windows(cuda, asize=11, bsize=10, npos=40_000, region=2_000_000, seed=3):
    pos, am, bm = make_panel(npos, region, asize, bsize, seed=seed)
    plan = plan_windows(pos, region, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    vals = torch.from_numpy(np.concatenate([am, bm], axis=1)).to(cuda)
    return vals, torch.from_numpy(plan.lo[ids].copy()), torch.from_numpy(plan.npos[ids].copy())


@pytest.mark.gpu
@pytest.mark.parametrize("asize,bsize", [(11, 10), (48, 48), (1, 6)])
def test_css_dissim_kernel(cuda, asize, bsize):
    vals, lo, npos = _css_windows(cuda, asize, bsize)
    plain = kcss.dissimilarity_plain(vals, lo, npos)
    for dt in (torch.float64, torch.float32):
        before = kcss.LAUNCHES["css_dissim"]
        k = kcss.css_dissim(vals, lo, npos, dt)
        torch.cuda.synchronize()
        assert kcss.LAUNCHES["css_dissim"] == before + 1
        assert k.dtype == dt and torch.equal(k.double(), plain)
    with pytest.raises(TypeError, match="int16"):
        kcss.css_dissim(vals.float(), lo, npos, torch.float64)


@pytest.mark.gpu
def test_css_dissim_kernel_dense_windows(cuda):
    """Windows of over a thousand SNPs: several 256-SNP passes each."""
    pos, am, bm = make_chromosome(20_000, 40_000, 11, 10, 3)
    plan = plan_windows(pos, 40_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    vals = torch.from_numpy(np.concatenate([am, bm], axis=1)).to(cuda)
    lo, npos = (torch.from_numpy(a[ids].copy()) for a in (plan.lo, plan.npos))
    assert int(npos.max()) > 1000
    k = kcss.css_dissim(vals, lo, npos, torch.float64)
    assert torch.equal(k, kcss.dissimilarity_plain(vals, lo, npos))


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize", [(11, 10), (5, 4), (32, 32)])
def test_css_cmds_kernel(cuda, prec, asize, bsize):
    dt = torch.float64 if prec == "exact" else torch.float32
    vals, lo, npos = _css_windows(cuda, asize, bsize)
    dis = kcss.dissimilarity_plain(vals, lo, npos).to(dt)
    npos_d = npos.to(cuda)
    ks, kd, kv = kcss.css_cmds(dis, npos_d, asize, bsize)
    ps, pd, pv = kcss.css_cmds_plain(dis, npos_d, asize, bsize)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv)
    assert torch.equal(ks.isnan(), ps.isnan())
    filled, _ = kcss.fill_averages(dis.double())
    ev = torch.linalg.eigvalsh(kcss.double_centre(filled)).flip(-1)
    ok = ((ev[:, 1] - ev[:, 2]) / ev[:, 0].abs().clamp(min=1.0) > 1e-6) & ~ps.isnan()
    assert int((~ok).sum()) <= 0.01 * ok.numel()
    got, want = ks.double()[ok].cpu().numpy(), ps.double()[ok].cpu().numpy()
    if prec == "exact":
        assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)) <= 1e-9
    else:
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4)


@pytest.mark.gpu
def test_css_cmds_kernel_refuses_large_panels(cuda):
    dis = torch.zeros((2, 65, 65), dtype=torch.float64, device=cuda)
    with pytest.raises(NotImplementedError, match="P12"):
        kcss.css_cmds(dis, torch.ones(2, dtype=torch.int64), 33, 32)


@pytest.mark.gpu
@pytest.mark.parametrize("asize,bsize,chunk", [(11, 10, 256), (5, 4, 512), (1, 6, 100), (2, 2, 256)])
def test_css_mc_coeff_kernel_bit_equal(cuda, asize, bsize, chunk):
    key = rng.fold_in(rng.prng_key(5), 2)
    m = asize + bsize
    k = kperm.shared_coeff(key, 3, 16, m, asize, bsize, chunk, cuda)
    p = kperm.shared_coeff_plain(key, 3, 16, m, asize, bsize, chunk, cuda)
    torch.cuda.synchronize()
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("chunk,runs", [(256, 20_000), (512, 3000), (100, 2500)])
def test_css_mc_shared_kernel(cuda, chunk, runs):
    vals, lo, npos = _css_windows(cuda, npos=60_000, region=3_000_000, seed=8)
    s, d, v = kcss.css_phase1(vals, lo, npos, 11, 10, fast=True)
    dist, scores = d[v], s[v].double().cpu().numpy()
    key = rng.fold_in(rng.prng_key(0), 2)
    got = kperm.significance(dist, scores, 11, 10, 10, runs, key, chunk=chunk)
    pv, n, h = kperm.mc_significance(dist, scores, key, 11, 10, chunk, runs, 10)
    differ = (got.nscores != n) | (got.hits != h)
    assert differ.sum() <= 1e-3 * len(scores), int(differ.sum())
    assert np.array_equal(got.pvals[~differ], pv[~differ])
    assert (n < runs).any() and (n == runs).any()


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_css_cuda_matches_cpu(cuda, prec):
    pos, am, bm = make_panel(20_000, 1_000_000, 11, 10, seed=8)
    cfg = CssConfig(precision=prec, mc_runs=5000)
    kcss.reset_launches()
    kperm.reset_launches()
    g = run_css(SnpPair(pos, am, bm), 1_000_000, cfg, device=cuda, seqid="c")
    assert all(v >= 1 for v in kcss.LAUNCHES.values()), kcss.LAUNCHES
    assert all(v >= 1 for v in kperm.LAUNCHES.values()), kperm.LAUNCHES
    c = run_css(SnpPair(pos, am, bm), 1_000_000, cfg, device="cpu", seqid="c")
    assert np.array_equal(g[0] != 0, c[0] != 0)
    tol = (1e-9, 0.0) if prec == "exact" else (2e-3, 1e-4)
    np.testing.assert_allclose(g[0], c[0], rtol=tol[0], atol=tol[1])
    assert (g[1] != c[1]).sum() <= 0.01 * (c[0] != 0).sum()
