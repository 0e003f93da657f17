"""The CUDA kernels of divergence_tpu_torch against their plain torch
versions on the card.  Marked ``gpu``: they skip without a CUDA device (a
CUDA kernel has no CPU mode).  Run on a machine with one GPU:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports jax for the JAX tests.)

Tolerances, relative to max(|reference|, 1): FET exact 1e-12, fast 1e-5.
CSS: counts and the MC coefficients exactly equal; CMDS scores exact 1e-9
on windows with eigengap above 1e-6, fast rtol 2e-3 atol 1e-4 (the JAX
package's fast-vs-exact band); MC (nscores, hits) equal on >= 99.9 % of
windows (a float32 near tie may flip between summation orders), each
differing window and each differing hit bit of K7's words a near tie
(TIE_RTOL); K7's stop scan equal to its plain version on every window.
SMACOF (K6): exact 1e-9 on windows whose chosen restart and transform count
agree with the plain version's, the rest at most 0.1 % of windows (+1);
fast within FAST_BAND, the JAX package's float32-vs-float64 band measured
on the CPU (tests/test_torch_smacof.py; this file runs without jax).  K8
(``css_mc_window``, float32 mix / threefry and the float64 native form):
(p, n, hits) identical to the plain versions on >= 99.9 % of windows (the
float32 form adds the twin's products in the twin's order).  K9
(``css_mc_power``): power sums within POWER_RTOL of the plain version and
approx p within LOG10_P_BAND where nscores agree (>= 99.9 % of windows),
the bands measured on the CPU (tests/test_torch_approx.py); at the tile
edges the shared stream's sums within the float32 rounding of the plain
version's scores (see the test), and the same bits in two calls.  K10
(``fet_window``): FET tolerances against its plain version (stddev beyond
them on at most 0.01 % of windows, + 1) and bit-equal to K1 -> K2 on a
chromosome's windows.  K1r (``fet_lut_rank``, ``fet_snp_ranks``): the
sorted LUT and every rank equal to the plain version's on the kernel's own
LUT (signed zeros tied), the scores lut_sorted[ranks] at the FET
tolerances.  K2r (``fet_aggregate_ranks``): FET tolerances against its
plain version and bit-equal to K1 -> K2.  K11 (``css_perm_chunk``): (hits, reached, pos)
identical to the plain version on every window (the twin's scores, bit
for bit).  The sharded step: bit-equal per window across a 1- and a
4-share mesh of one card."""

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
from divergence_tpu_torch.tools.synth import make_chromosome, make_freq_chromosome, make_panel

TOL = {"exact": 1e-12, "fast": 1e-5}
TIE_RTOL = 1e-5   # float32 near tie (tests/test_torch_mc.py)
# approx mode, keyed by the largest m they cover (tests/test_torch_approx.py)
POWER_RTOL = {21: 1e-6, 64: 3e-6}
LOG10_P_BAND = {21: 2e-5, 64: 3e-4}


def band(table: dict, m: int) -> float:
    return table[min(k for k in table if k >= m)]

# mds -> (max, 90th percentile): tests/test_torch_smacof.py FAST_BAND
FAST_BAND = {1: (5.5e-2, 7e-4), 2: (1.53e-1, 7e-4)}


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
    # exact mode takes the rank path (K1r -> K2r), fast mode K1 -> K2
    path = (("fet_lut_build", "fet_lut_rank", "fet_snp_ranks", "fet_aggregate_ranks")
            if prec == "exact" else ("fet_lut_build", "fet_snp_logs", "fet_aggregate"))
    assert {k: v for k, v in kfet.LAUNCHES.items() if v} == dict.fromkeys(path, 1), \
        kfet.LAUNCHES
    c = run_fet(SnpPair(pos, am, bm), 1_000_000, cfg, device="cpu", seqid="c")
    for a, b in zip(g, c):
        assert np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)) <= TOL[prec]


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("G", [5000, 100_000])
def test_lut_rank_kernel_ties_signed_zeros(cuda, dtype, G):
    """K1r's sort on a LUT of few values with both signed zeros: the CPU
    plain version's order (IEEE <, ties by index), in one counting pass
    (5,000 entries) and through runs and merge passes (100,000)."""
    rs = np.random.default_rng(G)
    lut = torch.from_numpy(rs.choice(np.array([0.0, -0.0, 2.5, 0.125, 7.0]), size=G)).to(dtype)
    ks, kr = kfet.fet_lut_rank(lut.to(cuda))
    ps, pr = kfet.fet_lut_rank_plain(lut)
    torch.cuda.synchronize()
    assert torch.equal(kr.cpu(), pr)
    assert torch.equal(_bits(ks.cpu()), _bits(ps))


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize,whole", [(11, 10, None), (11, 10, 1024), (38, 38, None)])
def test_lut_rank_kernel(cuda, monkeypatch, prec, asize, bsize, whole):
    """K1r's LUT sort against its plain version on K1's LUT, exactly: one
    counting pass at 11 + 10, runs and merges at 11 + 10 (forced) and at
    38 + 38, the largest symmetric panel with a LUT (2.3 M entries)."""
    if whole is not None:
        monkeypatch.setattr(kfet, "_LUT_RANK_WHOLE", whole)
    dt = torch.float64 if prec == "exact" else torch.float32
    maxs, nmax = kfet.support_size(asize, bsize), asize + bsize + 2
    assert kfet.lut_active(asize, bsize)
    lut = kfet.fet_lut(asize, bsize, maxs, nmax, dt, cuda)
    before = kfet.LAUNCHES["fet_lut_rank"]
    ks, kr = kfet.fet_lut_rank(lut)
    ps, pr = kfet.fet_lut_rank_plain(lut)
    torch.cuda.synchronize()
    assert kfet.LAUNCHES["fet_lut_rank"] == before + 1
    assert torch.equal(kr, pr)
    assert torch.equal(_bits(ks), _bits(ps))


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize", [(11, 10), (38, 38)])
def test_snp_ranks_kernel(cuda, prec, asize, bsize):
    """K1r per SNP: the ranks of the kernel's own LUT exactly, and scores
    lut_sorted[ranks] within the FET tolerances of the plain version's."""
    vals = _codes(200_000, asize + bsize, 4).to(cuda)
    maxs, nmax = kfet.support_size(asize, bsize), asize + bsize + 2
    fast = prec == "fast"
    before = dict(kfet.LAUNCHES)
    ls, r = kfet.fet_snp_ranks(vals, asize, maxs, nmax, fast)
    pls, pr = kfet.fet_snp_ranks_plain(vals, asize, maxs, nmax, fast)
    torch.cuda.synchronize()
    assert all(kfet.LAUNCHES[k] == before[k] + 1
               for k in ("fet_lut_build", "fet_lut_rank", "fet_snp_ranks")), kfet.LAUNCHES
    assert r.dtype == torch.int32 and r.shape == (200_000,)
    assert _rel(ls[r.long()], pls[pr.long()]) <= TOL[prec]
    _, rank_of_entry = kfet.fet_lut_rank_plain(
        kfet.fet_lut(asize, bsize, maxs, nmax, ls.dtype, cuda))
    tables = kfet.count_tables(vals[:, :asize], vals[:, asize:])
    assert torch.equal(r, rank_of_entry[kfet._lut_index(tables, asize, bsize)])
    with pytest.raises(TypeError, match="int16"):
        kfet.fet_snp_ranks(vals.float(), asize, maxs, nmax, fast)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_aggregate_ranks_kernel(cuda, prec):
    """K2r against its plain version at the FET tolerances, and bit-equal
    to K1 -> K2 on the same windows (also with 8,000 bootstrap samples,
    whose shared memory passes 48 KB)."""
    pos, am, bm = make_panel(40_000, 2_000_000, 11, 10, seed=3)
    vals = torch.from_numpy(np.concatenate([am, bm], axis=1)).to(cuda)
    fast = prec == "fast"
    maxs = kfet.support_size(11, 10)
    ls, r = kfet.fet_snp_ranks(vals, 11, maxs, 23, fast)
    logs = kfet.fet_snp_logs(vals, 11, maxs, 23, fast)
    plan = plan_windows(pos, 2_000_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    lo, npos, slot = (torch.from_numpy(a[ids].copy()) for a in (plan.lo, plan.npos, plan.slot))
    key = rng.fold_in(rng.prng_key(2), rng.chrom_hash("chrG"))
    k = kfet.fet_aggregate_ranks(ls, r, lo, npos, slot, key, 0.95, 100)
    p = kfet.fet_aggregate_ranks_plain(ls, r, lo, npos, slot, key, 0.95, 100)
    torch.cuda.synchronize()
    assert _rel(k[0], p[0]) <= TOL[prec]
    assert _rel(k[1], p[1]) <= TOL[prec]
    for nsamples in (100, 8000):
        kr = kfet.fet_aggregate_ranks(ls, r, lo, npos, slot, key, 0.95, nsamples)
        k2 = kfet.fet_aggregate(logs, lo, npos, slot, key, 0.95, nsamples)
        assert torch.equal(kr, k2), nsamples
    with pytest.raises(ValueError, match="int32"):
        kfet.fet_aggregate_ranks(ls, r.long(), lo, npos, slot, key, 0.95, 100)
    one = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="at most"):
        kfet.fet_aggregate_ranks(ls, r, one, one + 4500, one, key, 0.95, 100)


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
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_css_cuda_matches_cpu(cuda, prec):
    pos, am, bm = make_panel(20_000, 1_000_000, 11, 10, seed=8)
    cfg = CssConfig(precision=prec, mc_runs=5000)
    kcss.reset_launches()
    kperm.reset_launches()
    g = run_css(SnpPair(pos, am, bm), 1_000_000, cfg, device=cuda, seqid="c")
    assert kcss.LAUNCHES["css_dissim"] >= 1 and kcss.LAUNCHES["css_cmds"] >= 1, kcss.LAUNCHES
    assert all(kperm.LAUNCHES[k] >= 1 for k in ("css_mc_coeff", "css_mc_shared", "css_mc_scan")), \
        kperm.LAUNCHES
    c = run_css(SnpPair(pos, am, bm), 1_000_000, cfg, device="cpu", seqid="c")
    assert np.array_equal(g[0] != 0, c[0] != 0)
    tol = (1e-9, 0.0) if prec == "exact" else (2e-3, 1e-4)
    np.testing.assert_allclose(g[0], c[0], rtol=tol[0], atol=tol[1])
    assert (g[1] != c[1]).sum() <= 0.01 * (c[0] != 0).sum()


def _smacof_dis(cuda, m, dt):
    """[B, m, m] window dissimilarities on the card, and (asize, bsize,
    npos, slots): frequency windows at m = 2, stickleback counts else."""
    if m == 2:
        pos, fa, fb = make_freq_chromosome(40_000, 2_000_000, 5)
        plan = plan_windows(pos, 2_000_000, 2500, 500)
        ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
        dis = kcss.dissimilarity_freq_windows(
            torch.from_numpy(fa[:, 0]).to(cuda), torch.from_numpy(fb[:, 0]).to(cuda),
            torch.from_numpy(plan.lo[ids]), torch.from_numpy(plan.npos[ids]),
        )
        asize = bsize = 1
    else:
        asize, bsize = (m + 1) // 2, m // 2
        pos, am, bm = make_panel(20_000, 1_000_000, asize, bsize, seed=m)
        plan = plan_windows(pos, 1_000_000, 2500, 500)
        ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
        vals = torch.from_numpy(np.concatenate([am, bm], axis=1)).to(cuda)
        dis = kcss.css_dissim(vals, torch.from_numpy(plan.lo[ids]),
                              torch.from_numpy(plan.npos[ids]), torch.float64)
    npos = torch.from_numpy(plan.npos[ids].copy()).to(cuda)
    slots = torch.from_numpy(plan.slot[ids].copy()).to(cuda)
    return dis.to(dt).contiguous(), asize, bsize, npos, slots


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("mds", [1, 2])
@pytest.mark.parametrize("m", [2, 9, 21, 64])
def test_css_smacof_kernel(cuda, prec, mds, m):
    dt = torch.float64 if prec == "exact" else torch.float32
    dis, asize, bsize, npos, slots = _smacof_dis(cuda, m, dt)
    key = rng.fold_in(rng.prng_key(3), rng.chrom_hash("chrK"))
    before = kcss.LAUNCHES["css_smacof"]
    ks, kd, kv, kr, kn = kcss.css_smacof(dis, npos, asize, bsize, mds, key, slots)
    ps, pd, pv, pr, pn = kcss.css_smacof_plain(dis, npos, asize, bsize, mds, key, slots)
    torch.cuda.synchronize()
    assert kcss.LAUNCHES["css_smacof"] == before + 1
    assert torch.equal(kv, pv) and torch.equal(ks.isnan(), ps.isnan())
    assert int(kn.max()) <= 301 and int(kn.min()) >= 1
    B = dis.shape[0]
    sel = ~ps.isnan() & pv
    got, want = ks.double()[sel].cpu().numpy(), ps.double()[sel].cpu().numpy()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    if prec == "exact":
        agree = ((kr == pr) & (kn == pn))[sel].cpu().numpy()
        assert rel[agree].max(initial=0.0) <= 1e-9
        assert int((~agree).sum()) <= 1e-3 * B + 1
    else:
        top, q90 = FAST_BAND[mds]
        assert rel.max(initial=0.0) <= top and np.quantile(rel, 0.9) <= q90


@pytest.mark.gpu
def test_css_smacof_kernel_refuses(cuda):
    dis = torch.zeros((2, 65, 65), dtype=torch.float64, device=cuda)
    one = torch.ones(2, dtype=torch.int64)
    key = rng.prng_key(0)
    with pytest.raises(NotImplementedError, match="P12"):
        kcss.css_smacof(dis, one, 33, 32, 1, key, one)
    with pytest.raises(ValueError, match="restarts"):
        kcss.css_smacof(dis[:, :8, :8].contiguous(), one, 4, 4, 1, key, one, n_init=9)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_css_cmds_and_mc_kernels_at_m2(cuda, prec):
    """Drosophila's shapes: K5 at m = 2 (one rotation pair, an
    exactly-zero second eigenvalue) and K7 at 1 + 1 (p == 1)."""
    dt = torch.float64 if prec == "exact" else torch.float32
    dis, _, _, npos, _ = _smacof_dis(cuda, 2, dt)
    ks, kd, kv = kcss.css_cmds(dis, npos, 1, 1)
    ps, pd, pv = kcss.css_cmds_plain(dis, npos, 1, 1)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and kv.all() and not ks.isnan().any()
    if prec == "exact":
        assert _rel(ks, ps) <= 1e-9
    else:
        np.testing.assert_allclose(ks.double().cpu().numpy(), ps.double().cpu().numpy(),
                                   rtol=2e-3, atol=1e-4)
    key = rng.fold_in(rng.prng_key(1), 2)
    k = kperm.shared_coeff(key, 0, 16, 2, 1, 1, 256, cuda)
    p = kperm.shared_coeff_plain(key, 0, 16, 2, 1, 1, 256, cuda)
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))
    scores = ks.double().cpu().numpy()
    got = kperm.significance(kd, scores, 1, 1, 10, 5000, key)
    pvals, n, h = kperm.mc_significance(kd, scores, key, 1, 1, 256, 5000, 10)
    assert (got.pvals == 1.0).all() and np.array_equal(got.pvals, pvals)
    assert np.array_equal(got.nscores, n) and (n == 10).all()


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{"mds": 1}, {"mds": 2}, {"drosophila": True}])
def test_run_css_smacof_and_drosophila_cuda_matches_cpu(cuda, kw):
    if kw.get("drosophila"):
        pos, am, bm = make_freq_chromosome(20_000, 1_000_000, 9)
    else:
        pos, am, bm = make_panel(5_000, 250_000, 11, 10, seed=8)
    region = int(pos[-1]) + 1
    cfg = CssConfig(precision="exact", mc_runs=5000, **kw)
    kcss.reset_launches()
    g = run_css(SnpPair(pos, am, bm), region, cfg, device=cuda, seqid="c")
    name = "css_cmds" if kw.get("drosophila") else "css_smacof"
    assert kcss.LAUNCHES[name] == 1, kcss.LAUNCHES
    c = run_css(SnpPair(pos, am, bm), region, cfg, device="cpu", seqid="c")
    assert np.array_equal(g[0] != 0, c[0] != 0) and (c[0] != 0).sum() > 100
    err = np.abs(g[0] - c[0]) / np.maximum(np.abs(c[0]), 1.0)
    assert (err > 1e-9).sum() <= 1e-3 * (c[0] != 0).sum() + 1
    assert (g[1] != c[1]).sum() <= 0.01 * (c[0] != 0).sum() + 1


def _mc_windows(cuda, m, limit):
    """(dist [B, m, m] float32, float64 observed scores, asize, bsize,
    chroms, slots) of at most ``limit`` valid windows on the card: a
    frequency chromosome at m = 2, a stickleback-shaped panel else."""
    if m == 2:
        dis, asize, bsize, npos, slots = _smacof_dis(cuda, 2, torch.float32)
        s, d, v = kcss.css_cmds(dis, npos, 1, 1)
    else:
        asize, bsize = (m + 1) // 2, m // 2
        vals, lo, npos_h = _css_windows(cuda, asize, bsize, npos=40_000, region=2_000_000,
                                        seed=m)
        s, d, v = kcss.css_phase1(vals, lo, npos_h, asize, bsize, fast=True)
        plan = plan_windows(make_panel(40_000, 2_000_000, asize, bsize, seed=m)[0],
                            2_000_000, 2500, 500)
        slots = torch.from_numpy(plan.slot[plan.valid_mask() & (plan.npos > 0)].copy())
    keep = v.cpu().numpy()
    idx = np.nonzero(keep)[0][:limit]
    dist = d[torch.from_numpy(idx).to(cuda)].float().contiguous()
    scores = s.double().cpu().numpy()[idx]
    chroms = np.full(len(idx), rng.chrom_hash("chrK"), dtype=np.int64)
    return dist, scores, asize, bsize, chroms, slots.cpu().numpy()[idx]


FORMS = [("mix", "xla"), ("threefry", "xla"), ("mix", "native")]


@pytest.mark.gpu
@pytest.mark.parametrize("bitgen,backend", FORMS)
@pytest.mark.parametrize("m", [2, 9, 21, 64])
def test_css_mc_window_kernel(cuda, m, bitgen, backend):
    limit, runs = (64, 2000) if m == 64 else (512, 5000)
    dist, scores, asize, bsize, chroms, slots = _mc_windows(cuda, m, limit)
    key = rng.fold_in(rng.prng_key(6), 2)
    before = kperm.LAUNCHES["css_mc_window"]
    got = kperm.significance(dist, scores, asize, bsize, 10, runs, key, chroms=chroms,
                             slots=slots, backend=backend, bitgen=bitgen, stream="window")
    torch.cuda.synchronize()
    assert kperm.LAUNCHES["css_mc_window"] == before + 1
    wkeys = rng.window_keys(key.to(cuda), chroms, slots)
    if backend == "native":
        pv, n, h = kperm.mc_native_plain(dist, scores, wkeys, asize, bsize, 256, runs, 10)
    else:
        pv, n, h = kperm.mc_significance(dist, scores, wkeys, asize, bsize, 256, runs, 10,
                                         stream="window", bitgen=bitgen)
    differ = (got.nscores != n) | (got.hits != h) | (got.pvals != pv)
    assert differ.sum() <= 1e-3 * len(scores), int(differ.sum())
    if m == 2:
        assert (got.pvals == 1.0).all() and (got.nscores == 10).all()
    else:
        assert (n < runs).any() and (n == runs).any()


# K7 / K9 tile edges: window counts around the 128-window tile, m of 2,
# 9, 21 (m^2 = 4, 81, 441: one, six and 28 depth slabs), chunks of 100
# (a padded word), 256 and 512; the MC cap per chunk as before
TILE_EDGE_WINDOWS = [1, 127, 129, 997]
MC_RUNS_BY_CHUNK = {100: 2500, 256: 20_000, 512: 3000}


def _near_tie_windows(dist, scores, got, n, h, key, asize, bsize, chunk) -> int:
    """Windows whose (nscores, hits) differ from the plain version's; each
    must hold a permutation, among those either consumed, whose float64
    score lies within TIE_RTOL of the float32 observed score."""
    m = asize + bsize
    bad = np.nonzero((got.nscores != n) | (got.hits != h))[0]
    for w in bad:
        nn = int(max(got.nscores[w], n[w]))
        M = kperm.shared_coeff(key, 0, -(-nn // chunk), m, asize, bsize, chunk, dist.device)
        s64 = dist[w].reshape(-1).double() @ M.double()
        obs = float(np.float32(scores[w]))
        gap = float((s64[:nn] - obs).abs().min()) / max(abs(obs), 1.0)
        assert gap <= TIE_RTOL, (w, gap)
    return len(bad)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [100, 256, 512])
@pytest.mark.parametrize("m", [2, 9, 21])
@pytest.mark.parametrize("nwin", TILE_EDGE_WINDOWS)
def test_css_mc_shared_kernel(cuda, nwin, m, chunk):
    """K7 (css_mc_coeff, css_mc_shared, css_mc_scan) against the plain
    chunk loop, and its first range's hit words against the plain ones
    (bits differ only at float32 near ties)."""
    runs = MC_RUNS_BY_CHUNK[chunk]
    dist, scores, asize, bsize, _, _ = _mc_windows(cuda, m, nwin)
    assert dist.shape[0] == nwin
    key = rng.fold_in(rng.prng_key(0), 2).to(cuda)
    before = {k: kperm.LAUNCHES[k] for k in ("css_mc_shared", "css_mc_scan")}
    got = kperm.significance(dist, scores, asize, bsize, 10, runs, key, chunk=chunk)
    torch.cuda.synchronize()
    assert all(kperm.LAUNCHES[k] > before[k] for k in before), kperm.LAUNCHES
    pv, n, h = kperm.mc_significance(dist, scores, key, asize, bsize, chunk, runs, 10)
    nd = _near_tie_windows(dist, scores, got, n, h, key, asize, bsize, chunk)
    assert nd <= 1e-3 * nwin + 1, nd
    same = (got.nscores == n) & (got.hits == h)
    assert np.array_equal(got.pvals[same], pv[same])
    assert ((got.hits == 10) | (got.nscores == runs)).all()
    if m == 2:
        assert (got.pvals == 1.0).all() and (got.nscores == 10).all()
    elif nwin == 997:
        assert (n < runs).any() and (n == runs).any()
    # the first range's words, kernel against plain
    flat = dist.reshape(nwin, m * m).contiguous()
    obs = torch.as_tensor(scores).to(cuda).float()
    active = torch.arange(nwin, device=cuda)
    M = kperm.coeff_range(key, 0, 4, m, asize, bsize, chunk, cuda)
    kw = kperm.mc_hit_words(flat, obs, active, M, 0, 4, chunk, runs)
    pw = kperm.mc_hit_words_plain(flat, obs, active, M, 0, 4, chunk, runs)
    flip = kperm._unpack_words(kw ^ pw).reshape(nwin, -1)
    gap = (flat.double() @ M.double() - obs.double()[:, None]).abs() \
        / obs.double().abs().clamp(min=1.0)[:, None]
    assert bool((gap[flip] <= TIE_RTOL).all()), float(gap[flip].max())


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [100, 256, 512])
@pytest.mark.parametrize("nact", TILE_EDGE_WINDOWS)
def test_css_mc_scan_kernel(cuda, nact, chunk):
    """css_mc_scan against its plain version on random words and state:
    (hits, nscores, done) equal on every window, rows outside ``active``
    untouched."""
    rs = np.random.default_rng(nact + chunk)
    k0, nk, runs = 2, 7, 8 * chunk + 5
    B = 2 * nact + 3
    wpc = kperm.chunk_stride(chunk) // 32
    rate = rs.uniform(0, 0.05, (nact, 1, 1))
    bits = torch.from_numpy(rs.random((nact, nk, wpc * 32)) < rate)
    K = torch.arange(wpc * 32)
    offset = (k0 + torch.arange(nk))[:, None] * chunk
    bits &= (K < chunk)[None, :] & (offset + K < runs)
    words = kperm._pack_words(bits).to(cuda)
    active = torch.from_numpy(rs.permutation(B)[:nact].copy()).to(cuda)
    hits = torch.from_numpy(rs.integers(0, 10, B).astype(np.int32)).to(cuda)
    nsc = torch.full((B,), k0 * chunk, dtype=torch.int32, device=cuda)
    done = torch.from_numpy((rs.random(B) < 0.1).astype(np.uint8)).to(cuda)
    state = [t.clone() for t in (hits, nsc, done)]
    before = kperm.LAUNCHES["css_mc_scan"]
    kperm.mc_scan(words, active, k0, chunk, runs, 10, *state)
    torch.cuda.synchronize()
    assert kperm.LAUNCHES["css_mc_scan"] == before + 1
    plain = [t.cpu() for t in (hits, nsc, done)]
    kperm.mc_scan_plain(words.cpu(), active.cpu(), k0, chunk, runs, 10, *plain)
    for got, want in zip(state, plain):
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [100, 256, 512])
@pytest.mark.parametrize("m", [2, 9, 21])
@pytest.mark.parametrize("nwin", TILE_EDGE_WINDOWS)
def test_css_mc_power_shared_tile_edges(cuda, nwin, m, chunk):
    """K9's shared stream at the tile edges: the same bits in two calls,
    and power sums within the float32 rounding of the scores of the plain
    version.  POWER_RTOL does not apply here: the plain product is
    cuBLAS's, which sums [997, 441] @ [441, 100] in another order than the
    kernel's FMA chain (on 19,997 windows the two orders agree and the sums
    meet POWER_RTOL, chip_smoke.py phase 10), and the terms D_e M_eK
    cancel, so two orders of one score differ by up to 2 gamma_{m^2} sum_e
    |D_e M_eK| (gamma_n = n u / (1 - n u), u = 2^-24), and sum s^q by up
    to sum_K q a^(q-1) of that, a bounding |s|.  A wrong column or window
    moves the sums by the scores themselves."""
    dist, _, asize, bsize, _, _ = _mc_windows(cuda, m, nwin)
    key = rng.fold_in(rng.prng_key(7), 2).to(cuda)
    args = (dist, key, asize, bsize, chunk, 3, 2, "shared")
    k = kperm.null_power_sums(*args)
    k2 = kperm.null_power_sums(*args)
    p = kperm.null_power_sums_plain(*args)
    torch.cuda.synchronize()
    assert k.shape == p.shape == (2, 3, nwin)
    assert torch.equal(k.view(torch.int64), k2.view(torch.int64))
    M = kperm.shared_coeff(key, 3, 2, m, asize, bsize, chunk, cuda).double()
    D = dist.reshape(nwin, m * m).double()
    s = (D @ M).reshape(nwin, 2, chunk)
    u = 2.0 ** -24
    ds = 2 * (m * m * u / (1 - m * m * u)) * (D.abs() @ M.abs()).reshape(nwin, 2, chunk)
    a = s.abs() + ds
    bound = torch.stack([ds.sum(-1), (2 * a * ds).sum(-1), (3 * a * a * ds).sum(-1)])
    scale = torch.stack([(s.abs() ** q).sum(-1) for q in (1, 2, 3)])
    bound = (bound + 1e-12 * scale).permute(2, 0, 1)          # [2, 3, nwin]
    assert bool(((k - p).abs() <= bound).all()), float(((k - p).abs() / bound).max())


@pytest.mark.gpu
@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("stream", ["shared", "window"])
@pytest.mark.parametrize("m", [2, 9, 21, 64])
def test_css_mc_power_kernel(cuda, m, stream, bitgen):
    dist, scores, asize, bsize, chroms, slots = _mc_windows(cuda, m, 64 if m == 64 else 2048)
    key = rng.fold_in(rng.prng_key(7), 2)
    keys = key.to(cuda) if stream == "shared" else rng.window_keys(key.to(cuda), chroms, slots)
    before = kperm.LAUNCHES["css_mc_power"]
    k = kperm.null_power_sums(dist, keys, asize, bsize, 512, 3, 2, stream, bitgen)
    p = kperm.null_power_sums_plain(dist, keys, asize, bsize, 512, 3, 2, stream, bitgen)
    torch.cuda.synchronize()
    assert kperm.LAUNCHES["css_mc_power"] == before + 1
    assert k.shape == p.shape == (2, 3, dist.shape[0]) and k.dtype == torch.float64
    rel = ((k - p).abs() / p.abs().clamp(min=1e-300)).max()
    assert float(rel) <= band(POWER_RTOL, m), float(rel)
    if m == 2:   # every permutation scores the same: the fit is degenerate
        return
    got = kperm.approx_significance(dist, scores, asize, bsize, key, chunk=512,
                                    chroms=chroms, slots=slots, bitgen=bitgen, stream=stream)
    want = kperm.approx_significance_plain(dist, scores, asize, bsize, key, chunk=512,
                                           chroms=chroms, slots=slots, bitgen=bitgen,
                                           stream=stream)
    same = got.nscores == want.nscores
    assert same.mean() >= 0.999
    dl = np.abs(np.log10(got.pvals[same]) - np.log10(want.pvals[same]))
    assert dl.max() <= band(LOG10_P_BAND, m), dl.max()


@pytest.mark.gpu
@pytest.mark.parametrize("asize,bsize", [(11, 10), (5, 4), (1, 1), (32, 32)])
def test_css_mc_coeff_threefry_kernel_bit_equal(cuda, asize, bsize):
    """Threefry draws: 32 chunks of 512 permutations, bit-equal M; at
    32 + 32 some permutations hold tied float32 draws."""
    key = rng.fold_in(rng.prng_key(5), 2)
    m = asize + bsize
    k = kperm.shared_coeff(key, 3, 32, m, asize, bsize, 512, cuda, "threefry")
    p = kperm.shared_coeff_plain(key, 3, 32, m, asize, bsize, 512, cuda, "threefry")
    torch.cuda.synchronize()
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))
    if m == 64:
        keys = torch.stack([rng.fold_in(key, c) for c in range(3, 35)]).to(cuda)
        u = kperm._draws(keys, 512, m, "threefry").sort(dim=-1).values
        assert int((u.diff(dim=-1) == 0).any(dim=-1).sum()) > 0


@pytest.mark.gpu
def test_mc_kernels_refuse_large_panels(cuda):
    dist = torch.zeros((2, 65, 65), device=cuda)
    key = rng.prng_key(0)
    with pytest.raises(NotImplementedError, match="P12"):
        kperm.significance(dist, np.zeros(2), 33, 32, 10, 100, key, stream="window")
    with pytest.raises(NotImplementedError, match="P12"):
        kperm.null_power_sums(dist, rng.window_keys(key, [0, 0], [0, 1]), 33, 32, 512, 0, 2,
                              "window")
    with pytest.raises(NotImplementedError, match="P12"):
        kperm.shared_coeff(key, 0, 1, 65, 33, 32, 256, cuda, "threefry")


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    {"p_mode": "approx"}, {"p_mode": "approx", "mc_stream": "window"},
    {"mc_stream": "window"}, {"mc_stream": "window", "rng": "threefry"},
    {"rng": "threefry"}, {"perm_backend": "native"},
])
def test_run_css_new_options_cuda_matches_cpu(cuda, kw):
    pos, am, bm = make_panel(5_000, 250_000, 11, 10, seed=8)
    cfg = CssConfig(precision="exact", mc_runs=5000, **kw)
    kperm.reset_launches()
    g = run_css(SnpPair(pos, am, bm), 250_000, cfg, device=cuda, seqid="c")
    if kw.get("p_mode") == "approx":
        assert kperm.LAUNCHES["css_mc_power"] >= 1, kperm.LAUNCHES
    elif kw.get("mc_stream") == "window" or kw.get("perm_backend") == "native":
        assert kperm.LAUNCHES["css_mc_window"] == 1, kperm.LAUNCHES
    else:
        assert kperm.COEFF_LAUNCHES["threefry"] >= 1, kperm.COEFF_LAUNCHES
    c = run_css(SnpPair(pos, am, bm), 250_000, cfg, device="cpu", seqid="c")
    assert np.array_equal(g[0] != 0, c[0] != 0) and (c[0] != 0).sum() > 100
    np.testing.assert_allclose(g[0], c[0], rtol=1e-9, atol=0.0)
    scored = c[0] != 0
    if kw.get("p_mode") == "approx":
        dl = np.abs(np.log10(g[1][scored]) - np.log10(c[1][scored]))
        assert (dl > LOG10_P_BAND[21]).sum() <= 1e-3 * scored.sum() + 1, dl.max()
    else:
        assert (g[1] != c[1]).sum() <= 1e-3 * scored.sum() + 1


def _gathered(plan, ids, am, bm):
    """[B, P, a] and [B, P, b] codes of the windows ``ids`` at P = the
    largest window's padded width (rows past a window's npos hold row 0's
    codes), with npos and slots."""
    lo, npos = plan.lo[ids], plan.npos[ids]
    P = kfet._window_pad(int(npos.max()))
    offs = np.arange(P)[None, :]
    idx = np.where(offs < npos[:, None], lo[:, None] + offs, 0)
    return (torch.from_numpy(am[idx]), torch.from_numpy(bm[idx]),
            torch.from_numpy(npos.copy()), torch.from_numpy(plan.slot[ids].copy()))


PANELS_M = {2: (1, 1), 9: (5, 4), 21: (11, 10), 64: (32, 32)}


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("m", [2, 9, 21, 64])
def test_fet_window_kernel(cuda, prec, m):
    asize, bsize = PANELS_M[m]
    pos, am, bm = make_panel(20_000, 1_000_000, asize, bsize, seed=m)
    plan = plan_windows(pos, 1_000_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    av, bv, npos, slot = _gathered(plan, ids, am, bm)
    av, bv = av.to(cuda), bv.to(cuda)
    maxs, nmax = kfet.support_size(asize, bsize), asize + bsize + 2
    key = rng.fold_in(rng.prng_key(3), 0)
    fast = prec == "fast"
    before = kfet.LAUNCHES["fet_window"]
    k = kfet.fet_window_batch(av, bv, npos, 0.95, key, 100, maxs, nmax, fast, slot)
    p = kfet.fet_window_batch_plain(av, bv, npos, 0.95, key, 100, maxs, nmax, fast, slot)
    torch.cuda.synchronize()
    assert kfet.LAUNCHES["fet_window"] == before + 1
    assert k[0].dtype == (torch.float32 if fast else torch.float64)
    assert _rel(k[0], p[0]) <= TOL[prec]
    sd = (k[1].double() - p[1].double()).abs() / p[1].double().abs().clamp(min=1.0)
    assert int((sd > TOL[prec]).sum()) <= 1e-4 * len(ids) + 1


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_fet_window_kernel_equals_k1_k2(cuda, prec):
    """K10 on gathered windows, keyed by the chromosome key, is K1 -> K2
    bit for bit: both run fet_table.cuh and fet_window_stats.cuh."""
    pos, am, bm = make_panel(40_000, 2_000_000, 11, 10, seed=3)
    plan = plan_windows(pos, 2_000_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    vals = torch.from_numpy(np.concatenate([am, bm], axis=1)).to(cuda)
    fast = prec == "fast"
    maxs, nmax = kfet.support_size(11, 10), 23
    logs = kfet.fet_snp_logs(vals, 11, maxs, nmax, fast)
    lo, npos, slot = (torch.from_numpy(a[ids].copy()) for a in (plan.lo, plan.npos, plan.slot))
    key = rng.fold_in(rng.prng_key(2), rng.chrom_hash("chrG"))
    k2 = kfet.fet_aggregate(logs, lo, npos, slot, key, 0.95, 100)
    av, bv, npos_w, slot_w = _gathered(plan, ids, am, bm)
    s, d = kfet.fet_window_batch(av.to(cuda), bv.to(cuda), npos_w, 0.95, key, 100, maxs,
                                 nmax, fast, slot_w)
    assert torch.equal(s, k2[0]) and torch.equal(d, k2[1])


@pytest.mark.gpu
def test_fet_window_kernel_refuses(cuda):
    av = torch.zeros((2, 8, 3), dtype=torch.int16, device=cuda)
    key = rng.prng_key(0)
    with pytest.raises(ValueError, match="rows"):
        kfet.fet_window_batch(av, av, torch.tensor([3, 9]), 0.95, key, 10, 5, 8)
    big = torch.zeros((1, 5000, 3), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        kfet.fet_window_batch(big, big, torch.tensor([4500]), 0.95, key, 10, 5, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("m", [2, 9, 21, 64])
def test_perm_chunk_kernel(cuda, m, bitgen):
    dist, scores, asize, bsize, chroms, slots = _mc_windows(cuda, m, 4096)
    B = dist.shape[0]
    keys = rng.window_keys(rng.fold_in(rng.prng_key(5), 2).to(cuda), chroms, slots)
    need = torch.from_numpy(np.random.default_rng(m).integers(0, 12, size=B)).to(cuda)
    obs = torch.from_numpy(scores).to(cuda)
    for chunk, limit in ((128, 128), (256, 200)):
        before = kperm.LAUNCHES["css_perm_chunk"]
        k = kperm.permutation_chunk(dist, obs, need, limit, keys, asize, bsize, chunk, bitgen)
        p = kperm.permutation_chunk_plain(dist, obs, need, limit, keys, asize, bsize, chunk,
                                          bitgen)
        torch.cuda.synchronize()
        assert kperm.LAUNCHES["css_perm_chunk"] == before + 1
        for a, b in zip(k, p):
            assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.gpu
def test_sharded_step_one_vs_four_shares(cuda):
    from divergence_tpu_torch.parallel import make_divergence_step, make_mesh

    pos, am, bm = make_panel(20_000, 1_000_000, 11, 10, seed=4)
    plan = plan_windows(pos, 1_000_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0][:1996]
    av, bv, npos, slot = _gathered(plan, ids, am, bm)
    key = rng.prng_key(1)
    outs = [make_divergence_step(make_mesh(devices=[cuda] * n), 11, 10)(
        av.to(cuda), bv.to(cuda), npos, slot, key) for n in (1, 4)]
    for name in ("fet_scores", "fet_stddev", "css_scores", "css_valid", "mc_hits"):
        assert torch.equal(outs[0][name], outs[1][name]), name
    assert float(outs[0]["windows_evaluated"]) == len(ids)
    s1, s4 = float(outs[0]["score_sum"]), float(outs[1]["score_sum"])
    assert abs(s1 - s4) <= 1e-9 * abs(s1)
