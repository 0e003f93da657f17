"""The CUDA kernels of divergence_tpu_torch against their plain torch
versions on the card.  Marked ``gpu``: they skip without a CUDA device (a
CUDA kernel has no CPU mode).  Run on a machine with one GPU:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports jax for the JAX tests.)

Tolerances, relative to max(|reference|, 1): FET exact 1e-12, fast 1e-5.
K1's LUT build (``fet_lut``) is held to its plain version at 11 + 10 to
38 + 38 and at lopsided panels, and the wrappers build it once a key
(``lut_cached``: a warm call launches none).
CSS: counts and the MC coefficients exactly equal; CMDS scores exact 1e-9
on windows with eigengap above 1e-6, fast rtol 2e-3 atol 1e-4 (the JAX
package's fast-vs-exact band); MC (nscores, hits) equal on >= 99.9 % of
windows (a float32 near tie may flip between summation orders), each
differing window and each differing hit bit of K7's words a near tie
(TIE_RTOL); K7's stop scan equal to its plain version on every window.
SMACOF (K6): exact 1e-9 on windows whose chosen restart and transform count
agree with the plain version's, the rest at most 0.1 % of windows (+1);
fast mode 2 within FAST_BAND, the JAX package's float32-vs-float64 band
measured on the CPU (tests/test_torch_smacof.py; this file runs without
jax); fast mode 1 against the float64 plain version on the same panel,
within the larger of FAST_BAND and the JAX package's own float32-vs-float64
maximum on that panel (SMACOF_F32_BAND, tests/measure_smacof_band.py);
at m = 128 and 200 both modes within that band measured at that m
(LARGE_SMACOF_BAND).  K8
(``css_mc_window``, float32 mix / threefry and the float64 native form):
(p, n, hits) identical to the plain versions on >= 99.9 % of windows (the
float32 form adds the twin's products in the twin's order).  K9
(``css_mc_power``): power sums within POWER_RTOL of the plain version and
approx p within LOG10_P_BAND where nscores agree (>= 99.9 % of windows),
the bands measured on the CPU (tests/test_torch_approx.py); at the tile
edges the shared stream's sums within the float32 rounding of the plain
version's scores (see the test), and the same bits in two calls; the
window stream to m = 64 bit-equal to its sum order mirrored in torch
(``window_power_order`` of the plain scores) at each of its kernel's
instantiations, on few windows and on 997.  K10
(``fet_window``): FET tolerances against its plain version (stddev beyond
them on at most 0.01 % of windows, + 1) and bit-equal to K1 -> K2 on a
chromosome's windows; a window's bits do not depend on whether its
launch took the warp body (P <= 128) or the block body, in K2, K2r and
K10 alike.  K3 (``css_dissim``, ``css_dissim_gathered``): counts equal to
the plain twins exactly, at unaligned window starts and tail masks (the
large-panel kernel too, at odd and even m, both forms), and
``css_window_batch`` equal to the joint-matrix route it replaced.  K1r (``fet_lut_rank``, ``fet_snp_ranks``): the
sorted LUT's bits and every rank equal to the plain version's on the
kernel's own LUT (signed zeros tied) and at the sort's tile edges; the
scores lut_sorted[ranks] at the FET tolerances.  K2r
(``fet_aggregate_ranks``): FET tolerances against its plain version and
bit-equal to K1 -> K2.  K11 (``css_perm_chunk``):
(hits, reached, pos) identical to the plain version on every window
(non-finite windows included), and its words those of K8's first chunk.
K6 also reports the transforms over every restart, equal to the plain
version's on all but 0.1 % of windows (+1) in exact mode, and in mode 1
equals its torch mirror of the kernel's order (``smacof_pairs``) bit for
bit.  The sharded step: bit-equal per window across a 1- and a 4-share
mesh of one card; the sharded MC (K7 and K8, m = 21 and 128) over four
shares of the card at once byte-equal to one share, its launches those of
the four shares counted one at a time.  Past m = 64 (the large-panel body of
``csrc/css_perm_block.cuh``): K8's (p, n, hits) as above at m = 65 to
300, and its hit words, K11's outputs and K9's window-stream sums equal
to their plain versions on both sides of each switch of their form
(register | shared | split | device: WINDOW_SWITCH); K11 equal to its plain
version on every window; K9's window stream within 1e-12 of its plain
version (the same float32 scores, float64 sums in another order), the
shared stream within m 2^-24 of each sum's magnitude (large_power_band:
its product adds a score's m^2 terms one after another), approx p within
the band the plain version meets against the JAX package at m = 128 and
200 (LARGE_LOG10_P_BAND); the step at 70 + 58 against plain=True.  FET windows
of P = 4,096 to 65,536 SNPs' padding (the wide body past P = 256: the
bootstrap first, then a radix select of the band of ranks it picks): K2 at
the FET tolerances, K2r = K2 and K10 = K1 -> K2 bit for bit; the wide body's
edge cases and its bytes equal to the block body's at the crossover."""

import ctypes
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
from divergence_tpu_torch.kernels._cuda import launch, ptr
from divergence_tpu_torch.tools.synth import make_chromosome, make_freq_chromosome, make_panel

TOL = {"exact": 1e-12, "fast": 1e-5}
TIE_RTOL = 1e-5   # float32 near tie (tests/test_torch_mc.py)
# approx mode, keyed by the largest m they cover (tests/test_torch_approx.py)
POWER_RTOL = {21: 1e-6, 64: 3e-6}
LOG10_P_BAND = {21: 2e-5, 64: 3e-4}
# approx mode past m = 64, keyed likewise: |log10 p| against the plain
# version, the band the port's plain version meets against the JAX package
# at m = 128 and 200, measured on the CPU (tests/test_torch_large_panels_mc.py)
LARGE_LOG10_P_BAND = {128: 1e-2, 200: 1e-2}


def large_power_band(m: int) -> float:
    """K9's shared stream past m = 64 against its plain version, by
    power_err: m u (u = 2^-24).  The kernel adds a score's m^2 products
    one after another in one float32 register (tile_gemm), the plain
    version's matmul in blocks, so the kernel's sums drift like m
    roundings of a score: 0.36-0.55 m u on this file's panels at m = 21 to
    300, 0.81-0.90 m u on chip_smoke.py's 19,997 windows, the plain
    version's 0.12 m u or less (tests/measure_large_forms.py)."""
    return m * 2.0 ** -24


def power_err(k: torch.Tensor, p: torch.Tensor, n: int) -> float:
    """Largest |k - p| of [chunks, 3, B] power sums of n scores against n
    rms^q (rms^2 = p[:, 1] / n): each sum's error against its magnitude,
    which a sum near zero cannot inflate."""
    rms = (p[:, 1:2] / n).sqrt()
    q = torch.arange(1, 4, device=p.device, dtype=p.dtype)[None, :, None]
    return float(((k - p).abs() / (n * rms ** q)).max())


def band(table: dict, m: int) -> float:
    return table[min(k for k in table if k >= m)]

# mds -> (max, 90th percentile): tests/test_torch_smacof.py FAST_BAND
FAST_BAND = {1: (5.5e-2, 7e-4), 2: (1.53e-1, 7e-4)}
# m -> the JAX package's own float32-vs-float64 maximum of the mode-1 score
# on test_css_smacof_kernel's panel (tests/measure_smacof_band.py: 8.64e-2,
# 6.83e-2, 1.57e-2), rounded up in its second significant digit
SMACOF_F32_BAND = {21: 8.7e-2, 33: 6.9e-2, 64: 1.6e-2}
# (mode, m) -> the JAX package's own float32-vs-float64 maximum and 90th
# percentile of the SMACOF score at the large panel sizes, rounded up in
# the second digit (tests/measure_smacof_band.py 128:300:256 200:200:256
# and --mds 2 128:300 200:200: 3.157e-4 / 1.540e-5, 1.039e-4 / 2.962e-7,
# 2.265e-3 / 1.141e-4, 2.568e-3 / 6.127e-5); FAST_BAND at other m
LARGE_SMACOF_BAND = {(1, 128): (3.2e-4, 1.6e-5), (1, 200): (1.1e-4, 3.0e-7),
                     (2, 128): (2.3e-3, 1.2e-4), (2, 200): (2.6e-3, 6.2e-5)}


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
    """K1's LUT build against its plain version; ``fet_lut`` launches it
    on every call, the cache once a key: a cleared cache builds once, a
    warm call returns the same storage and launches nothing."""
    dt = torch.float64 if prec == "exact" else torch.float32
    maxs, nmax = kfet.support_size(asize, bsize), asize + bsize + 2
    before = kfet.LAUNCHES["fet_lut_build"]
    k = kfet.fet_lut(asize, bsize, maxs, nmax, dt, cuda)
    p = kfet.fet_lut_plain(asize, bsize, maxs, nmax, dt, cuda)
    torch.cuda.synchronize()
    assert kfet.LAUNCHES["fet_lut_build"] == before + 1
    assert k.dtype == dt and bool(torch.isfinite(k).all())
    assert _rel(k, p) <= TOL[prec]
    kfet.clear_lut_cache()
    before = kfet.LAUNCHES["fet_lut_build"]
    cold = kfet.lut_cached(asize, bsize, maxs, nmax, dt, cuda)
    assert kfet.LAUNCHES["fet_lut_build"] == before + 1
    warm = kfet.lut_cached(asize, bsize, maxs, nmax, dt, cuda)
    assert kfet.LAUNCHES["fet_lut_build"] == before + 1
    assert warm.data_ptr() == cold.data_ptr() and torch.equal(_bits(cold), _bits(k))


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize", [(15, 15), (20, 20), (38, 38), (13, 2), (200, 1),
                                         (350, 1)])
def test_lut_kernel_panels(cuda, prec, asize, bsize):
    """K1's LUT build against its plain version at K1r's larger panels and
    at lopsided ones, whose unreachable entries' margins pass nmax
    (lchoose's clamps) and whose support runs to 102 and 177 points; one
    launch each."""
    assert kfet.lut_active(asize, bsize)
    dt = torch.float64 if prec == "exact" else torch.float32
    maxs, nmax = kfet.support_size(asize, bsize), asize + bsize + 2
    before = kfet.LAUNCHES["fet_lut_build"]
    k = kfet.fet_lut(asize, bsize, maxs, nmax, dt, cuda)
    p = kfet.fet_lut_plain(asize, bsize, maxs, nmax, dt, cuda)
    torch.cuda.synchronize()
    assert kfet.LAUNCHES["fet_lut_build"] == before + 1
    assert bool(torch.isfinite(k).all()) and _rel(k, p) <= TOL[prec]


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
    """A window past the old 4,096-SNP limit runs (float64 keys at P =
    8,192: the wide body) and equals its plain version; a window reaching past the
    chromosome's SNPs is still refused."""
    logs = torch.from_numpy(np.random.default_rng(0).random(5000)).to(cuda)
    one = torch.zeros(1, dtype=torch.int64)
    k = kfet.fet_aggregate(logs, one, one + 4500, one, rng.prng_key(0), 0.95, 100)
    p = kfet.fet_aggregate_plain(logs, one, one + 4500, one, rng.prng_key(0), 0.95, 100)
    assert _rel(k, p) <= TOL["exact"]
    with pytest.raises(ValueError, match="outside"):
        kfet.fet_aggregate(logs, one + 4990, one + 20, one, rng.prng_key(0), 0.95, 100)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_fet_cuda_matches_cpu(cuda, prec):
    pos, am, bm = make_panel(20_000, 1_000_000, 11, 10, seed=8)
    cfg = FetConfig(precision=prec)
    kfet.reset_launches()
    kfet.clear_lut_cache()   # a cold run builds (and, exact, sorts) the LUT once
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


def _lut_rank_agrees(lut):
    """K1r's sort of a LUT on the card against its plain version on the
    CPU, bit for bit (ranks and the sorted values' bits), with one launch
    counted."""
    before = kfet.LAUNCHES["fet_lut_rank"]
    ks, kr = kfet.fet_lut_rank(lut)
    ps, pr = kfet.fet_lut_rank_plain(lut.cpu())
    torch.cuda.synchronize()
    assert kfet.LAUNCHES["fet_lut_rank"] == before + 1
    assert kr.dtype == torch.int32
    assert torch.equal(kr.cpu(), pr)
    assert torch.equal(_bits(ks.cpu()), _bits(ps))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("G", [5000, 100_000])
def test_lut_rank_kernel_ties_signed_zeros(cuda, dtype, G):
    """K1r's sort on a LUT of few values with both signed zeros: the CPU
    plain version's order (IEEE <, ties by index), on 5,000 entries (five
    tiles) and 100,000."""
    rs = np.random.default_rng(G)
    lut = torch.from_numpy(rs.choice(np.array([0.0, -0.0, 2.5, 0.125, 7.0]), size=G)).to(dtype)
    _lut_rank_agrees(lut.to(cuda))


# where a LUT's size meets an edge of the sort's tiles: one entry; one
# tile of 256 x 4 entries and one more; 17 tiles (past a look-back window
# of 16 tiles' words); 2^16 and one more; the switch from 4 to 16 entries
# a thread (2 x 132 SMs x 4,096 entries on an H100) and one below
LUT_RANK_EDGES = ("1", "1024", "1025", "16385", "65536", "65537", "items_edge-1",
                  "items_edge")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("edge", LUT_RANK_EDGES)
def test_lut_rank_kernel_tile_edges(cuda, dtype, edge):
    """K1r's sort at its tiles' edges: LUT-like values (runs of +0.0 and
    -0.0, long runs of duplicates, subnormals, 1e-300, values whose every
    digit varies) equal to the plain version's order bit for bit."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    G = (2 * sms * 4096 - (edge == "items_edge-1") if edge.startswith("items_edge")
         else int(edge))
    rs = np.random.default_rng(G)
    pool = np.array([0.0, -0.0, 1e-300, 5e-324, 2.2e-308, 1e-40, 1e-16, 1.0, 3.5, 40.0])
    vals = np.where(rs.random(G) < 0.5, rs.choice(pool, size=G), rs.random(G) * 8.0)
    vals[: G // 8] = -0.0                      # a long run of one key, both zeros
    _lut_rank_agrees(torch.from_numpy(vals).to(dtype).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize", [(11, 10), (15, 15), (20, 20), (38, 38)])
def test_lut_rank_kernel(cuda, prec, asize, bsize):
    """K1r's LUT sort against its plain version on K1's LUT, exactly, at
    11 + 10, 15 + 15, 20 + 20 and 38 + 38, the largest symmetric panel
    with a LUT (2.3 M entries)."""
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
    kfet.clear_lut_cache()
    before = dict(kfet.LAUNCHES)
    ls, r = kfet.fet_snp_ranks(vals, asize, maxs, nmax, fast)
    pls, pr = kfet.fet_snp_ranks_plain(vals, asize, maxs, nmax, fast)
    torch.cuda.synchronize()
    # a cold call builds and sorts the LUT once; a warm one only looks up
    assert all(kfet.LAUNCHES[k] == before[k] + 1
               for k in ("fet_lut_build", "fet_lut_rank", "fet_snp_ranks")), kfet.LAUNCHES
    ls2, r2 = kfet.fet_snp_ranks(vals, asize, maxs, nmax, fast)
    assert [kfet.LAUNCHES[k] - before[k] for k in
            ("fet_lut_build", "fet_lut_rank", "fet_snp_ranks")] == [1, 1, 2], kfet.LAUNCHES
    assert ls2.data_ptr() == ls.data_ptr() and torch.equal(r2, r)
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
    # a window past the old 4,096-SNP limit: K2r = K2 there too
    one = torch.zeros(1, dtype=torch.int64)
    assert torch.equal(kfet.fet_aggregate_ranks(ls, r, one, one + 4500, one, key, 0.95, 100),
                       kfet.fet_aggregate(logs, one, one + 4500, one, key, 0.95, 100))


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


def _edge_windows(m, shift, seed):
    """Codes [N, m] and windows (lo, npos) of lengths 0, 1, 31, 32, 33, 87
    and 4096 starting at lo % 32 == shift; the longest ends on the last
    SNP (tests/test_torch_css_bitplanes.py's windows)."""
    rs = np.random.default_rng(seed)
    N = 4096 + 64 + shift
    vals = rs.choice(np.array([3, -3, 0, -10000], np.int16), size=(N, m),
                     p=[0.35, 0.3, 0.25, 0.1])
    lengths = [0, 1, 31, 32, 33, 87, 4096]
    lo = np.array([96 * i + shift for i in range(6)] + [N - 4096], dtype=np.int64)
    return torch.from_numpy(vals), torch.from_numpy(lo), torch.tensor(lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [0, 1, 31])
@pytest.mark.parametrize("m", [2, 21, 64])
def test_css_dissim_kernel_edges(cuda, m, shift):
    """K3's funnel shift and tail mask: windows at lo % 32 in {0, 1, 31}
    of 0 to 4,096 SNPs, equal to the plain twin and to the bit-plane
    mirror."""
    vals, lo, npos = _edge_windows(m, shift, seed=m + shift)
    want = kcss.dissimilarity_plain(vals, lo, npos)
    mirror = kcss.dissimilarity_bitplanes_plain(kcss.pack_bitplanes_plain(vals), lo, npos)
    assert torch.equal(mirror, want)
    for dt in (torch.float64, torch.float32):
        k = kcss.css_dissim(vals.to(cuda), lo, npos, dt)
        assert k.dtype == dt and torch.equal(k.double().cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [32, 128, 4096])
@pytest.mark.parametrize("asize,bsize", [(11, 10), (1, 1), (32, 32), (48, 48)])
def test_css_dissim_gathered_kernel(cuda, asize, bsize, P):
    """K4's gather form from separate a and b codes: equal to the plain
    twin on every window, rows past npos holding codes that must not
    count; one launch a call."""
    rs = np.random.default_rng(asize + bsize + P)
    B = 37
    codes = np.array([3, -3, 0, -10000], np.int16)
    av = torch.from_numpy(rs.choice(codes, size=(B, P, asize)))
    bv = torch.from_numpy(rs.choice(codes, size=(B, P, bsize)))
    npos = torch.from_numpy(rs.integers(0, P + 1, size=B))
    npos[:4] = torch.tensor([0, 1, P, P - 1])
    want = kcss.dissimilarity_gathered_plain(av, bv, npos)
    for dt in (torch.float64, torch.float32):
        before = kcss.LAUNCHES["css_dissim_gathered"]
        k = kcss.css_dissim_gathered(av.to(cuda), bv.to(cuda), npos, dt)
        torch.cuda.synchronize()
        assert kcss.LAUNCHES["css_dissim_gathered"] == before + 1
        assert k.dtype == dt and torch.equal(k.double().cpu(), want)
    with pytest.raises(ValueError, match="rows"):
        kcss.css_dissim_gathered(av.to(cuda), bv.to(cuda), npos + P, torch.float64)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("mds", [0, 1])
def test_css_window_batch_equals_joint_route(cuda, prec, mds):
    """css_window_batch on the card (K4's gather form on the a and b codes)
    equals the route it replaced — one joint [B P, a + b] matrix through
    css_phase1 (K3 on windows at b P) — bit for bit."""
    pos, am, bm = make_panel(20_000, 1_000_000, 11, 10, seed=6)
    plan = plan_windows(pos, 1_000_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    av, bv, npos, slot = _gathered(plan, ids, am, bm)
    av, bv = av.to(cuda), bv.to(cuda)
    key = rng.fold_in(rng.prng_key(4), 1)
    fast = prec == "fast"
    got = kcss.css_window_batch(av, bv, npos, key, 11, 10, mds=mds, fast=fast, slot=slot)
    B, P = av.shape[:2]
    joint = torch.cat([av, bv], dim=-1).reshape(B * P, 21).contiguous()
    want = kcss.css_phase1(joint, torch.arange(B) * P, npos, 11, 10, fast=fast, mds=mds,
                           key=key, slots=slot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def _negative_windows(n, m, dt, device, seed=0):
    """Windows whose diagonal (2) exceeds every off-diagonal entry (~1):
    the filled f^2 is ~11' + 3I, so B = -0.5 J f^2 J is ~-1.5 J, lambda2
    truly negative and the scores NaN (outside the dust band)."""
    d = 1.0 + 0.01 * np.random.default_rng(seed).random((n, m, m))
    d = (d + d.transpose(0, 2, 1)) / 2
    d[:, np.arange(m), np.arange(m)] = 2.0
    return torch.from_numpy(d).to(device, dt)


# m = 2, 3, 21, 33, 64: the tridiagonal solver's edges (no reflector, one,
# a single lane's rows, rows l and l + 32, the largest slab)
CMDS_SHAPES = [(1, 1), (2, 1), (11, 10), (17, 16), (32, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize", CMDS_SHAPES)
def test_css_cmds_kernel(cuda, prec, asize, bsize):
    dt = torch.float64 if prec == "exact" else torch.float32
    m = asize + bsize
    vals, lo, npos = _css_windows(cuda, asize, bsize)
    real = kcss.dissimilarity_plain(vals, lo, npos).to(dt)
    nneg = 8
    dis = torch.cat([real, _negative_windows(nneg, m, dt, cuda)]).contiguous()
    npos_d = torch.cat([npos, torch.ones(nneg, dtype=npos.dtype)]).to(cuda)
    B = dis.shape[0]
    steps = torch.full((B,), -1, dtype=torch.int32, device=cuda)
    ks, kd, kv = kcss.css_cmds(dis, npos_d, asize, bsize, steps=steps)
    ps, pd, pv = kcss.css_cmds_plain(dis, npos_d, asize, bsize)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv)
    assert torch.equal(ks.isnan(), ps.isnan())
    assert torch.equal(kd.isnan(), pd.isnan())
    assert ps[-nneg:].isnan().all()
    assert int(steps.min()) > 0 and int(steps.max()) <= 64
    filled, _ = kcss.fill_averages(dis.double())
    ev = torch.linalg.eigvalsh(kcss.double_centre(filled)).flip(-1)
    gap = ev[:, 1] - ev[:, 2] if m > 2 else torch.ones_like(ev[:, 0])
    ok = (gap / ev[:, 0].abs().clamp(min=1.0) > 1e-6) & ~ps.isnan()
    assert int((~ok[:-nneg]).sum()) <= 0.01 * (B - nneg)
    got, want = ks.double()[ok].cpu().numpy(), ps.double()[ok].cpu().numpy()
    if prec == "exact":
        assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)) <= 1e-9
    else:
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4)


# the large panels: m = 65, 128, 200, 300 and both sides of each kernel's
# shared-memory switches (test_kernel_forms_switch_where_the_slabs_stop_fitting
# pins where they fall on an H100)
LARGE_M = [65, 128, 200, 300]
DISSIM_SWITCH = [112, 113]                       # warp form | tiles
GATHERED_SWITCH = [207, 208]                     # at a = (m + 1) // 2
# K5 and K6: both sides of each switch their form queries report up to
# SWITCH_TOP (warp | block | device), read on the card by _switch_sizes
SWITCH_TOP = 400
# K7's coefficients: thread | block (each column ranked once into device
# scratch; 908 | 909 was the switch from shared to device memory before)
COEFF_SWITCH = [64, 65, 908, 909]
# K8 / K11 / K9 window stream: register | shared | split | device (float32,
# float64): the window's D and 16 warps' 8-bit tables in a block's
# shared memory, then D there and the tables in device scratch, then D in
# place and 16-bit tables in device scratch
WINDOW_SWITCH = {"f32": [64, 65, 128, 129, 232, 233], "f64": [64, 65, 184, 185, 239, 240]}
# the MC's large-panel body: its register sort (p = 128, 256) and key slab
# (p = 512), both forms
MC_LARGE_M = [65, 128, 200, 256, 257, 300]
# K2 / K2r / K10 by (key bytes, value bytes): warp | block | wide (the
# block body takes P = 256 alone, tests/measure_large_forms.py)
FET_SWITCH = {(8, 8): [128, 256, 256, 512], (4, 4): [128, 256, 256, 512],
              (4, 8): [128, 256, 256, 512]}


def _switch_sizes(form, lo: int = 2, hi: int = SWITCH_TOP) -> list:
    """The panel sizes on both sides of each switch of ``form(m)`` between
    lo and hi: the last m of one form and the first of the next."""
    out, prev = [], form(lo)
    for m in range(lo + 1, hi + 1):
        cur = form(m)
        if cur != prev:
            out += [m - 1, m]
        prev = cur
    return out


@pytest.mark.gpu
def test_kernel_forms_switch_where_the_slabs_stop_fitting(cuda):
    """Where each wrapper leaves a kernel's small form on an H100 (232,448
    bytes of shared memory a block), as the kernel library's form queries
    reckon it from the kernels' own slab layouts (the tests above run both
    sides of each switch)."""
    f64, f32 = torch.float64, torch.float32
    assert [kcss.dissim_form(m) for m in (112, 113, 300)] == ["warp", "tiles", "tiles"]
    assert [kcss.gathered_form((m + 1) // 2, m // 2) for m in (207, 208)] == ["warp", "tiles"]
    assert [kcss.cmds_form(m, f64) for m in (64, 75, 76, 221, 222)] == [
        "warp", "warp", "block", "block", "device"]
    assert [kcss.cmds_form(m, f32) for m in (111, 112, 321, 322)] == [
        "warp", "block", "block", "device"]
    for mds in (1, 2):
        assert [kcss.smacof_form(m, mds, f64) for m in (64, 68, 69, 203, 204)] == [
            "warp", "warp", "block", "block", "device"]
        assert [kcss.smacof_form(m, mds, f32) for m in (97, 98, 302, 303)] == [
            "warp", "block", "block", "device"]
    assert _switch_sizes(lambda m: kcss.cmds_form(m, f64)) == [75, 76, 221, 222]
    assert _switch_sizes(lambda m: kcss.smacof_form(m, 1, f32)) == [97, 98, 302, 303]
    # at 110 + 90 in float64 K6 keeps its slab in shared memory
    assert kcss.smacof_form(200, 1, f64) == "block"
    assert [kperm.coeff_form(m) for m in COEFF_SWITCH] == [
        "thread", "block", "block", "block"]
    assert [kcss.smacof_lanes(m, 1, f64) for m in (68, 69)] == [kcss.WARP_LANES,
                                                               kcss.BLOCK_LANES]
    # K8 (its float64 form too), K11 and K9's window stream: their per-warp
    # tables; K2 / K2r / K10: a window's keys and replicates
    assert [kperm.window_form(m) for m in WINDOW_SWITCH["f32"]] == [
        "register", "shared", "shared", "split", "split", "device"]
    assert [kperm.window_form(m, native=True) for m in WINDOW_SWITCH["f64"]] == [
        "register", "shared", "shared", "split", "split", "device"]
    for (kb, vb), sizes in FET_SWITCH.items():
        assert [kfet.window_form(P, 100, kb, vb) for P in sizes] == [
            "warp", "block", "block", "wide"], (kb, vb)
    # at 70 + 58 and 110 + 90 every large-panel kernel runs
    for m in (128, 200):
        assert kcss.dissim_form(m) == "tiles" and kperm.coeff_form(m) == "block"
        assert kcss.cmds_form(m, f64) == "block" and kcss.smacof_form(m, 1, f32) == "block"


def _large_windows(cuda, m, limit):
    """(codes [N, m] on the card, lo, npos, slots on the card, asize, bsize)
    of the first ``limit`` windows of a stickleback-shaped panel at m."""
    asize, bsize = (m + 1) // 2, m // 2
    pos, am, bm = make_panel(4_000, 200_000, asize, bsize, seed=m)
    plan = plan_windows(pos, 200_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0][:limit]
    vals = torch.from_numpy(np.concatenate([am, bm], axis=1).astype(np.int16)).to(cuda)
    lo, npos, slots = (torch.from_numpy(x[ids].copy()) for x in (plan.lo, plan.npos, plan.slot))
    return vals, lo, npos, slots.to(cuda), asize, bsize


@pytest.mark.gpu
@pytest.mark.parametrize("m", LARGE_M + DISSIM_SWITCH + GATHERED_SWITCH)
def test_css_dissim_kernels_large_panels(cuda, m):
    """K3's counts at large m in both forms and both precisions, equal to
    the plain twins (the tile form above the warp form's switch)."""
    vals, lo, npos, _, asize, bsize = _large_windows(cuda, m, 96)
    want = kcss.dissimilarity_plain(vals, lo, npos)
    offs = torch.arange(int(npos.max()), device=cuda)[None, :]
    lo_d, npos_d = lo.to(cuda)[:, None], npos.to(cuda)[:, None]
    g = vals[torch.where(offs < npos_d, lo_d + offs, lo_d)]
    av, bv = g[..., :asize].contiguous(), g[..., asize:].contiguous()
    before = dict(kcss.LAUNCHES)
    for dt in (torch.float32, torch.float64):
        assert torch.equal(kcss.css_dissim(vals, lo, npos, dt).double(), want)
        assert torch.equal(kcss.css_dissim_gathered(av, bv, npos, dt).double(), want)
    torch.cuda.synchronize()
    tiles = kcss.LAUNCHES["css_dissim_tiles"] - before["css_dissim_tiles"]
    assert tiles == 2 * (kcss.dissim_form(m) == "tiles") + 2 * (
        kcss.gathered_form(asize, bsize) == "tiles")


# K3's large-panel kernel (css_dissim_rows): odd and even m past the warp
# form's switch, the gathered form's tiles at 209
LARGE_DISSIM_M = [113, 129, 200, 209]


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [0, 1, 31])
@pytest.mark.parametrize("m", LARGE_DISSIM_M)
def test_css_dissim_large_kernel_edges(cuda, m, shift):
    """K3's large-panel kernel at the funnel shift's edges: windows at lo %
    32 in {0, 1, 31} of 0 to 4,096 SNPs (the longest in 16 slabs of 8
    words), in both forms and both precisions, equal to the plain twins
    and to the rows mirror; at odd m the rows of a window start off a
    16-byte boundary (the scalar head and tail)."""
    vals, lo, npos = _edge_windows(m, shift, seed=3 * m + shift)
    want = kcss.dissimilarity_plain(vals, lo, npos)
    mirror = kcss.dissimilarity_rows_plain(kcss.pack_bitplanes_plain(vals), lo, npos)
    assert torch.equal(mirror, want)
    asize, bsize = (m + 1) // 2, m // 2
    P = int(npos.max())
    offs = torch.arange(P)[None, :]
    g = vals[torch.where(offs < npos[:, None], lo[:, None] + offs, lo[:, None])]
    av, bv = g[..., :asize].contiguous().to(cuda), g[..., asize:].contiguous().to(cuda)
    vd = vals.to(cuda)
    before = kcss.LAUNCHES["css_dissim_tiles"]
    for dt in (torch.float32, torch.float64):
        k = kcss.css_dissim(vd, lo, npos, dt)
        assert k.dtype == dt and torch.equal(k.double().cpu(), want)
        kg = kcss.css_dissim_gathered(av, bv, npos, dt)
        assert kg.dtype == dt and torch.equal(kg.double().cpu(), want)
    torch.cuda.synchronize()
    assert kcss.dissim_form(m) == "tiles"
    assert kcss.LAUNCHES["css_dissim_tiles"] - before == 2 + 2 * (
        kcss.gathered_form(asize, bsize) == "tiles")


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("which", ["large", "switch"])
def test_css_cmds_kernel_large_panels(cuda, prec, which):
    """K5 at large m (the block form, its slab in shared or device memory)
    against its plain version: exact 1e-9 / fast rtol 2e-3 atol 1e-4 on
    windows whose eigengap exceeds 1e-6, valid flags and NaN patterns
    equal (truly negative lambda2 windows included)."""
    dt = torch.float64 if prec == "exact" else torch.float32
    switches = _switch_sizes(lambda m: kcss.cmds_form(m, dt))
    for m in (LARGE_M if which == "large" else switches):
        vals, lo, npos, _, asize, bsize = _large_windows(cuda, m, 48)
        real = kcss.dissimilarity_plain(vals, lo, npos).to(dt)
        dis = torch.cat([real, _negative_windows(4, m, dt, cuda)]).contiguous()
        npos_d = torch.cat([npos, torch.ones(4, dtype=npos.dtype)]).to(cuda)
        steps = torch.full((dis.shape[0],), -1, dtype=torch.int32, device=cuda)
        ks, kd, kv = kcss.css_cmds(dis, npos_d, asize, bsize, steps=steps)
        ps, pd, pv = kcss.css_cmds_plain(dis, npos_d, asize, bsize)
        torch.cuda.synchronize()
        assert torch.equal(kv, pv) and torch.equal(ks.isnan(), ps.isnan()), m
        assert ps[-4:].isnan().all() and int(steps.min()) > 0
        filled, _ = kcss.fill_averages(dis.double())
        ev = torch.linalg.eigvalsh(kcss.double_centre(filled)).flip(-1)
        ok = ((ev[:, 1] - ev[:, 2]) / ev[:, 0].abs().clamp(min=1.0) > 1e-6) & ~ps.isnan()
        got, want = ks.double()[ok].cpu().numpy(), ps.double()[ok].cpu().numpy()
        if prec == "exact":
            assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)) <= 1e-9, m
        else:
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4)
        assert torch.equal(kd.isnan(), pd.isnan())


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("mds", [1, 2])
@pytest.mark.parametrize("which", ["large", "switch"])
def test_css_smacof_kernel_large_panels(cuda, prec, mds, which):
    """K6 at large m (the block form) against its plain version: exact 1e-9
    where restart and transform count agree (the rest at most 0.1 % + 1),
    fast within the JAX package's own float32 band at m = 128 and 200
    (LARGE_SMACOF_BAND), FAST_BAND at the other m."""
    dt = torch.float64 if prec == "exact" else torch.float32
    key = rng.fold_in(rng.prng_key(3), rng.chrom_hash("chrK"))
    switches = _switch_sizes(lambda m: kcss.smacof_form(m, mds, dt))
    for m in (LARGE_M if which == "large" else switches):
        vals, lo, npos, slots, asize, bsize = _large_windows(cuda, m, 16)
        dis = kcss.dissimilarity_plain(vals, lo, npos).to(dt).contiguous()
        npos_d = npos.to(cuda)
        kt = torch.zeros(dis.shape[0], dtype=torch.int32, device=cuda)
        pt = torch.zeros(dis.shape[0], dtype=torch.int32, device=cuda)
        ks, _, kv, kr, kn = kcss.css_smacof(dis, npos_d, asize, bsize, mds, key, slots,
                                            transforms=kt)
        ps, _, pv, pr, pn = kcss.css_smacof_plain(dis, npos_d, asize, bsize, mds, key, slots,
                                                  transforms=pt)
        torch.cuda.synchronize()
        assert torch.equal(kv, pv) and torch.equal(ks.isnan(), ps.isnan()), m
        sel = pv & ~ps.isnan()
        got, want = ks.double()[sel].cpu().numpy(), ps.double()[sel].cpu().numpy()
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        if prec == "exact":
            agree = ((kr == pr) & (kn == pn))[sel].cpu().numpy()
            assert rel[agree].max(initial=0.0) <= 1e-9, m
            assert int((~agree).sum()) <= 1e-3 * dis.shape[0] + 1
            assert int((kt != pt).sum()) <= 1e-3 * dis.shape[0] + 1
        else:
            top, q90 = LARGE_SMACOF_BAND.get((mds, m), FAST_BAND[mds])
            assert rel.max(initial=0.0) <= top and np.quantile(rel, 0.9) <= q90, m


@pytest.mark.gpu
@pytest.mark.parametrize("m", [69, 128, 200])
def test_css_smacof_block_is_its_mirror(cuda, monkeypatch, m):
    """Mode 1 float64 in the block form equals smacof_pairs with its thread
    count (the block form's fused pass: rows snaked over 8 warps, each
    row's sums from the warps' column partials in warp order and its own
    butterflied row partial, the stress from the lanes' partials, the
    warps' butterflies in warp order) bit for bit."""
    vals, lo, npos, slots, asize, bsize = _large_windows(cuda, m, 16)
    dis = kcss.dissimilarity_plain(vals, lo, npos).contiguous()
    npos_d = npos.to(cuda)
    key = rng.fold_in(rng.prng_key(3), rng.chrom_hash("chrK"))
    lanes = kcss.smacof_lanes(m, 1, torch.float64)
    assert lanes == kcss.BLOCK_LANES
    kt = torch.zeros(dis.shape[0], dtype=torch.int32, device=cuda)
    mt = torch.zeros(dis.shape[0], dtype=torch.int32, device=cuda)
    k = kcss.css_smacof(dis, npos_d, asize, bsize, 1, key, slots, 4, transforms=kt)
    monkeypatch.setattr(kcss, "_smacof_loop", lambda d, x0, it, eps: kcss.smacof_pairs(
        d, x0, it, eps, lanes=lanes))
    p = kcss.css_smacof_plain(dis, npos_d, asize, bsize, 1, key, slots, 4, transforms=mt)
    assert torch.equal(k[1], p[1])
    assert torch.equal(k[3], p[3]) and torch.equal(k[4], p[4]) and torch.equal(kt, mt)


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
@pytest.mark.parametrize("mds,n_init", [(1, 1), (1, 4), (1, 8), (2, 1)])
@pytest.mark.parametrize("m", [2, 3, 21, 33, 64])
def test_css_smacof_kernel(cuda, monkeypatch, prec, mds, n_init, m):
    """K6 against its plain version: restarts 1, 4 and 8 (mode 1) and the
    CMDS start (mode 2), m across one warp's pairs (1, 3, 210, 528 and
    2016 pairs); the transforms over every restart counted alike.  Fast
    mode 1 is held to the float64 plain version on the same panel from the
    same float32 restarts (as tests/measure_smacof_band.py measures JAX's
    band), within the larger of FAST_BAND and the JAX package's own
    float32 band there: two float32 orders may stop a restart at different
    transforms (the stop's epsilon is below a float32 ulp of the stress)
    and so pick different restarts, as JAX's float32 does against its
    float64."""
    dt = torch.float64 if prec == "exact" else torch.float32
    dis, asize, bsize, npos, slots = _smacof_dis(cuda, m, dt)
    key = rng.fold_in(rng.prng_key(3), rng.chrom_hash("chrK"))
    B = dis.shape[0]
    kt = torch.zeros(B, dtype=torch.int32, device=cuda)
    pt = torch.zeros(B, dtype=torch.int32, device=cuda)
    before = kcss.LAUNCHES["css_smacof"]
    ks, kd, kv, kr, kn = kcss.css_smacof(dis, npos, asize, bsize, mds, key, slots, n_init,
                                         transforms=kt)
    ps, pd, pv, pr, pn = kcss.css_smacof_plain(dis, npos, asize, bsize, mds, key, slots,
                                               n_init, transforms=pt)
    torch.cuda.synchronize()
    assert kcss.LAUNCHES["css_smacof"] == before + 1
    assert torch.equal(kv, pv) and torch.equal(ks.isnan(), ps.isnan())
    assert int(kn.max()) <= 301 and int(kn.min()) >= 1
    assert bool(((kt >= kn) & (kt <= n_init * 301)).all())
    assert bool((kr >= 0).all() and (kr < n_init).all())
    sel = ~ps.isnan() & pv
    got, want = ks.double()[sel].cpu().numpy(), ps.double()[sel].cpu().numpy()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    if prec == "exact":
        agree = ((kr == pr) & (kn == pn))[sel].cpu().numpy()
        assert rel[agree].max(initial=0.0) <= 1e-9
        assert int((~agree).sum()) <= 1e-3 * B + 1
        assert int((kt != pt).sum()) <= 1e-3 * B + 1
    else:
        top, q90 = FAST_BAND[mds]
        if mds == 1:
            dis64 = _smacof_dis(cuda, m, torch.float64)[0]
            draw = rng.smacof_inits
            monkeypatch.setattr(rng, "smacof_inits", lambda wkeys, n, width, dtype: draw(
                wkeys, n, width, torch.float32).to(dtype))
            ps, _, pv, _, _ = kcss.css_smacof_plain(dis64, npos, asize, bsize, mds, key,
                                                    slots, n_init)
            assert torch.equal(kv, pv) and torch.equal(ks.isnan(), ps.isnan())
            sel = ~ps.isnan() & pv
            got, want = ks.double()[sel].cpu().numpy(), ps[sel].cpu().numpy()
            rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
            top = max(top, SMACOF_F32_BAND.get(m, 0.0))
        assert rel.max(initial=0.0) <= top and np.quantile(rel, 0.9) <= q90


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("m", [3, 9, 21, 33, 64])
def test_css_smacof_kernel_is_its_mirror(cuda, monkeypatch, prec, m):
    """Mode 1 in K6's order of operations (kernels/css.py smacof_pairs,
    held to the JAX package on the CPU by tests/test_torch_smacof_pairs.py)
    run on the card: the same distances, chosen restart, transform count
    and transforms over every restart, bit for bit, in both precisions
    (integer counts, so the fill average has no order)."""
    dt = torch.float64 if prec == "exact" else torch.float32
    dis, asize, bsize, npos, slots = _smacof_dis(cuda, m, dt)
    key = rng.fold_in(rng.prng_key(3), rng.chrom_hash("chrK"))
    B = dis.shape[0]
    kt = torch.zeros(B, dtype=torch.int32, device=cuda)
    mt = torch.zeros(B, dtype=torch.int32, device=cuda)
    k = kcss.css_smacof(dis, npos, asize, bsize, 1, key, slots, 4, transforms=kt)
    monkeypatch.setattr(kcss, "_smacof_loop", kcss.smacof_pairs)
    p = kcss.css_smacof_plain(dis, npos, asize, bsize, 1, key, slots, 4, transforms=mt)
    assert torch.equal(k[1], p[1])
    assert torch.equal(k[3], p[3]) and torch.equal(k[4], p[4]) and torch.equal(kt, mt)


@pytest.mark.gpu
def test_css_smacof_kernel_refuses(cuda):
    dis = torch.zeros((2, 8, 8), dtype=torch.float64, device=cuda)
    one = torch.ones(2, dtype=torch.int64)
    key = rng.prng_key(0)
    with pytest.raises(ValueError, match="restart"):
        kcss.css_smacof(dis[:, :8, :8].contiguous(), one, 4, 4, 1, key, one, n_init=0)
    with pytest.raises(ValueError, match="transforms"):
        kcss.css_smacof(dis[:, :8, :8].contiguous(), one, 4, 4, 1, key, one,
                        transforms=torch.zeros(2, dtype=torch.int64, device=cuda))


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
    assert kcss.LAUNCHES["css_smacof"] == (0 if kw.get("drosophila") else 1)
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


def _window_plain(dist, scores, wkeys, asize, bsize, chunk, runs, bitgen, backend):
    if backend == "native":
        return kperm.mc_native_plain(dist, scores, wkeys, asize, bsize, chunk, runs, 10)
    return kperm.mc_significance(dist, scores, wkeys, asize, bsize, chunk, runs, 10,
                                 stream="window", bitgen=bitgen)


@pytest.mark.gpu
@pytest.mark.parametrize("bitgen,backend", FORMS)
@pytest.mark.parametrize("chunk", [100, 256])
@pytest.mark.parametrize("m", [2, 9, 21, 33, 64])
@pytest.mark.parametrize("nwin", [1, 31, 33, 997])
def test_css_mc_window_kernel(cuda, nwin, m, chunk, bitgen, backend):
    """K8's ranges of hit words and K7's scan against the single-pass
    plain loops: window counts around a warp's 32 and the 997 of the 10 k
    workload, m across the unrolled buckets (8, 16, 24, 32, 64), a chunk
    padded to whole words (100) and one that is not."""
    runs = 2000 if m > 32 else 5000
    dist, scores, asize, bsize, chroms, slots = _mc_windows(cuda, m, nwin)
    assert dist.shape[0] == nwin
    key = rng.fold_in(rng.prng_key(6), 2)
    before = {k: kperm.LAUNCHES[k] for k in ("css_mc_window", "css_mc_scan")}
    got = kperm.significance(dist, scores, asize, bsize, 10, runs, key, chunk=chunk,
                             chroms=chroms, slots=slots, backend=backend, bitgen=bitgen,
                             stream="window")
    torch.cuda.synchronize()
    for k, v in before.items():
        assert kperm.LAUNCHES[k] > v, k
    wkeys = rng.window_keys(key.to(cuda), chroms, slots)
    pv, n, h = _window_plain(dist, scores, wkeys, asize, bsize, chunk, runs, bitgen, backend)
    differ = (got.nscores != n) | (got.hits != h) | (got.pvals != pv)
    assert differ.sum() <= 1e-3 * len(scores), int(differ.sum())
    if m == 2:
        assert (got.pvals == 1.0).all() and (got.nscores == 10).all()
    elif nwin == 997:
        assert (n < runs).any() and (n == runs).any()


@pytest.mark.gpu
@pytest.mark.parametrize("bitgen,backend", FORMS)
def test_css_mc_window_kernel_non_finite(cuda, bitgen, backend):
    """A NaN row, and a NaN only on the diagonal: the float32 forms flag
    the window (no hits, n = runs), as the twin's NaN products give; the
    float64 form scores as mc_native does."""
    dist, scores, asize, bsize, chroms, slots = _mc_windows(cuda, 21, 64)
    dist = dist.clone()
    dist[3, 5, :] = float("nan")
    dist[3, :, 5] = float("nan")
    dist[7, 2, 2] = float("nan")
    dist[11, 12, 12] = float("inf")
    key = rng.fold_in(rng.prng_key(6), 2)
    got = kperm.significance(dist, scores, asize, bsize, 10, 3000, key, chroms=chroms,
                             slots=slots, backend=backend, bitgen=bitgen, stream="window")
    wkeys = rng.window_keys(key.to(cuda), chroms, slots)
    pv, n, h = _window_plain(dist, scores, wkeys, asize, bsize, 256, 3000, bitgen, backend)
    assert np.array_equal(got.nscores, n) and np.array_equal(got.hits, h)
    if backend != "native":
        assert (n[[3, 7, 11]] == 3000).all() and (h[[3, 7, 11]] == 0).all()


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
@pytest.mark.parametrize("bitgen,backend", FORMS)
@pytest.mark.parametrize("m", MC_LARGE_M)
def test_css_mc_window_kernel_large_panels(cuda, m, bitgen, backend):
    """K8's large-panel form (css_mc_window_block) against the single-pass
    plain loops at m = 65 to 300: (p, n, hits) equal on every window but
    counted float32 near ties (at most 0.1 %, + 1)."""
    runs, chunk = 1024, 256
    dist, scores, asize, bsize, chroms, slots = _mc_windows(cuda, m, 33)
    key = rng.fold_in(rng.prng_key(6), 2)
    before = kperm.LAUNCHES["css_mc_window_block"]
    got = kperm.significance(dist, scores, asize, bsize, 10, runs, key, chunk=chunk,
                             chroms=chroms, slots=slots, backend=backend, bitgen=bitgen,
                             stream="window")
    torch.cuda.synchronize()
    assert kperm.LAUNCHES["css_mc_window_block"] > before
    wkeys = rng.window_keys(key.to(cuda), chroms, slots)
    pv, n, h = _window_plain(dist, scores, wkeys, asize, bsize, chunk, runs, bitgen, backend)
    differ = (got.nscores != n) | (got.hits != h) | (got.pvals != pv)
    assert differ.sum() <= 1e-3 * len(scores) + 1, int(differ.sum())


def _switch_windows(cuda, m, nwin=3):
    """(dist [nwin, m, m] float32, float32 observed scores, asize, bsize,
    window keys) at panel size m: the distances of random points in the
    plane, window 1 all NaN in individual 1's row and column (window 3,
    where nwin > 3, +Inf at (0, 2) and (2, 0)), each observed score that
    of the identity labelling (a draw from the window's own null, so some
    permutations hit and some do not)."""
    rs = np.random.default_rng(m)
    pts = rs.normal(size=(nwin, m, 2))
    d = np.sqrt(((pts[:, :, None] - pts[:, None]) ** 2).sum(-1))
    dist = torch.from_numpy(d).to(cuda, torch.float32).contiguous()
    dist[1, 1, :] = dist[1, :, 1] = float("nan")
    if nwin > 3:
        dist[3, 0, 2] = dist[3, 2, 0] = float("inf")
    asize, bsize = (m + 1) // 2, m // 2
    ident = torch.arange(m, device=cuda)[None, :, None]
    coeff = kperm._rank_coeff(ident, asize, bsize)[0, ..., 0].double()
    obs = (dist.double() * coeff).sum(dim=(1, 2)).float()
    chroms = np.full(nwin, rng.chrom_hash("chrK"), dtype=np.int64)
    wkeys = rng.window_keys(rng.fold_in(rng.prng_key(6), 2).to(cuda), chroms,
                            np.arange(nwin, dtype=np.int64) * 3 + 1)
    return dist, obs, asize, bsize, wkeys


def _window_kernel(stem, m, native=False):
    """The kernel a window-stream wrapper launches at panel size m."""
    return stem if kperm.window_form(m, native) == "register" else stem + "_block"


@pytest.mark.gpu
@pytest.mark.parametrize("bitgen,native,m",
                         [(g, False, m) for g in ("mix", "threefry")
                          for m in WINDOW_SWITCH["f32"]]
                         + [("mix", True, m) for m in WINDOW_SWITCH["f64"]])
def test_css_mc_window_kernel_at_its_switches(cuda, m, bitgen, native):
    """K8's hit words of one chunk on both sides of each switch of its
    form (register | shared | split | device: WINDOW_SWITCH), a NaN window
    included: equal to the plain version bit for bit."""
    dist, obs, asize, bsize, wkeys = _switch_windows(cuda, m)
    B = dist.shape[0]
    flat = dist.reshape(B, -1).contiguous()
    active = torch.arange(B, device=cuda)
    name = _window_kernel("css_mc_window", m, native)
    before = kperm.LAUNCHES[name]
    words = kperm.mc_window_hit_words(flat, obs, wkeys, active, 2, 1, asize, bsize, 32,
                                      20_000, bitgen, native)
    want = kperm.mc_window_hit_words_plain(flat, obs, wkeys, active, 2, 1, asize, bsize, 32,
                                           20_000, bitgen, native)
    torch.cuda.synchronize()
    assert kperm.LAUNCHES[name] == before + 1
    assert torch.equal(words, want)
    assert int(words.ne(0).sum()) > 0 and int(words[1].ne(0).sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("m", MC_LARGE_M)
def test_perm_chunk_kernel_large_panels(cuda, m, bitgen):
    """K11's large-panel form against its plain version on every window:
    (hits, reached, pos) equal, a chunk padded to whole words with limit
    < chunk, need from -1 to past the chunk's hits."""
    dist, scores, asize, bsize, chroms, slots = _mc_windows(cuda, m, 33)
    nwin = dist.shape[0]
    keys = rng.window_keys(rng.fold_in(rng.prng_key(5), 2).to(cuda), chroms, slots)
    need = torch.from_numpy(np.random.default_rng(m).integers(-1, 12, size=nwin)).to(cuda)
    obs = torch.from_numpy(scores).to(cuda)
    for chunk, limit in ((128, 128), (100, 60)):
        before = kperm.LAUNCHES["css_perm_chunk_block"]
        k = kperm.permutation_chunk(dist, obs, need, limit, keys, asize, bsize, chunk, bitgen)
        p = kperm.permutation_chunk_plain(dist, obs, need, limit, keys, asize, bsize, chunk,
                                          bitgen)
        torch.cuda.synchronize()
        assert kperm.LAUNCHES["css_perm_chunk_block"] == before + 1
        for a, b in zip(k, p):
            assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("m", WINDOW_SWITCH["f32"])
def test_perm_chunk_kernel_at_its_switches(cuda, m):
    """K11 on both sides of each switch of its form, a NaN window
    included: (hits, reached, pos) equal to the plain version, need from
    -1 to past the chunk, limit < chunk."""
    dist, obs, asize, bsize, wkeys = _switch_windows(cuda, m)
    need = torch.tensor([1, 0, 3], dtype=torch.int32, device=cuda)
    name = _window_kernel("css_perm_chunk", m)
    before = kperm.LAUNCHES[name]
    k = kperm.permutation_chunk(dist, obs, need, 24, wkeys, asize, bsize, 32)
    p = kperm.permutation_chunk_plain(dist, obs, need, 24, wkeys, asize, bsize, 32)
    torch.cuda.synchronize()
    assert kperm.LAUNCHES[name] == before + 1
    for a, b in zip(k, p):
        assert torch.equal(a.cpu(), b.cpu())
    assert int(k[0][1]) == 0 and int(k[0].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("stream", ["shared", "window"])
@pytest.mark.parametrize("m", [65, 128, 200])
def test_css_mc_power_kernel_large_panels(cuda, m, stream, bitgen):
    """K9 past m = 64: the shared stream's tile product at any m, the
    window stream's large-panel form.  The window stream scores every
    product in the plain version's order (the same float32 scores), so its
    sums differ only in the float64 adds' order; the shared stream's
    float32 scores in the product's order, within large_power_band(m) by
    power_err.  Approx p within the measured log10 band where nscores
    agree."""
    dist, scores, asize, bsize, chroms, slots = _mc_windows(cuda, m, 48)
    key = rng.fold_in(rng.prng_key(7), 2)
    keys = key.to(cuda) if stream == "shared" else rng.window_keys(key.to(cuda), chroms, slots)
    name = "css_mc_power" if stream == "shared" else "css_mc_power_window_block"
    before = kperm.LAUNCHES[name]
    k = kperm.null_power_sums(dist, keys, asize, bsize, 512, 3, 2, stream, bitgen)
    p = kperm.null_power_sums_plain(dist, keys, asize, bsize, 512, 3, 2, stream, bitgen)
    torch.cuda.synchronize()
    assert kperm.LAUNCHES[name] == before + 1
    if stream == "window":
        rel = float(((k - p).abs() / p.abs().clamp(min=1e-300)).max())
        assert rel <= 1e-12, rel
    else:
        err = power_err(k, p, 512)
        assert err <= large_power_band(m), err
    got = kperm.approx_significance(dist, scores, asize, bsize, key, chunk=512,
                                    chroms=chroms, slots=slots, bitgen=bitgen, stream=stream)
    want = kperm.approx_significance_plain(dist, scores, asize, bsize, key, chunk=512,
                                           chroms=chroms, slots=slots, bitgen=bitgen,
                                           stream=stream)
    same = got.nscores == want.nscores
    assert same.mean() >= 0.99
    dl = np.abs(np.log10(got.pvals[same]) - np.log10(want.pvals[same]))
    assert dl.max() <= band(LARGE_LOG10_P_BAND, m), dl.max()


@pytest.mark.gpu
@pytest.mark.parametrize("m", WINDOW_SWITCH["f32"])
def test_css_mc_power_window_kernel_at_its_switches(cuda, m):
    """K9's window stream on both sides of each switch of its form: the
    float64 sums of the plain version's float32 scores, within 1e-12 (the
    lanes' order of the adds); NaN where a window's scores are."""
    dist, _, asize, bsize, wkeys = _switch_windows(cuda, m)
    name = ("css_mc_power" if kperm.window_form(m) == "register"
            else "css_mc_power_window_block")
    before = kperm.LAUNCHES[name]
    k = kperm.null_power_sums(dist, wkeys, asize, bsize, 32, 1, 1, "window")
    p = kperm.null_power_sums_plain(dist, wkeys, asize, bsize, 32, 1, 1, "window")
    torch.cuda.synchronize()
    assert kperm.LAUNCHES[name] == before + 1
    assert torch.isnan(k[:, :, 1]).all() and torch.isnan(p[:, :, 1]).all()
    fin = [0, 2]
    rel = float(((k[..., fin] - p[..., fin]).abs()
                 / p[..., fin].abs().clamp(min=1e-300)).max())
    assert rel <= 1e-12, rel


# K9's window stream to m = 64: both sides of each instantiation of its
# kernel (m <= 8, 16, 24, 32, 64)
POWER_BUCKETS = [2, 8, 9, 16, 17, 24, 25, 32, 33, 64]


def _power_order(dist, wkeys, asize, bsize, chunk, k0, nk, bitgen):
    """kernels/perm.py:window_power_order of the plain float32 scores of
    chunks k0 .. k0 + nk - 1."""
    s = torch.stack([kperm._perm_scores(dist, rng.fold_in(wkeys, c), asize, bsize, chunk,
                                        bitgen) for c in range(k0, k0 + nk)], dim=1)
    return kperm.window_power_order(s)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [32, 100, 512])
@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("m", POWER_BUCKETS)
def test_css_mc_power_window_kernel_equals_its_order(cuda, m, bitgen, chunk):
    """K9's window stream to m = 64 (css_mc_power_window on K8's
    small-panel body) on a few windows, as approx mode's escalation rounds
    call it, at k0 > 0: bit-equal to its sum order mirrored in torch
    (window_power_order) on the plain scores, the same bits in two calls,
    NaN where a window holds a NaN or an Inf; each call counted under the
    window stream."""
    nwin = 4 if m > 2 else 3
    dist, _, asize, bsize, wkeys = _switch_windows(cuda, m, nwin=nwin)
    before = (kperm.LAUNCHES["css_mc_power"], kperm.POWER_LAUNCHES["window"])
    args = (dist, wkeys, asize, bsize, chunk, 5, 3, "window", bitgen)
    k = kperm.null_power_sums(*args)
    k2 = kperm.null_power_sums(*args)
    want = _power_order(dist, wkeys, asize, bsize, chunk, 5, 3, bitgen)
    torch.cuda.synchronize()
    assert (kperm.LAUNCHES["css_mc_power"], kperm.POWER_LAUNCHES["window"]) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(k.view(torch.int64), k2.view(torch.int64))
    bad = [1, 3][:nwin - 2]
    fin = [0, 2]
    assert torch.isnan(k[:, :, bad]).all() and torch.isnan(want[:, :, bad]).all()
    assert torch.equal(k[..., fin].view(torch.int64), want[..., fin].view(torch.int64))


@pytest.mark.gpu
@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("m", [9, 21, 64])
def test_css_mc_power_window_kernel_equals_its_order_many_windows(cuda, m, bitgen):
    """The same on up to 997 windows of a chromosome at chunk 512 (approx
    mode's first call), against the mirror bit for bit and the plain
    version within 1e-12 of each sum's magnitude."""
    dist, _, asize, bsize, chroms, slots = _mc_windows(cuda, m, 997)
    wkeys = rng.window_keys(rng.fold_in(rng.prng_key(7), 2).to(cuda), chroms, slots)
    k = kperm.null_power_sums(dist, wkeys, asize, bsize, 512, 2, 2, "window", bitgen)
    want = _power_order(dist, wkeys, asize, bsize, 512, 2, 2, bitgen)
    p = kperm.null_power_sums_plain(dist, wkeys, asize, bsize, 512, 2, 2, "window", bitgen)
    torch.cuda.synchronize()
    assert torch.equal(k.view(torch.int64), want.view(torch.int64))
    rms = (p[:, 1:2] / 512).sqrt()
    q = torch.arange(1, 4, device=cuda, dtype=p.dtype)[None, :, None]
    assert float(((k - p).abs() / (512 * rms ** q)).max()) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("m", MC_LARGE_M)
def test_css_mc_power_window_kernel_large_panels(cuda, m, bitgen):
    """K9's window stream on the large-panel body at m = 65 to 300 (both
    forms, the register sort and the key slab): the float64 sums of the
    plain version's float32 scores within 1e-12, the sums of a window with
    a NaN or an Inf distance NaN, as the plain version's."""
    dist, _, asize, bsize, wkeys = _switch_windows(cuda, m, nwin=4)
    before = kperm.LAUNCHES["css_mc_power_window_block"]
    k = kperm.null_power_sums(dist, wkeys, asize, bsize, 100, 2, 2, "window", bitgen)
    p = kperm.null_power_sums_plain(dist, wkeys, asize, bsize, 100, 2, 2, "window", bitgen)
    torch.cuda.synchronize()
    assert kperm.LAUNCHES["css_mc_power_window_block"] == before + 1
    assert torch.isnan(k[:, :, [1, 3]]).all() and torch.isnan(p[:, :, [1, 3]]).all()
    fin = [0, 2]
    rel = float(((k[..., fin] - p[..., fin]).abs()
                 / p[..., fin].abs().clamp(min=1e-300)).max())
    assert rel <= 1e-12, rel


@pytest.mark.gpu
def test_sharded_step_large_panel(cuda):
    """make_divergence_step(70, 58) on the card (K10, K3's gather tiles,
    K5's block form, K11's large-panel form) against the same step with
    plain=True: FET exact 1e-12, CSS 1e-9 on the eigengap windows, MC hits
    equal but on near ties (at most one window)."""
    from divergence_tpu_torch.parallel import make_divergence_step, make_mesh

    pos, am, bm = make_panel(20_000, 1_000_000, 70, 58, seed=12)
    plan = plan_windows(pos, 1_000_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0][:400]
    av, bv, npos, slot = _gathered(plan, ids, am, bm)
    key = rng.prng_key(1)
    kperm.reset_launches()
    got = make_divergence_step(make_mesh(devices=[cuda]), 70, 58)(
        av.to(cuda), bv.to(cuda), npos, slot, key)
    assert kperm.LAUNCHES["css_perm_chunk_block"] == 1
    want = make_divergence_step(make_mesh(devices=[cuda]), 70, 58, plain=True)(
        av.to(cuda), bv.to(cuda), npos, slot, key)
    assert _rel(got["fet_scores"], want["fet_scores"]) <= TOL["exact"]
    assert torch.equal(got["css_valid"], want["css_valid"])
    err = ((got["css_scores"] - want["css_scores"]).abs()
           / want["css_scores"].abs().clamp(min=1.0))
    assert int((err > 1e-9).sum()) <= 0.01 * len(ids)
    assert int((got["mc_hits"] != want["mc_hits"]).sum()) <= 1


def _wide_logs(cuda, P, B, seed):
    """Per-SNP scores (K1's, 11 + 10) of a chromosome and B windows on it
    whose widest pads to P (n in (P / 2, P], the first exactly P - 5)."""
    rs = np.random.default_rng(seed)
    N = 3 * P
    vals = _codes(N, 21, seed).to(cuda)
    npos = rs.integers(P // 2 + 1, P + 1, size=B)
    npos[0] = P - 5
    lo = rs.integers(0, N - npos + 1)
    return (vals, torch.from_numpy(lo), torch.from_numpy(npos),
            torch.from_numpy(np.arange(B, dtype=np.int64) * 5 + 2))


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("P", [4096, 8192, 16384, 32768, 65536])
def test_fet_wide_windows(cuda, prec, P):
    """K2, K2r and K10 on windows of ~P SNPs (the wide body, past the
    block body's P = 256): K2 against its plain
    version at the FET tolerances (stddev beyond them on at most one
    window), K2r = K2 and K10 = K1 -> K2 bit for bit."""
    fast = prec == "fast"
    maxs, nmax = kfet.support_size(11, 10), 23
    vals, lo, npos, slot = _wide_logs(cuda, P, 6, seed=P)
    key = rng.fold_in(rng.prng_key(3), rng.chrom_hash("chrW"))
    logs = kfet.fet_snp_logs(vals, 11, maxs, nmax, fast)
    ls, r = kfet.fet_snp_ranks(vals, 11, maxs, nmax, fast)
    kfet.reset_launches()
    k2 = kfet.fet_aggregate(logs, lo, npos, slot, key, 0.95, 100)
    k2r = kfet.fet_aggregate_ranks(ls, r, lo, npos, slot, key, 0.95, 100)
    wide = {k: v for k, v in kfet.LAUNCHES.items() if v}
    vb = 4 if fast else 8
    assert wide == {
        ("fet_aggregate_wide" if kfet.window_form(P, 100, vb, vb) == "wide"
         else "fet_aggregate"): 1,
        ("fet_aggregate_ranks_wide" if kfet.window_form(P, 100, 4, vb) == "wide"
         else "fet_aggregate_ranks"): 1}
    p = kfet.fet_aggregate_plain(logs, lo, npos, slot, key, 0.95, 100)
    torch.cuda.synchronize()
    assert _rel(k2[0], p[0]) <= TOL[prec]
    sd = (k2[1].double() - p[1].double()).abs() / p[1].double().abs().clamp(min=1.0)
    assert int((sd > TOL[prec]).sum()) <= 1
    assert torch.equal(k2, k2r)
    # K10 on the same windows gathered at P: K1 -> K2 bit for bit
    offs = torch.arange(P)[None, :]
    idx = torch.where(offs < npos[:, None], lo[:, None] + offs, 0).to(cuda)
    g = vals[idx]
    s, d = kfet.fet_window_batch(g[..., :11].contiguous(), g[..., 11:].contiguous(), npos,
                                 0.95, key, 100, maxs, nmax, fast, slot)
    kk = kfet.fet_aggregate(logs, lo, npos, slot, key, 0.95, 100)
    assert torch.equal(_float_bits(s), _float_bits(kk[0]))
    assert torch.equal(_float_bits(d), _float_bits(kk[1]))

def coeff_cases(m: int) -> list:
    """(nk, chunk) cases of K7's large-panel coefficients at m: 1 and 16
    chunks of 100 (ragged: 28 padding columns a chunk) and 256; at m >= 900
    16 chunks of 100 only (M [m^2, 2,048]: 6.8 GB at m = 909)."""
    if m >= 900:
        return [(1, 100), (1, 256), (16, 100)]
    return [(1, 100), (1, 256), (16, 100), (16, 256)]


def _direct_bodies(cuda, logs, lo, npos, slot, key, perc, nsamples):
    """K2 on the same windows by its block body and by its wide body,
    both launched directly at the launch's own P (whichever the form
    query would pick), as (block out, wide out)."""
    dev = logs.device
    rows, pmax = kfet._window_rows(lo, npos, slot, logs.shape[0], dev)
    kb = logs.element_size()
    big = 1 << 20
    slabs = kfet._window_form(big, nsamples, kb, kb, dev)[1] // (big * kb)
    scratch = torch.empty(slabs * pmax, dtype=logs.dtype, device=dev)
    args = (ptr(logs), ptr(rows), lo.numel(),
            *(ctypes.c_uint32(int(w)) for w in key.tolist()), ctypes.c_double(perc), nsamples,
            pmax)
    sfx = "f32" if logs.dtype == torch.float32 else "f64"
    counts = dict(kfet.LAUNCHES)
    outs = [torch.empty((2, lo.numel()), dtype=logs.dtype, device=dev) for _ in range(2)]
    launch(counts, "fet_aggregate", f"fet_aggregate_{sfx}", dev, *args, ptr(outs[0]))
    launch(counts, "fet_aggregate_wide", f"fet_aggregate_wide_{sfx}", dev, *args,
           kfet.WIDE_BAND_KEYS, ptr(scratch), ptr(outs[1]))
    return outs


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_fet_wide_body_bytes_equal_block_body_at_crossover(cuda, prec):
    """At the crossover (the widest P the block body takes and the next)
    K2's block and wide bodies give the same bytes on the same windows."""
    fast = prec == "fast"
    vb = 4 if fast else 8
    P0 = max(P for P in (256, 512, 1024, 2048, 4096, 8192, 16384)
             if kfet.window_form(P, 100, vb, vb) == "block")
    maxs, nmax = kfet.support_size(11, 10), 23
    key = rng.fold_in(rng.prng_key(3), rng.chrom_hash("chrW"))
    for P in (P0, 2 * P0):
        vals, lo, npos, slot = _wide_logs(cuda, P, 8, seed=P)
        logs = kfet.fet_snp_logs(vals, 11, maxs, nmax, fast)
        block, wide = _direct_bodies(cuda, logs, lo, npos, slot, key, 0.95, 100)
        torch.cuda.synchronize()
        assert torch.equal(block.view(torch.uint8), wide.view(torch.uint8)), P


def _edge_logs(cuda, kind, P, dtype, seed):
    """Per-SNP scores for the wide body's edge cases: "ties" (97 % zeros of
    the precision's sign, the rest exponential, one +inf), else K1-like
    exponential scores with a third zeros."""
    rs = np.random.default_rng(seed)
    N = 3 * P
    zero = -0.0 if dtype == torch.float64 else 0.0
    share = 0.97 if kind == "ties" else 0.33
    x = np.where(rs.random(N) < share, zero, rs.exponential(size=N))
    x[N // 2] = np.inf
    return torch.from_numpy(x).to(dtype).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("case", ["ties", "forced_band", "nsamples37", "perc0.5",
                                  "perc0.999", "small_n"])
def test_fet_wide_body_edges(cuda, prec, case):
    """K2 and K2r's wide body on its edge cases against the plain versions
    (scores within TOL, stddev beyond it on at most one window, as
    test_fet_wide_windows): a tie-heavy window, every band sorted in device scratch
    (band_keys=0) and equal bit for bit to the shared-memory band, 37
    samples, perc 0.5 and 0.999, windows of 1 .. 40 SNPs among wide ones;
    K2r = K2 where the ranks index the scores' sorted LUT."""
    dtype = torch.float32 if prec == "fast" else torch.float64
    P = 16384 if prec == "fast" else 8192
    perc, nsamples = 0.95, 100
    if case == "nsamples37":
        nsamples = 37
    if case.startswith("perc"):
        perc = float(case[4:])
    logs = _edge_logs(cuda, "ties" if case == "ties" else "plain", P, dtype, seed=len(case))
    rs = np.random.default_rng(11)
    B = 7
    npos = rs.integers(P // 2 + 1, P + 1, size=B)
    npos[0] = P
    if case == "small_n":
        npos[1:4] = (1, 2, 40)
    lo = rs.integers(0, logs.shape[0] - npos + 1)
    lo, npos = torch.from_numpy(lo), torch.from_numpy(npos)
    slot = torch.arange(B, dtype=torch.int64) * 3 + 1
    key = rng.fold_in(rng.prng_key(9), rng.chrom_hash("chrE"))
    assert kfet.window_form(P, nsamples, dtype.itemsize, dtype.itemsize) == "wide"
    kfet.reset_launches()
    k2 = kfet.fet_aggregate(logs, lo, npos, slot, key, perc, nsamples)
    assert kfet.LAUNCHES["fet_aggregate_wide"] == 1
    p = kfet.fet_aggregate_plain(logs, lo, npos, slot, key, perc, nsamples)
    torch.cuda.synchronize()
    fin = torch.isfinite(p).all(dim=0)   # a window holding the +inf score: byte for byte
    assert torch.equal(k2[:, ~fin].contiguous().view(torch.uint8),
                       p[:, ~fin].contiguous().view(torch.uint8))
    assert _rel(k2[0][fin], p[0][fin]) <= TOL[prec]
    sd = (k2[1][fin].double() - p[1][fin].double()).abs() / \
        p[1][fin].double().abs().clamp(min=1.0)
    assert int((sd > TOL[prec]).sum()) <= 1
    if case == "forced_band":
        forced = kfet.fet_aggregate(logs, lo, npos, slot, key, perc, nsamples, band_keys=0)
        assert torch.equal(forced.view(torch.uint8), k2.view(torch.uint8))
    # K2r on the ranks of the scores into their sorted distinct values
    lut, ranks = torch.unique(logs, sorted=True, return_inverse=True)
    k2r = kfet.fet_aggregate_ranks(lut.contiguous(), ranks.to(torch.int32).contiguous(), lo,
                                   npos, slot, key, perc, nsamples,
                                   band_keys=0 if case == "forced_band" else None)
    assert torch.equal(k2r.view(torch.uint8), k2.view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("m", LARGE_M + COEFF_SWITCH)
@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
def test_css_mc_coeff_kernel_large_panels(cuda, m, bitgen):
    """K7's coefficients at large m (css_mc_coeff_block: each column ranked
    once into a table of facts, then M written 16 bytes a lane) bit-equal
    to the plain version (coeff_range_plain, shared_coeff_plain padded)
    for coeff_cases(m)."""
    key = rng.fold_in(rng.prng_key(5), 2)
    asize, bsize = (m + 1) // 2, m // 2
    for nk, chunk in coeff_cases(m):
        k = kperm.coeff_range(key, 2, nk, m, asize, bsize, chunk, cuda, bitgen)
        p = kperm.coeff_range_plain(key, 2, nk, m, asize, bsize, chunk, cuda, bitgen)
        torch.cuda.synchronize()
        assert torch.equal(k.view(torch.int32), p.view(torch.int32)), (m, nk, chunk)
        del k, p
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("mds,bitgen", [("cmds", "mix"), ("cmds", "threefry"),
                                        ("smacof", "mix"), ("cmds+smacof", "mix")])
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_css_large_panel_cuda_matches_cpu(cuda, mds, bitgen, prec):
    """run_css at 70 + 58 on the card against the CPU, each MDS mode (and
    the shared stream's threefry draws): the large-panel kernels launch;
    scores at the CSS tolerances (CMDS exact on windows whose eigengap
    exceeds 1e-6; SMACOF fast within LARGE_SMACOF_BAND at m = 128), p
    equal but for float32 near ties."""
    from divergence_tpu_torch.config import MdsAlgorithm

    mode = {"cmds": MdsAlgorithm.CMDS, "smacof": MdsAlgorithm.SMACOF,
            "cmds+smacof": MdsAlgorithm.CMDS_SMACOF}[mds]
    pos, am, bm = make_panel(3_000, 150_000, 70, 58, seed=12)
    pair = SnpPair(pos, am, bm)
    cfg = CssConfig(precision=prec, mc_runs=5000, mds=mode, rng=bitgen)
    kcss.reset_launches()
    kperm.reset_launches()
    g = run_css(pair, 150_000, cfg, device=cuda, seqid="c")
    score_kernel = "css_cmds_block" if mds == "cmds" else "css_smacof_block"
    assert kcss.LAUNCHES["css_dissim_tiles"] >= 1 and kcss.LAUNCHES[score_kernel] >= 1
    assert kperm.LAUNCHES["css_mc_coeff_block"] >= 1 and kperm.LAUNCHES["css_mc_scan"] >= 1
    assert kperm.COEFF_LAUNCHES[bitgen] >= 1
    c = run_css(pair, 150_000, cfg, device="cpu", seqid="c")
    assert np.array_equal(g[0] != 0, c[0] != 0)
    plan = plan_windows(pos, 150_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    dis = kcss.dissimilarity_plain(torch.from_numpy(np.concatenate([am, bm], axis=1)),
                                   torch.from_numpy(plan.lo[ids]), torch.from_numpy(plan.npos[ids]))
    filled, _ = kcss.fill_averages(dis)
    ev = torch.linalg.eigvalsh(kcss.double_centre(filled)).flip(-1)
    ok = np.zeros_like(c[0], dtype=bool)
    ok[plan.slot[ids]] = ((ev[:, 1] - ev[:, 2]) / ev[:, 0].abs().clamp(min=1.0) > 1e-6).numpy()
    ok &= c[0] != 0
    if prec == "exact" and mds == "cmds":
        rel = np.abs(g[0] - c[0])[ok] / np.maximum(np.abs(c[0][ok]), 1.0)
        assert rel.max(initial=0.0) <= 1e-9
    elif prec == "exact":   # SMACOF: a stop decision may flip between orders
        rel = np.abs(g[0] - c[0]) / np.maximum(np.abs(c[0]), 1.0)
        assert int((rel > 1e-9).sum()) <= 1e-3 * (c[0] != 0).sum() + 1
    elif mds == "cmds":
        np.testing.assert_allclose(g[0][ok], c[0][ok], rtol=2e-3, atol=1e-4)
    else:
        top, q90 = LARGE_SMACOF_BAND[(1 if mds == "smacof" else 2, 128)]
        rel = np.abs(g[0] - c[0])[c[0] != 0] / np.maximum(np.abs(c[0][c[0] != 0]), 1.0)
        assert rel.max(initial=0.0) <= top and np.quantile(rel, 0.9) <= q90
    assert (g[1] != c[1]).sum() <= 0.01 * (c[0] != 0).sum()


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
        # one css_mc_window and one css_mc_scan launch per range
        assert kperm.LAUNCHES["css_mc_window"] >= 1, kperm.LAUNCHES
        assert kperm.LAUNCHES["css_mc_scan"] == kperm.LAUNCHES["css_mc_window"]
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
    # a window past the old 4,096-SNP limit runs
    big = torch.zeros((1, 5000, 3), dtype=torch.int16, device=cuda)
    k = kfet.fet_window_batch(big, big, torch.tensor([4500]), 0.95, key, 10, 5, 8)
    p = kfet.fet_window_batch_plain(big, big, torch.tensor([4500]), 0.95, key, 10, 5, 8)
    assert _rel(k[0], p[0]) <= TOL["exact"] and _rel(k[1], p[1]) <= TOL["exact"]


def _synthetic_gathered(B, P, npos_max, asize, bsize, seed):
    """[B, P, a] / [B, P, b] codes with npos in [1, npos_max] (the first
    window holds npos_max) and their slots."""
    rs = np.random.default_rng(seed)
    codes = np.array([3, -3, 0, -10000], np.int16)
    av = torch.from_numpy(rs.choice(codes, size=(B, P, asize), p=[0.4, 0.3, 0.25, 0.05]))
    bv = torch.from_numpy(rs.choice(codes, size=(B, P, bsize), p=[0.4, 0.3, 0.25, 0.05]))
    npos = torch.from_numpy(rs.integers(1, npos_max + 1, size=B))
    npos[0] = npos_max
    return av, bv, npos, torch.arange(B, dtype=torch.int64) * 3 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("P", [256, 4096])
def test_fet_window_kernel_block_path(cuda, prec, P):
    """K10 against its plain version at P = 256 (the block body) and 4,096
    (the wide body)."""
    av, bv, npos, slot = _synthetic_gathered(24, P, P - 3, 11, 10, seed=P)
    maxs, nmax = kfet.support_size(11, 10), 23
    key = rng.fold_in(rng.prng_key(7), 0)
    fast = prec == "fast"
    k = kfet.fet_window_batch(av.to(cuda), bv.to(cuda), npos, 0.95, key, 100, maxs, nmax,
                              fast, slot)
    p = kfet.fet_window_batch_plain(av, bv, npos, 0.95, key, 100, maxs, nmax, fast, slot)
    assert _rel(k[0], p[0]) <= TOL[prec]
    sd = (k[1].double().cpu() - p[1].double()).abs() / p[1].double().abs().clamp(min=1.0)
    assert int((sd > TOL[prec]).sum()) <= 1


def _float_bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_window_body_is_path_independent(cuda, prec):
    """The warp body (a launch whose windows all have P <= 128) and the
    block body (the same windows beside one of 200 SNPs) give every window
    the same bits, in K10, K2 and K2r; and K10 equals K2 and K2r on the
    same tables either way."""
    fast = prec == "fast"
    maxs, nmax = kfet.support_size(11, 10), 23
    av, bv, npos, slot = _synthetic_gathered(301, 256, 128, 11, 10, seed=11)
    npos[1:40] = torch.arange(1, 40)
    small = slice(1, None)                  # every window but the first has n <= 128
    npos_s = npos.clone()
    npos[0] = 200
    key = rng.fold_in(rng.prng_key(8), 3)
    a_d, b_d = av.to(cuda), bv.to(cuda)
    warp = kfet.fet_window_batch(a_d[small, :128].contiguous(), b_d[small, :128].contiguous(),
                                 npos_s[small], 0.95, key, 100, maxs, nmax, fast, slot[small])
    block = kfet.fet_window_batch(a_d, b_d, npos, 0.95, key, 100, maxs, nmax, fast, slot)
    for w, b in zip(warp, block):
        assert torch.equal(_float_bits(w), _float_bits(b[small]))
    # the windows' rows laid end to end as a chromosome: K1 -> K2 and K1r -> K2r
    B, P = av.shape[:2]
    rows = torch.arange(P)[None, :] < npos[:, None]
    vals = torch.cat([av, bv], dim=-1)[rows].to(cuda)
    lo = torch.cumsum(npos, 0) - npos
    logs = kfet.fet_snp_logs(vals, 11, maxs, nmax, fast)
    ls, r = kfet.fet_snp_ranks(vals, 11, maxs, nmax, fast)
    for sl in (small, slice(None)):
        k2 = kfet.fet_aggregate(logs, lo[sl], npos[sl], slot[sl], key, 0.95, 100)
        k2r = kfet.fet_aggregate_ranks(ls, r, lo[sl], npos[sl], slot[sl], key, 0.95, 100)
        assert torch.equal(k2, k2r)
        assert torch.equal(k2[0], block[0][sl]) and torch.equal(k2[1], block[1][sl])
    k2_block = kfet.fet_aggregate(logs, lo, npos, slot, key, 0.95, 100)
    k2_warp = kfet.fet_aggregate(logs, lo[small], npos[small], slot[small], key, 0.95, 100)
    assert torch.equal(_float_bits(k2_warp), _float_bits(k2_block[:, small]))


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_unaligned_rows_stage_alike(cuda, prec):
    """Batches whose window blocks are not 16-byte aligned (P_in = 100 at
    11 + 10) take 2-byte copies in K10's warp body and K3's gather form:
    the same bits as the aligned batch of the same windows."""
    fast = prec == "fast"
    maxs, nmax = kfet.support_size(11, 10), 23
    av, bv, npos, slot = _synthetic_gathered(300, 128, 100, 11, 10, seed=21)
    key = rng.fold_in(rng.prng_key(9), 1)
    a_d, b_d = av.to(cuda), bv.to(cuda)
    a_u, b_u = a_d[:, :100].contiguous(), b_d[:, :100].contiguous()
    assert (100 * 11 * 2) % 16   # the a blocks are not 16-byte aligned
    aligned = kfet.fet_window_batch(a_d, b_d, npos, 0.95, key, 100, maxs, nmax, fast, slot)
    unaligned = kfet.fet_window_batch(a_u, b_u, npos, 0.95, key, 100, maxs, nmax, fast, slot)
    for x, y in zip(aligned, unaligned):
        assert torch.equal(_float_bits(x), _float_bits(y))
    dt = torch.float32 if fast else torch.float64
    assert torch.equal(kcss.css_dissim_gathered(a_d, b_d, npos, dt),
                       kcss.css_dissim_gathered(a_u, b_u, npos, dt))


@pytest.mark.gpu
def test_fet_window_kernel_wide_panel(cuda):
    """A panel too wide for a warp to stage its codes (500 + 500 at
    P = 128: 256 KB) takes the block body: FET tolerances against the
    plain version (stddev beyond them on at most one window)."""
    av, bv, npos, slot = _synthetic_gathered(8, 128, 100, 500, 500, seed=22)
    maxs, nmax = kfet.support_size(500, 500), 1002
    key = rng.fold_in(rng.prng_key(9), 2)
    for prec in ("exact", "fast"):
        fast = prec == "fast"
        k = kfet.fet_window_batch(av.to(cuda), bv.to(cuda), npos, 0.95, key, 100, maxs, nmax,
                                  fast, slot)
        p = kfet.fet_window_batch_plain(av, bv, npos, 0.95, key, 100, maxs, nmax, fast, slot)
        assert _rel(k[0], p[0]) <= TOL[prec]
        sd = (k[1].double().cpu() - p[1].double()).abs() / p[1].double().abs().clamp(min=1.0)
        assert int((sd > TOL[prec]).sum()) <= 1


PERM_CHUNKS = [(128, 128), (256, 200), (100, 100), (16, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("m", [2, 9, 21, 33, 64])
@pytest.mark.parametrize("nwin", [1, 31, 33, 997])
def test_perm_chunk_kernel(cuda, nwin, m, bitgen):
    """K11 against its plain version on every window: window counts around
    a block's windows (4 at chunk 128, 16 at 16, 1 at 256), m across the
    unrolled buckets, a chunk padded to whole words (100), limit < chunk,
    need from -1 (reached at 0) to past the chunk's hits."""
    dist, scores, asize, bsize, chroms, slots = _mc_windows(cuda, m, nwin)
    assert dist.shape[0] == nwin
    keys = rng.window_keys(rng.fold_in(rng.prng_key(5), 2).to(cuda), chroms, slots)
    need = torch.from_numpy(np.random.default_rng(m).integers(-1, 12, size=nwin)).to(cuda)
    obs = torch.from_numpy(scores).to(cuda)
    for chunk, limit in PERM_CHUNKS:
        before = kperm.LAUNCHES["css_perm_chunk"]
        k = kperm.permutation_chunk(dist, obs, need, limit, keys, asize, bsize, chunk, bitgen)
        p = kperm.permutation_chunk_plain(dist, obs, need, limit, keys, asize, bsize, chunk,
                                          bitgen)
        torch.cuda.synchronize()
        assert kperm.LAUNCHES["css_perm_chunk"] == before + 1
        for a, b in zip(k, p):
            assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
def test_perm_chunk_kernel_non_finite(cuda, bitgen):
    """A NaN row, a NaN only on the diagonal, a symmetric +Inf and a -Inf
    on the diagonal: K11 flags those windows (no hits), as the plain
    version's NaN sums give; every window equal to the plain version."""
    dist, scores, asize, bsize, chroms, slots = _mc_windows(cuda, 21, 64)
    dist = dist.clone()
    dist[3, 5, :] = float("nan")
    dist[3, :, 5] = float("nan")
    dist[7, 2, 2] = float("nan")
    dist[11, 4, 9] = dist[11, 9, 4] = float("inf")
    dist[13, 0, 0] = -float("inf")
    keys = rng.window_keys(rng.fold_in(rng.prng_key(5), 2).to(cuda), chroms, slots)
    obs = torch.from_numpy(scores).to(cuda)
    need = torch.ones(64, dtype=torch.int32, device=cuda)
    # scores far below the null: every counted permutation of a finite window hits
    low = obs - 1e3
    for o in (obs, low):
        k = kperm.permutation_chunk(dist, o, need, 128, keys, asize, bsize, 128, bitgen)
        p = kperm.permutation_chunk_plain(dist, o, need, 128, keys, asize, bsize, 128, bitgen)
        for a, b in zip(k, p):
            assert torch.equal(a.cpu(), b.cpu())
        assert (k[0][[3, 7, 11, 13]] == 0).all()
    assert (k[0][[0, 1, 2]] == 128).all()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [21, 64])
def test_perm_chunk_kernel_equals_k8_first_chunk(cuda, m):
    """K11 on the window keys fold_in(wkey, 0) scores the permutations of
    K8's first chunk: its words, folded, give K8's hits and stops."""
    dist, scores, asize, bsize, chroms, slots = _mc_windows(cuda, m, 997)
    wkeys = rng.window_keys(rng.fold_in(rng.prng_key(5), 2).to(cuda), chroms, slots)
    obs = torch.from_numpy(scores).to(cuda).float()
    B = dist.shape[0]
    active = torch.arange(B, device=cuda)
    flat = dist.reshape(B, -1).contiguous()
    words = kperm.mc_window_hit_words(flat, obs, wkeys, active, 0, 1, asize, bsize, 256, 256)
    need = torch.full((B,), 10, dtype=torch.int32, device=cuda)
    k = kperm.permutation_chunk(dist, obs, need, 256, rng.fold_in(wkeys, 0), asize, bsize,
                                256)
    want = kperm.chunk_epilogue_plain(words[:, 0].cpu(), need.cpu())
    for a, b in zip(k, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_sharded_step_one_vs_four_shares(cuda):
    from divergence_tpu_torch.parallel import make_divergence_step, make_mesh

    pos, am, bm = make_panel(20_000, 1_000_000, 11, 10, seed=4)
    plan = plan_windows(pos, 1_000_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0][:1996]
    av, bv, npos, slot = _gathered(plan, ids, am, bm)
    key = rng.prng_key(1)
    outs = []
    for n in (1, 4):
        kperm.reset_launches()
        outs.append(make_divergence_step(make_mesh(devices=[cuda] * n), 11, 10)(
            av.to(cuda), bv.to(cuda), npos, slot, key))
        assert kperm.LAUNCHES["css_perm_chunk"] == n   # one chunk a share
    for name in ("fet_scores", "fet_stddev", "css_scores", "css_valid", "mc_hits"):
        assert torch.equal(outs[0][name], outs[1][name]), name
    assert float(outs[0]["windows_evaluated"]) == len(ids)
    s1, s4 = float(outs[0]["score_sum"]), float(outs[1]["score_sum"])
    assert abs(s1 - s4) <= 1e-9 * abs(s1)


@pytest.mark.gpu
@pytest.mark.parametrize("stream", ["shared", "window"])
@pytest.mark.parametrize("m", [21, 128])
def test_mc_four_shares_of_one_card(cuda, m, stream):
    """significance over [cuda:0] * 4 runs its shares at once, a host
    thread and a stream each (K7 / K7 coeff large, K8 / K8 large): (p, n,
    hits) byte-equal to one share, and the launches those of the four
    shares run one at a time, each counted."""
    from divergence_tpu_torch.parallel import make_mesh, window_slices

    dist, scores, asize, bsize, chroms, slots = _mc_windows(cuda, m, 400)
    key = rng.fold_in(rng.prng_key(5), 2)

    def run(d, sc, ch, sl, sharding=None):
        return kperm.significance(d, sc, asize, bsize, 10, 4096, key, chunk=256, chroms=ch,
                                  slots=sl, stream=stream, sharding=sharding)

    def counts():
        return dict(kperm.LAUNCHES), dict(kperm.COEFF_LAUNCHES)

    one = run(dist, scores, chroms, slots)
    mesh = make_mesh(devices=[cuda] * 4)
    serial = ({}, {})
    for sl in window_slices(len(scores), mesh):
        kperm.reset_launches()
        run(dist[sl], scores[sl], chroms[sl], slots[sl])
        for total, part in zip(serial, counts()):
            for k, v in part.items():
                total[k] = total.get(k, 0) + v
    kperm.reset_launches()
    four = run(dist, scores, chroms, slots, mesh)
    assert counts() == serial and sum(serial[0].values()) > 0
    assert (one.nscores < 4096).any() and (one.nscores == 4096).any()
    for f in ("pvals", "nscores", "hits"):
        assert getattr(four, f).tobytes() == getattr(one, f).tobytes(), f


# the sharded step's shares at once: (asize, bsize, windows); the windows
# divide over four shares; 1 + 1 is drosophila mode on frequencies
STEP_SHARE_PANELS = [(11, 10, 1996), (70, 58, 400), (1, 1, 400)]


def _step_inputs(cuda, asize, bsize, n, kind):
    """The first n windows of a 20,000-SNP panel (of frequencies at 1 + 1):
    codes on the card and npos, slot as host tensors ("card"), or all four
    as numpy arrays ("host")."""
    if (asize, bsize) == (1, 1):
        pos, fa, fb = make_freq_chromosome(20_000, 1_000_000, seed=3)
        am, bm = fa, fb
    else:
        pos, am, bm = make_panel(20_000, 1_000_000, asize, bsize, seed=asize)
    plan = plan_windows(pos, 1_000_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0][:n]
    assert len(ids) == n
    av, bv, npos, slot = _gathered(plan, ids, am, bm)
    if kind == "card":
        return av.to(cuda), bv.to(cuda), npos, slot
    return av.numpy(), bv.numpy(), npos.numpy(), slot.numpy()


def _step_launches() -> dict:
    return {f"{mod.__name__.rsplit('.', 1)[1]} {k}": v
            for mod in (kfet, kcss, kperm) for k, v in mod.LAUNCHES.items()}


def _reset_step_launches() -> None:
    for mod in (kfet, kcss, kperm):
        mod.reset_launches()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["card", "host"])
@pytest.mark.parametrize("asize,bsize,n", STEP_SHARE_PANELS)
def test_step_shares_at_once_without_syncs(cuda, asize, bsize, n, kind):
    """The warm step on [cuda] and on [cuda] * 4 makes no host sync
    (``set_sync_debug_mode("error")`` raises on one): each share's rows go
    up in one pinned copy and its kernels queue on its own stream.  Five
    calls of each, with every share stream held back by a sleep before a
    call and the caller's freed blocks refilled after it, so that a
    gather that did not wait for a share, or a block reused too early,
    would show: every output byte-equal to the one-share reference, and
    the launches at once those of the four shares run one at a time."""
    from divergence_tpu_torch.parallel import make_divergence_step, make_mesh, window_slices

    av, bv, npos, slot = _step_inputs(cuda, asize, bsize, n, kind)
    key = rng.prng_key(1)
    mesh4 = make_mesh(devices=[cuda] * 4)
    fly = (asize, bsize) == (1, 1)
    one = make_divergence_step(make_mesh(devices=[cuda]), asize, bsize, drosophila=fly)
    four = make_divergence_step(mesh4, asize, bsize, drosophila=fly)
    ref = one(av, bv, npos, slot, key)                       # cold
    four(av, bv, npos, slot, key)
    torch.cuda.synchronize()
    outs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            for step in (one, four):
                for i in range(4):
                    with torch.cuda.stream(kperm._share_stream(cuda, i)):
                        torch.cuda._sleep(200_000)
                outs.append(step(av, bv, npos, slot, key))
                torch.empty(1 << 22, device=cuda).fill_(float("nan"))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for out in outs:
        for name in ("fet_scores", "fet_stddev", "css_scores", "css_valid", "mc_hits"):
            assert torch.equal(out[name], ref[name]), name
        assert float(out["windows_evaluated"]) == float(ref["windows_evaluated"]) == n
        assert abs(float(out["score_sum"]) - float(ref["score_sum"])) <= (
            1e-9 * abs(float(ref["score_sum"])))
    serial: dict = {}
    for sl in window_slices(n, mesh4):
        _reset_step_launches()
        one(av[sl], bv[sl], npos[sl], slot[sl], key)
        for k, v in _step_launches().items():
            serial[k] = serial.get(k, 0) + v
    _reset_step_launches()
    four(av, bv, npos, slot, key)
    torch.cuda.synchronize()
    assert _step_launches() == serial and serial["perm css_perm_chunk" if asize < 64 else
                                                 "perm css_perm_chunk_block"] == 4


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_step_wrappers_with_descriptors_on_the_card(cuda, prec):
    """fet_window_batch, css_window_batch and css_dissim_gathered given
    npos and slot already on the card give the bits they give on host
    descriptors, and make no host sync once warm."""
    av, bv, npos, slot = _step_inputs(cuda, 11, 10, 400, "card")
    fast = prec == "fast"
    dtype = torch.float32 if fast else torch.float64
    npos_d, slot_d = npos.to(cuda), slot.to(cuda)
    a16, b16 = kfet.codes_int16(av).contiguous(), kfet.codes_int16(bv).contiguous()
    fet_args = (av, bv, npos, 0.95, rng.prng_key(2), 100, kfet.support_size(11, 10), 23, fast,
                slot)
    css_args = (av, bv, npos, rng.prng_key(3), 11, 10)

    def calls(**on_card):
        return (kfet.fet_window_batch(*fet_args, **on_card),
                kcss.css_window_batch(*css_args, fast=fast, slot=slot, **on_card),
                kcss.css_dissim_gathered(a16, b16, npos, dtype, on_card.get("npos_d")))

    want = calls()
    calls(npos_d=npos_d, slot_d=slot_d)                     # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = calls(npos_d=npos_d, slot_d=slot_d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got[0] + got[1] + (got[2],), want[0] + want[1] + (want[2],)):
        assert torch.equal(g, w)
