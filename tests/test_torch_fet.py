"""The port's FET math (divergence_tpu_torch.kernels.fet, plain torch path
on the CPU) against the JAX package's kernels run on the CPU.

Tolerances, relative to max(|reference|, 1): exact (float64) 1e-12, fast
(float32) 1e-5 — the sums run in another order than XLA's, which moves
results by a few ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.core.windows import plan_windows
from divergence_tpu.kernels import fet as jfet
from divergence_tpu.kernels.perm import chrom_hash
from divergence_tpu_torch import rng
from divergence_tpu_torch.kernels import fet as tfet

TOL = {"exact": 1e-12, "fast": 1e-5}
DTYPES = {"exact": (torch.float64, jnp.float64), "fast": (torch.float32, jnp.float32)}


def assert_close(got, want, tol):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max(initial=0.0) <= tol, (err.max(), np.argmax(err))


def _codes(rs, shape):
    return rs.choice(
        np.array([3, -3, 0, -10000], dtype=np.int16), size=shape, p=[0.4, 0.3, 0.25, 0.05]
    )


def test_count_tables():
    rs = np.random.default_rng(0)
    a, b = _codes(rs, (5, 7, 11)), _codes(rs, (5, 7, 10))
    got = tfet.count_tables(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jfet.count_tables(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


def test_shift_min_first():
    rs = np.random.default_rng(1)
    t = rs.integers(0, 6, size=(400, 4)).astype(np.int32)   # many ties
    got = tfet._shift_min_first(torch.from_numpy(t)).numpy()
    want = np.asarray(jfet._shift_min_first(jnp.asarray(t)))
    assert np.array_equal(got, want)


def test_fet_two_tailed_exact_matches_jax():
    rs = np.random.default_rng(2)
    tables = rs.integers(0, 12, size=(500, 4)).astype(np.int32)
    nmax = int(tables.sum(1).max()) + 2
    maxs = nmax // 2 + 2
    got = tfet.fet_two_tailed(torch.from_numpy(tables), maxs, nmax).numpy()
    want = np.asarray(jfet.fet_two_tailed(jnp.asarray(tables), maxs, nmax))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_fet_two_tailed_goldens():
    tables = torch.tensor(
        [[2, 7, 8, 2], [2, 3, 6, 4], [2, 2, 3, 3], [1, 3, 2, 3], [0, 0, 0, 0]]
    )
    got = tfet.fet_two_tailed(tables, maxs=12, nmax=24).numpy()
    np.testing.assert_allclose(got[:4], [0.0230141, 0.6083916, 1.0, 1.0], rtol=1e-5)
    assert got[4] == 1.0


@pytest.mark.parametrize("hi", [12, 60])
def test_fet_two_tailed_neglog10_fast_matches_jax(hi):
    rs = np.random.default_rng(3)
    tables = rs.integers(0, hi, size=(500, 4)).astype(np.int32)
    nmax = int(tables.sum(1).max()) + 2
    maxs = nmax // 2 + 2
    got = tfet.fet_two_tailed_neglog10(torch.from_numpy(tables), maxs, nmax).numpy()
    want = np.asarray(
        jfet.fet_two_tailed_neglog10(jnp.asarray(tables), maxs, nmax, dtype=jnp.float32)
    )
    assert got.dtype == np.float32
    assert np.isfinite(got).all()
    assert_close(got, want, TOL["fast"])


@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize", [(11, 10), (4, 3)])
def test_lut_matches_jax_neglog10_p(prec, asize, bsize):
    """The LUT over the table grid against JAX ``_neglog10_p(grid)`` on every
    table a panel can produce (f0 + f1 <= asize, f2 + f3 <= bsize)."""
    tdt, jdt = DTYPES[prec]
    maxs, nmax = jfet.support_size(asize, bsize), asize + bsize + 2
    grid = jfet._table_grid(asize, bsize)
    got = tfet.fet_lut(asize, bsize, maxs, nmax, tdt, "cpu").numpy()
    want = np.asarray(jfet._neglog10_p(jnp.asarray(grid), maxs, nmax, jdt))
    reach = (grid[:, 0] + grid[:, 1] <= asize) & (grid[:, 2] + grid[:, 3] <= bsize)
    assert got.shape == (len(grid),) and np.isfinite(got).all()
    assert_close(got[reach], want[reach], TOL[prec])


@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize", [(11, 10), (48, 48)])
def test_fet_snp_logs_matches_jax(prec, asize, bsize):
    rs = np.random.default_rng(4)
    vals = _codes(rs, (600, asize + bsize))
    maxs, nmax = jfet.support_size(asize, bsize), asize + bsize + 2
    fast = prec == "fast"
    assert tfet.lut_active(asize, bsize) == jfet.lut_active(asize, bsize)
    got = tfet.fet_snp_logs(torch.from_numpy(vals), asize, maxs, nmax, fast=fast)
    want = np.asarray(
        jfet.fet_snp_logs_joint(jnp.asarray(vals), asize, maxs, nmax, fast=fast)
    )
    assert got.dtype == DTYPES[prec][0]
    assert_close(got.numpy(), want, TOL[prec])


def test_lut_switch_is_panel_only():
    assert tfet.lut_active(11, 10)
    assert not tfet.lut_active(48, 48)
    for a, b in [(11, 10), (30, 30), (40, 40), (48, 48), (100, 100)]:
        assert tfet.lut_active(a, b) == jfet.lut_active(a, b)


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_interp_ranks_and_steps_max(prec):
    tdt, jdt = DTYPES[prec]
    npos = np.arange(0, 300, dtype=np.int64)
    for perc in (0.95, 0.84, 0.5, 0.0, 1.0):
        got = tfet._interp_ranks(torch.from_numpy(npos), perc, dtype=tdt)
        want = jfet._interp_ranks(jnp.asarray(npos), perc, dtype=jdt)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        for P in (32, 64, 4096):
            assert tfet._steps_max(P, perc, tdt) == jfet._steps_max(P, perc, jdt)


def _window_rows(positions, regend, wsize=2500, wstep=500):
    plan = plan_windows(positions, regend, wsize, wstep)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    return plan.lo[ids], plan.npos[ids], plan.slot[ids]


@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("perc,nsamples", [(0.95, 100), (0.5, 37)])
def test_aggregate_matches_jax_fet_aggregate_all(panel, prec, perc, nsamples):
    """Window scores and bootstrap stddev against JAX ``fet_aggregate_all``
    fed the same per-SNP scores and chromosome key: every window."""
    tdt, jdt = DTYPES[prec]
    _, _, _, _, positions, amat, bmat = panel
    vals = np.concatenate([amat, bmat], axis=1)
    asize, bsize = amat.shape[1], bmat.shape[1]
    maxs, nmax = jfet.support_size(asize, bsize), asize + bsize + 2
    logs = np.array(   # a writable copy for torch.from_numpy
        jfet.fet_snp_logs_joint(jnp.asarray(vals), asize, maxs, nmax, fast=prec == "fast")
    )
    lo, npos, slot = _window_rows(positions, 20_000)
    P = tfet._window_pad(int(npos.max()))
    key = jax.random.fold_in(jax.random.PRNGKey(11), chrom_hash("chrIV"))
    rows = np.stack([lo, npos, slot])
    want = np.asarray(
        jfet.fet_aggregate_all(
            jnp.asarray(logs), jnp.asarray(rows), key, Bp=rows.shape[1], P=P,
            perc=perc, nsamples=nsamples, fast=prec == "fast",
        )
    )
    tkey = rng.fold_in(rng.prng_key(11), rng.chrom_hash("chrIV"))
    got = tfet.fet_aggregate(
        torch.from_numpy(logs), *(torch.from_numpy(a) for a in (lo, npos, slot)),
        tkey, perc, nsamples,
    )
    assert got.dtype == tdt and got.shape == (2, len(lo))
    assert (want[1] > 0).sum() > len(lo) // 2      # the bootstrap is exercised
    assert_close(got[0].numpy(), want[0], TOL[prec])
    assert_close(got[1].numpy(), want[1], TOL[prec])


def test_aggregate_is_chunk_invariant(panel, monkeypatch):
    """Every window's result depends on that window alone: the plain
    version's chunking changes nothing, bit for bit."""
    _, _, _, _, positions, amat, bmat = panel
    vals = torch.from_numpy(np.concatenate([amat, bmat], axis=1))
    logs = tfet.fet_snp_logs(vals, 11, tfet.support_size(11, 10), 23)
    lo, npos, slot = (torch.from_numpy(a) for a in _window_rows(positions, 20_000))
    key = rng.fold_in(rng.prng_key(0), rng.chrom_hash("chrT"))
    whole = tfet.fet_aggregate(logs, lo, npos, slot, key, 0.95, 100)
    monkeypatch.setattr(tfet, "_AGG_WINDOW_CHUNK", 7)
    chunked = tfet.fet_aggregate(logs, lo, npos, slot, key, 0.95, 100)
    assert torch.equal(whole, chunked)
    # a window keeps its result in any subset: stream = f(seed, chrom, slot)
    sub = tfet.fet_aggregate(logs, lo[5::3], npos[5::3], slot[5::3], key, 0.95, 100)
    assert torch.equal(sub, whole[:, 5::3])


def test_aggregate_empty_batch():
    out = tfet.fet_aggregate(
        torch.zeros(4, dtype=torch.float64), *(torch.zeros(0, dtype=torch.int64),) * 3,
        rng.prng_key(0), 0.95, 100,
    )
    assert out.shape == (2, 0)


def test_wrappers_refuse_other_devices():
    """On a tensor that is neither CPU nor CUDA the wrappers raise: the plain
    version is taken only for CPU tensors."""
    vals = torch.zeros((4, 21), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfet.fet_snp_logs(vals, 11, 12, 23)
    logs = torch.zeros(4, dtype=torch.float64, device="meta")
    idx = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfet.fet_aggregate(logs, idx, idx + 1, idx, rng.prng_key(0), 0.95, 10)
