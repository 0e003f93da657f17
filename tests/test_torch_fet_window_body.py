"""K2's window body (csrc/fet_window_stats.cuh, shared by K2, K2r and
K10) in the port's plain torch version: _aggregate_sorted, whose stddev
sums the replicates in the kernels' lane order (_lane_stddev: sample s on
lane s % 32, each lane's samples in order from 0, then an xor butterfly),
against the JAX package's _aggregate run on the CPU.

Tolerances, relative to max(|reference|, 1): exact (float64) 1e-12, fast
(float32) 1e-5 — the same as tests/test_torch_fet.py; the lane order
moves a sum by a few ulp against XLA's.  The windows hold n in {1, 2, 32,
33, 128, 129} SNPs (the warp body's 32-key and 128-key widths and one
past each), so t1 = 0 (n = 1, perc = 1.0) and idx == hi (n = 1, perc =
1.0, perc = 0.0 at n = 1) occur; nsamples 37 (part of a lane's row),
100 and 200 (two of the warp body's passes of 128)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.kernels import fet as jfet
from divergence_tpu.kernels.perm import slot_keys as jslot_keys
from divergence_tpu_torch import rng
from divergence_tpu_torch.kernels import fet as tfet

TOL = {"exact": 1e-12, "fast": 1e-5}
DTYPES = {"exact": (torch.float64, jnp.float64, np.float64),
          "fast": (torch.float32, jnp.float32, np.float32)}
LENGTHS = [1, 2, 32, 33, 128, 129]


def _windows(np_dtype, seed):
    """Per-SNP scores [B, P] (ties included, values past npos arbitrary)
    and npos [B], two windows of each length."""
    rs = np.random.default_rng(seed)
    npos = np.array(LENGTHS * 2, dtype=np.int64)
    P = tfet._window_pad(int(npos.max()))
    logs = rs.exponential(2.0, size=(len(npos), P)).astype(np_dtype)
    logs[1::2, ::3] = logs[1::2, :1]            # repeated values
    logs[:, -1] = np_dtype(1e30)                # rows past npos never count
    return logs, npos


@pytest.mark.parametrize("nsamples", [37, 100, 200])
@pytest.mark.parametrize("perc", [0.95, 1.0, 0.5, 0.0])
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_window_body_matches_jax_aggregate(prec, perc, nsamples):
    tdt, jdt, ndt = DTYPES[prec]
    logs, npos = _windows(ndt, seed=int(perc * 100) + nsamples)
    slot = np.arange(len(npos), dtype=np.int64) * 7 + 3
    key = jax.random.fold_in(jax.random.PRNGKey(5), 17)
    want = jfet._aggregate(jnp.asarray(logs), jnp.asarray(npos), perc,
                           jslot_keys(key, jnp.asarray(slot)), nsamples, jdt)
    tkey = rng.fold_in(rng.prng_key(5), 17)
    got = tfet._aggregate(torch.from_numpy(logs), torch.from_numpy(npos), perc,
                          rng.slot_keys(tkey, torch.from_numpy(slot)), nsamples, tdt)
    for g, w in zip(got, want):
        w = np.asarray(w, dtype=np.float64)
        err = np.abs(g.double().numpy() - w) / np.maximum(np.abs(w), 1.0)
        assert err.max() <= TOL[prec], (err.max(), np.argmax(err))
    if perc not in (0.0, 1.0):
        assert (np.asarray(want[1])[npos > 2] > 0).all()   # the bootstrap is exercised


def _kernel_order_stddev(reps):
    """The kernels' sums written out one addition at a time in the
    replicates' own dtype (numpy scalars round like the card's)."""
    S = len(reps)
    zero = reps.dtype.type(0)
    lanes = [zero] * 32
    for s in range(S):
        lanes[s % 32] = lanes[s % 32] + reps[s]

    def butterfly(v):
        for stride in (16, 8, 4, 2, 1):
            v = [v[lane] + v[lane ^ stride] for lane in range(32)]
        assert all(x == v[0] for x in v)       # every lane holds the total
        return v[0]

    mu = butterfly(lanes) / reps.dtype.type(S)
    sq = [zero] * 32
    for s in range(S):
        d = reps[s] - mu
        sq[s % 32] = sq[s % 32] + d * d
    return np.sqrt(butterfly(sq) / reps.dtype.type(S))


@pytest.mark.parametrize("nsamples", [1, 37, 100, 200])
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_lane_stddev_is_the_kernels_order(prec, nsamples):
    """_lane_stddev gives the bits of the order the kernels sum in."""
    tdt, _, ndt = DTYPES[prec]
    reps = np.random.default_rng(nsamples).normal(3.0, 1.5, size=(5, nsamples)).astype(ndt)
    got = tfet._lane_stddev(torch.from_numpy(reps)).numpy()
    want = np.array([_kernel_order_stddev(r) for r in reps], dtype=ndt)
    assert got.dtype == ndt and np.array_equal(got, want)
    np.testing.assert_allclose(got, reps.astype(np.float64).std(axis=1),
                               rtol=TOL[prec] * 10, atol=0)


@pytest.mark.parametrize("nsamples", [37, 100])
@pytest.mark.parametrize("perc", [0.95, 1.0, 0.5, 0.0])
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_band_body_matches_jax_aggregate(prec, perc, nsamples):
    """The wide body's order (aggregate_band: the bootstrap in tiles of
    steps before any key is read, then the picks from a radix select of
    the band of ranks) on the same windows: within TOL of JAX's _aggregate
    and bit for bit the sorting bodies' plain version, _aggregate."""
    tdt, jdt, ndt = DTYPES[prec]
    logs, npos = _windows(ndt, seed=int(perc * 100) + nsamples + 1)
    slot = np.arange(len(npos), dtype=np.int64) * 5 + 1
    key = jax.random.fold_in(jax.random.PRNGKey(6), 2)
    want = jfet._aggregate(jnp.asarray(logs), jnp.asarray(npos), perc,
                           jslot_keys(key, jnp.asarray(slot)), nsamples, jdt)
    wkeys = rng.slot_keys(rng.fold_in(rng.prng_key(6), 2), torch.from_numpy(slot))
    got = tfet.aggregate_band(torch.from_numpy(logs), torch.from_numpy(npos), perc, wkeys,
                              nsamples, tdt, lambda v: v, tile=5)
    for g, w in zip(got, want):
        w = np.asarray(w, dtype=np.float64)
        err = np.abs(g.double().numpy() - w) / np.maximum(np.abs(w), 1.0)
        assert err.max() <= TOL[prec], (err.max(), np.argmax(err))
    plain = tfet._aggregate(torch.from_numpy(logs), torch.from_numpy(npos), perc, wkeys,
                            nsamples, tdt)
    for g, p in zip(got, plain):
        assert torch.equal(g.view(torch.uint8), p.view(torch.uint8))
