"""K9's window-stream sum order to m = 64, mirrored in torch
(``kernels/perm.py:window_power_order``: each lane's powers in word order,
the xor tree over a warp's lanes, the warps in order), against the plain
version (``null_power_sums_plain``) and the JAX package's
``_null_power_sums(stream="window")`` on the CPU.

The mirror sums the same float32 scores in another order than the plain
version's ``sum``, so the two agree within 1e-12 of each sum's magnitude
(measured: at most 6.2e-16).  Against JAX, whose scores it shares bit for bit,
the bands of tests/test_torch_approx.py hold (POWER_RTOL).  The card's
kernel equals the mirror bit for bit (tests/test_torch_kernels_gpu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.kernels import perm as jperm
from divergence_tpu_torch import rng
from divergence_tpu_torch.kernels import perm as tperm
from test_torch_approx import POWER_RTOL, band
from test_torch_mc_window import _keys, _phase1
from test_torch_smacof import one_torch_thread  # noqa: F401 (autouse)

PANELS = {2: (1, 1), 9: (5, 4), 21: (11, 10), 33: (17, 16), 64: (32, 32)}
CHUNKS = [32, 100, 512]
K0, N_CHUNKS = 3, 2
PLAIN_RTOL = 1e-12


def _cell(m, limit=12):
    asize, bsize = PANELS[m]
    dist, _, chroms, slots = _phase1(asize, bsize, seed=m + 1)
    return dist[:limit], chroms[:limit], slots[:limit], asize, bsize


def _scores(dist, wkeys, asize, bsize, chunk, bitgen):
    """[B, N_CHUNKS, chunk] float32 scores of chunks K0 .. K0 + N_CHUNKS - 1."""
    distf = dist.to(torch.float32)
    return torch.stack([
        tperm._perm_scores(distf, rng.fold_in(wkeys, k), asize, bsize, chunk, bitgen)
        for k in range(K0, K0 + N_CHUNKS)], dim=1)


def _magnitude_err(got, want, n):
    """Each sum's error against n rms^q, rms^2 = want[:, 1] / n (a sum near
    zero does not inflate it)."""
    rms = (want[:, 1:2] / n).sqrt()
    q = torch.arange(1, 4, dtype=want.dtype)[None, :, None]
    return float(((got - want).abs() / (n * rms ** q)).max())


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("m", sorted(PANELS))
def test_window_power_order_equals_plain(m, bitgen, chunk):
    dist, chroms, slots, asize, bsize = _cell(m)
    wkeys = rng.window_keys(rng.prng_key(7), chroms, slots)
    got = tperm.window_power_order(_scores(dist, wkeys, asize, bsize, chunk, bitgen))
    want = tperm.null_power_sums_plain(dist, wkeys, asize, bsize, chunk, K0, N_CHUNKS,
                                       "window", bitgen)
    assert got.shape == want.shape == (N_CHUNKS, 3, dist.shape[0])
    assert got.dtype == torch.float64
    assert _magnitude_err(got, want, chunk) <= PLAIN_RTOL


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("m", sorted(PANELS))
def test_window_power_order_within_jax_band(m, bitgen):
    dist, chroms, slots, asize, bsize = _cell(m)
    jkey, tkey = _keys(9)
    jk = jperm.window_keys(jkey, jnp.asarray(chroms), jnp.asarray(slots))
    tk = rng.window_keys(tkey, chroms, slots)
    want = np.asarray(jperm._null_power_sums(jnp.asarray(np.asarray(dist)), jk, asize, bsize,
                                             512, N_CHUNKS, jnp.int32(K0), bitgen=bitgen,
                                             stream="window"))
    got = tperm.window_power_order(_scores(dist, tk, asize, bsize, 512, bitgen)).numpy()
    assert got.shape == want.shape
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() <= band(POWER_RTOL, m), rel.max()


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("m", [9, 33])
def test_window_power_order_nan_for_non_finite_windows(m, chunk):
    """A window with a NaN or an Inf distance gets NaN sums (its plain
    scores are NaN: NaN, or Inf times a zero coefficient); the others keep
    the plain version's sums."""
    dist, chroms, slots, asize, bsize = _cell(m, limit=6)
    dist = dist.clone()
    dist[1, 0, 2] = dist[1, 2, 0] = float("nan")
    dist[3, 1, 1] = float("inf")
    dist[4, 0, m - 1] = dist[4, m - 1, 0] = float("-inf")
    wkeys = rng.window_keys(rng.prng_key(3), chroms, slots)
    got = tperm.window_power_order(_scores(dist, wkeys, asize, bsize, chunk, "mix"))
    want = tperm.null_power_sums_plain(dist, wkeys, asize, bsize, chunk, K0, N_CHUNKS,
                                       "window", "mix")
    bad = torch.zeros(dist.shape[0], dtype=torch.bool)
    bad[[1, 3, 4]] = True
    assert got[:, :, bad].isnan().all() and want[:, :, bad].isnan().all()
    assert not got[:, :, ~bad].isnan().any()
    assert _magnitude_err(got[:, :, ~bad], want[:, :, ~bad], chunk) <= PLAIN_RTOL


def test_window_power_order_is_the_lane_warp_order():
    """The mirror on hand-made scores: lane and warp partials added as the
    kernel adds them (an order a plain sum does not follow)."""
    chunk = 300   # 10 words: warps 0 and 1 take two, the rest one
    s = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 1, chunk)).astype(
        np.float32)) * 1e3
    got = tperm.window_power_order(s)
    v = s.double()
    for e, t in enumerate((v, v * v, v * v * v)):
        words = torch.nn.functional.pad(t, (0, 20)).reshape(2, 10, 32)
        total = torch.zeros(2, dtype=torch.float64)
        for warp in range(tperm.POWER_WARPS):
            lane = torch.zeros((2, 32), dtype=torch.float64)
            for q in range(warp, 10, tperm.POWER_WARPS):
                lane = lane + words[:, q]
            for o in (16, 8, 4, 2, 1):
                lane = lane + lane[:, torch.arange(32) ^ o]
            total = total + lane[:, 0]
        assert torch.equal(got[0, e], total)
