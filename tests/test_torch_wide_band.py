"""The wide FET body's orders (``csrc/fet_window_stats.cuh:band_window_stats``,
K2 / K2r / K10 past P = 256) in the port's plain torch mirror:

* ``band_picks``: the order statistics at given ranks without a sort (a
  radix select of the lowest and highest rank over the keys mapped to
  ordered integers, stopped once the bins between them hold at most 512,
  8 or 0 keys, else run to the last digit with only the keys strictly
  between the ends sorted), held bit for bit to ``torch.sort`` picked at
  the same ranks: seeded keys, all equal, mostly zeros, +inf, -0.0, one
  key, bands at rank 0 and n - 1;
* ``order_stat_uniforms_tiled``: the bootstrap's terms drawn and raised a
  tile of steps at a time, then folded in step order, held bit for bit to
  the Renyi loop ``_order_stat_uniforms`` for several tile sizes;
* ``aggregate_band``: the whole body, held bit for bit to the plain
  ``_aggregate`` / ``_aggregate_ranks`` (windows with -inf / -1 pads past
  their n keys), and to the JAX package's ``_aggregate`` /
  ``_aggregate_ranks`` run on the CPU at P = 8,192 and 16,384 within the
  FET tolerances (relative to max(|reference|, 1): exact 1e-12, fast
  1e-5).

One torch thread each (the ``one_torch_thread`` fixture)."""

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


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _keys(kind: str, dtype: torch.dtype, n: int, seed: int) -> torch.Tensor:
    rs = np.random.default_rng(seed)
    if dtype == torch.int32:
        base = {"seeded": rs.integers(0, 4096, n), "equal": np.full(n, 17),
                "zeros": np.where(rs.random(n) < 0.9, 0, rs.integers(1, 50, n)),
                "inf": rs.integers(0, 4096, n), "one": rs.integers(0, 9, n)}[kind]
        return torch.from_numpy(base.astype(np.int32))
    zero = -0.0 if kind == "zeros" and dtype == torch.float64 else 0.0
    x = {"seeded": rs.exponential(2.0, n), "equal": np.full(n, 3.25),
         "zeros": np.where(rs.random(n) < 0.9, zero, rs.exponential(1.0, n)),
         "inf": np.where(rs.random(n) < 0.05, np.inf, rs.exponential(1.0, n)),
         "one": rs.exponential(1.0, n)}[kind]
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.int32])
@pytest.mark.parametrize("kind,n", [("seeded", 5000), ("equal", 3000), ("zeros", 8192),
                                    ("inf", 4000), ("one", 1), ("seeded", 2)])
@pytest.mark.parametrize("where", ["middle", "bottom", "top", "spread"])
@pytest.mark.parametrize("early", [tfet.WIDE_EARLY_KEYS, 8, 0])
def test_band_picks_equal_sort_picks(dtype, kind, n, where, early):
    """The picks equal torch.sort's whether the select stops once the
    band's bins hold at most ``early`` keys or runs every digit (0, as
    band_keys = 0 makes the kernel: the ends' counts, the keys strictly
    between)."""
    keys = _keys(kind, dtype, n, seed=n + len(kind))
    rs = np.random.default_rng(n)
    lo = {"middle": int(0.95 * (n - 1)) - 150, "bottom": 0, "top": n - 60,
          "spread": 0}[where]
    hi = {"middle": int(0.95 * (n - 1)) + 150, "bottom": 40, "top": n - 1,
          "spread": n - 1}[where]
    lo, hi = max(lo, 0), min(max(hi, 0), n - 1)
    ranks = torch.from_numpy(rs.integers(lo, hi + 1, size=200))
    ranks[0], ranks[1] = lo, hi
    got = tfet.band_picks(keys, ranks, early)
    want = torch.sort(keys).values[ranks]
    assert got.dtype == keys.dtype
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("nsamples", [37, 100])
@pytest.mark.parametrize("tile", [1, 7, None])
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_tiled_bootstrap_equals_renyi_loop(prec, tile, nsamples):
    """The wide body's term-then-fold order gives the Renyi loop's bits,
    u1 = U_(k1) and u2 captured at t2, on windows of different n."""
    dtype = DTYPES[prec][0]
    npos = torch.tensor([1, 2, 300, 1000, 4097])
    perc = 0.95
    idx, hi, _ = tfet._interp_ranks(npos, perc, dtype)
    nf = npos.to(dtype)[:, None]
    t1 = torch.clamp(nf - 1.0 - idx.to(dtype)[:, None], min=0.0)
    t2 = nf - 1.0 - hi.to(dtype)[:, None]
    wkeys = rng.slot_keys(rng.prng_key(4), torch.arange(5) * 11)
    steps = tfet._steps_max(8192, perc, dtype)
    want = tfet._order_stat_uniforms(wkeys, nf, t1, t2, nsamples, steps, dtype)
    got = tfet.order_stat_uniforms_tiled(wkeys, nf, t1, t2, nsamples, steps, dtype, tile)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


def _windows(np_dtype, P, B, seed, ranks=False):
    """B windows [B, P] of per-SNP keys (scores with a third zeros, or
    int32 LUT ranks), the first of n = P, the rest of n in (P/2, P), the
    rows past n -inf / -1 pads."""
    rs = np.random.default_rng(seed)
    npos = rs.integers(P // 2 + 1, P, size=B)
    npos[0] = P
    if ranks:
        x = rs.integers(0, 4096, size=(B, P)).astype(np.int32)
        pad = -1
    else:
        x = np.where(rs.random((B, P)) < 0.33, 0.0, rs.exponential(1.0, (B, P)))
        x = x.astype(np_dtype)
        pad = -np.inf
    x = np.where(np.arange(P)[None, :] < npos[:, None], x, pad).astype(x.dtype)
    return x, npos


@pytest.mark.parametrize("perc", [0.95, 0.5, 0.999, 0.0])
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_aggregate_band_equals_plain_aggregate(one_torch_thread, prec, perc):
    """aggregate_band (no sort) gives _aggregate's and _aggregate_ranks's
    bits on windows with -inf / -1 pads: P = 8,192 at perc 0.95 and 0.999,
    fewer keys where the bootstrap walks more of them (P = 1,024 at 0.5,
    512 at 0: its steps number n - 1 - idx)."""
    tdt, _, ndt = DTYPES[prec]
    P = {0.95: 8192, 0.999: 8192, 0.5: 1024, 0.0: 512}[perc]
    logs, npos = _windows(ndt, P, 3, seed=int(perc * 1000))
    npos_t = torch.from_numpy(npos)
    wkeys = rng.slot_keys(rng.prng_key(2), torch.arange(3) + 40)
    want = tfet._aggregate(torch.from_numpy(logs), npos_t, perc, wkeys, 100, tdt)
    got = tfet.aggregate_band(torch.from_numpy(logs), npos_t, perc, wkeys, 100, tdt,
                              lambda v: v)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    lut = torch.sort(torch.from_numpy(np.random.default_rng(3).exponential(1.0, 4096))
                     .to(tdt)).values
    ranks, npos = _windows(ndt, P, 3, seed=7, ranks=True)
    npos_t = torch.from_numpy(npos)
    want = tfet._aggregate_ranks(torch.from_numpy(ranks), npos_t, perc, wkeys, 100, lut)
    got = tfet.aggregate_band(torch.from_numpy(ranks), npos_t, perc, wkeys, 100, tdt,
                              lambda r: lut[r.long()])
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("P", [8192, 16384])
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_aggregate_band_matches_jax(one_torch_thread, prec, P):
    """The band body against the JAX package's _aggregate and
    _aggregate_ranks on the CPU, within the FET tolerances."""
    tdt, jdt, ndt = DTYPES[prec]
    logs, npos = _windows(ndt, P, 2, seed=P)
    slot = np.array([5, 12], dtype=np.int64)
    key = jax.random.fold_in(jax.random.PRNGKey(8), 3)
    tkey = rng.fold_in(rng.prng_key(8), 3)
    wkeys = rng.slot_keys(tkey, torch.from_numpy(slot))
    jkeys = jslot_keys(key, jnp.asarray(slot))
    want = jfet._aggregate(jnp.asarray(logs), jnp.asarray(npos), 0.95, jkeys, 100, jdt)
    got = tfet.aggregate_band(torch.from_numpy(logs), torch.from_numpy(npos), 0.95, wkeys,
                              100, tdt, lambda v: v)
    for g, w in zip(got, want):
        w = np.asarray(w, dtype=np.float64)
        err = np.abs(g.double().numpy() - w) / np.maximum(np.abs(w), 1.0)
        assert err.max() <= TOL[prec], err.max()
    lut = np.sort(np.random.default_rng(P).exponential(1.0, 4096)).astype(ndt)
    ranks, npos = _windows(ndt, P, 2, seed=P + 1, ranks=True)
    want = jfet._aggregate_ranks(jnp.asarray(ranks), jnp.asarray(npos), 0.95, jkeys, 100,
                                 jnp.asarray(lut), jdt)
    tlut = torch.from_numpy(lut)
    got = tfet.aggregate_band(torch.from_numpy(ranks), torch.from_numpy(npos), 0.95, wkeys,
                              100, tdt, lambda r: tlut[r.long()])
    for g, w in zip(got, want):
        w = np.asarray(w, dtype=np.float64)
        err = np.abs(g.double().numpy() - w) / np.maximum(np.abs(w), 1.0)
        assert err.max() <= TOL[prec], err.max()
