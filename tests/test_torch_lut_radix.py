"""K1r's radix sort mirrored in torch (``kernels/fet.py``:
``lut_radix_keys``, ``lut_radix_rank``) against the
JAX package's stable ``jnp.argsort`` of the LUT
(``divergence_tpu/kernels/fet.py:fet_snp_ranks_joint``), run on the CPU.

Subnormals: XLA's CPU backend compares with subnormals taken as zero, so
``jnp.argsort`` ties them with the zeros, where IEEE < (the kernel's, the
plain version's, numpy's) puts them above.  A FET LUT holds none (its
least non-zero score is ~5e-17 in float64); on a synthetic LUT with them
the mirror holds IEEE order, and JAX's order is the mirror's on that LUT
with its subnormals flushed to zeros of their sign.

The kernel (``csrc/fet_rank.cu``) sorts (key, index) pairs by 8-bit
digits, least significant first, one stable pass a digit; the key is the
value plus 0.0 mapped to an unsigned integer in IEEE < order.  The mirror
takes the same keys and passes, so it holds the kernel's order to JAX's:
the ranks
exactly and ``lut_sorted`` bit for bit (-0.0 kept in its place), on the
JAX package's own LUTs and on synthetic ones.  The kernel itself is held
to the plain version on the card (``tests/test_torch_kernels_gpu.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.kernels import fet as jfet
from divergence_tpu_torch.kernels import fet as tfet
from test_torch_fet_ranks import BITS, _codes, _jax_lut
from test_torch_smacof import one_torch_thread  # noqa: F401 (autouse)

NP_DT = {"exact": np.float64, "fast": np.float32}


def jax_order(lut: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(lut_sorted, rank_of_entry) as ``fet_snp_ranks_joint`` makes them."""
    order = np.asarray(jnp.argsort(jnp.asarray(lut)))
    rank = np.empty(len(lut), np.int32)
    rank[order] = np.arange(len(lut), dtype=np.int32)
    return lut[order], rank


def flushed(lut: np.ndarray) -> np.ndarray:
    """``lut`` with its subnormals as zeros of their sign (what XLA's CPU
    backend compares)."""
    tiny = np.finfo(lut.dtype).tiny
    return np.where(np.abs(lut) < tiny, np.copysign(np.zeros_like(lut), lut), lut)


def assert_mirror_is_jax(lut: np.ndarray, prec: str) -> None:
    """The mirror's order of ``lut`` is the plain version's and numpy's
    stable argsort of ``lut + 0.0`` (IEEE <), and JAX's where ``lut`` has
    no subnormal (else JAX's is the mirror's of :func:`flushed`)."""
    order = np.argsort(lut + lut.dtype.type(0.0), kind="stable")
    want_rank = np.empty(len(lut), np.int32)
    want_rank[order] = np.arange(len(lut), dtype=np.int32)
    want_sorted = lut[order]
    got_sorted, got_rank = tfet.lut_radix_rank(torch.from_numpy(lut))
    assert got_rank.dtype == torch.int32
    assert np.array_equal(got_rank.numpy(), want_rank)
    assert np.array_equal(got_sorted.numpy().view(BITS[prec]), want_sorted.view(BITS[prec]))
    # and the plain version the kernel is held to on the card
    plain_sorted, plain_rank = tfet.fet_lut_rank_plain(torch.from_numpy(lut))
    assert torch.equal(plain_rank, got_rank)
    assert np.array_equal(plain_sorted.numpy().view(BITS[prec]), want_sorted.view(BITS[prec]))
    jax_sorted, jax_rank = jax_order(lut)
    f = flushed(lut)
    _, mirror_rank = tfet.lut_radix_rank(torch.from_numpy(f))
    assert np.array_equal(mirror_rank.numpy(), jax_rank)
    assert np.array_equal(lut[np.argsort(jax_rank)].view(BITS[prec]), jax_sorted.view(BITS[prec]))
    if np.array_equal(f.view(BITS[prec]), lut.view(BITS[prec])):
        assert np.array_equal(got_rank.numpy(), jax_rank)
        assert np.array_equal(got_sorted.numpy().view(BITS[prec]), jax_sorted.view(BITS[prec]))


@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize", [(3, 2), (11, 10), (15, 15)])
def test_mirror_on_jax_lut(prec, asize, bsize):
    """The JAX package's LUT: the mirror's order is ``jnp.argsort``'s and
    its lut_sorted is ``fet_snp_ranks_joint``'s, bit for bit."""
    lut = _jax_lut(asize, bsize, prec).copy()
    assert_mirror_is_jax(lut, prec)
    vals = _codes(np.random.default_rng(9), (500, asize + bsize))
    jls, _ = jfet.fet_snp_ranks_joint(jnp.asarray(vals), asize, jfet.support_size(asize, bsize),
                                      asize + bsize + 2, fast=prec == "fast")
    got = tfet.lut_radix_rank(torch.from_numpy(lut))[0].numpy()
    assert np.array_equal(got.view(BITS[prec]), np.asarray(jls).view(BITS[prec]))


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_plan_at_11_10(prec):
    """Why the kernel passes over every digit, with no plan: at 11 + 10, on
    JAX's LUT and the port's, no digit is trivial (the LUT holds +0.0 /
    -0.0 at p = 1 beside scores from ~1e-16 to 5.5, so even the key's top
    digit, the sign and high exponent bits, spreads over several bins), so
    a digit that put every key in one bin, and could be skipped, never
    comes; 7,703 of the 17,424 entries are zeros of either sign, the
    largest bin of every digit."""
    width = 64 if prec == "exact" else 32
    dt = torch.float64 if prec == "exact" else torch.float32
    port = tfet.fet_lut_plain(11, 10, tfet.support_size(11, 10), 23, dt, torch.device("cpu"))
    for lut in (torch.from_numpy(_jax_lut(11, 10, prec).copy()), port):
        keys, w = tfet.lut_radix_keys(lut)
        assert w == width
        assert int((lut == 0).sum()) == 7703
        for shift in range(0, width, 8):
            hist = torch.bincount(tfet._digits(keys, shift, w), minlength=256)
            assert int(hist.max()) >= 7703 and int((hist > 0).sum()) > 1


def synthetic(kind: str, prec: str, G: int = 5000) -> np.ndarray:
    rs = np.random.default_rng(sum(map(ord, kind)))
    if kind == "signed_zeros":
        v = rs.choice(np.array([0.0, -0.0, 1.5, 0.25]), size=G)
    elif kind == "long_runs":
        v = np.repeat(rs.random(7) * 10.0, G // 7 + 1)[:G]
        v[rs.integers(0, G, 50)] = -0.0
    elif kind == "subnormals":
        tiny = np.float32(1e-40) if prec == "fast" else 5e-324
        v = rs.choice(np.array([0.0, -0.0, tiny, 2 * tiny, 1e-300, 2.2e-308, 1.0]), size=G)
    elif kind == "every_digit":
        # uniform mantissas and exponents: every 8-bit digit spreads
        v = rs.random(G) * 2.0 ** rs.integers(-60, 60, G)
    elif kind == "one_key":
        v = np.full(G, 3.25)
        v[::3] = 3.25
    elif kind == "integers":
        # small integers in float64: the mantissa's low digits are all zero
        v = rs.integers(0, 200, G).astype(np.float64)
        v[::11] = -0.0
    return v.astype(NP_DT[prec])


@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("kind", ["signed_zeros", "long_runs", "subnormals", "every_digit",
                                  "one_key", "integers"])
def test_mirror_on_synthetic_luts(prec, kind):
    """Synthetic LUTs: the mirror's order is ``jnp.argsort``'s exactly and
    its lut_sorted JAX's bit for bit (with subnormals: IEEE order, and
    JAX's the mirror's of the flushed LUT), whether every digit of the
    keys spreads or some put every key in one bin (a pass over such a
    digit is the identity)."""
    lut = synthetic(kind, prec)
    assert_mirror_is_jax(lut, prec)
    if kind == "subnormals":
        assert not np.array_equal(flushed(lut), lut)
    keys, width = tfet.lut_radix_keys(torch.from_numpy(lut))
    spread = [s for s in range(0, width, 8)
              if len(np.unique(tfet._digits(keys, s, width).numpy())) > 1]
    if kind == "every_digit":
        assert spread == list(range(0, width, 8))
    if kind == "one_key":
        assert spread == []                      # every pass the identity
    if kind == "integers" and prec == "exact":
        assert spread == [40, 48, 56]            # the mantissa's 40 low bits are zero


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_keys_order_like_ieee(dtype):
    """The canonical keys: -0.0 and +0.0 share one, and the keys' order is
    IEEE < on finite values of both signs, subnormals and infinities."""
    rs = np.random.default_rng(4)
    x = np.concatenate([rs.standard_normal(300) * 10.0 ** rs.integers(-30, 30, 300),
                        [0.0, -0.0, 5e-324, -5e-324, 1e-40, np.inf, -np.inf]])
    t = torch.from_numpy(x).to(dtype)
    keys, _ = tfet.lut_radix_keys(t)
    assert int(keys[-7]) == int(keys[-6])
    i, j = np.triu_indices(len(x), 1)
    a, b = t.double().numpy(), keys.numpy()
    assert np.array_equal(a[i] < a[j], b[i] < b[j])
    assert np.array_equal(a[i] == a[j], b[i] == b[j])
