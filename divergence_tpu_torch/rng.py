"""Threefry-2x32 replica of ``jax.random`` — bit-equal keys and uniforms.

The JAX package derives every random stream as a pure function of
(seed, chromosome, window slot, step):
``uniform(fold_in(fold_in(fold_in(PRNGKey(seed), chrom_hash(seqid)), slot), j),
(nsamples,), dtype)`` (``divergence_tpu/kernels/fet.py:_order_stat_uniforms``,
``divergence_tpu/kernels/perm.py:slot_keys``).  A ``torch.Generator``
would give other numbers, so this module reproduces JAX's generator word
for word, with ``jax_threefry_partitionable`` on (the JAX default):

* ``PRNGKey(seed)`` = the 64-bit seed split into ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``fold_in(key, d)`` = ``threefry2x32(key, (0, d))``;
* ``uniform(key, (n,))`` draws element ``i`` from ``(b0, b1) =
  threefry2x32(key, (0, i))``: float32 takes ``b0 ^ b1``, float64 takes
  ``b0 << 32 | b1``; the top mantissa bits under exponent 0 give a float
  in [1, 2), minus 1.  A multi-dimensional draw counts its elements by
  flat index.

The per-window MC streams are ``fold_in(fold_in(fold_in(PRNGKey(seed), 2),
chrom_hash(seqid)), slot)`` (:func:`window_keys`), chunk ``k`` of a window
``fold_in(wkey, k)``.

The CSS Monte-Carlo expands a chunk key into many words with a cheaper
counter mix instead (``divergence_tpu/kernels/perm.py:_mix_bits``):
word ``c`` is ``mix32(mix32(k0 ^ c) + k1)``, see :func:`mix_bits`.

Keys are int64 tensors of shape ``[..., 2]`` holding uint32 words (torch's
CPU ``uint32`` lacks shifts and xor in places); every word op masks to
32 bits.  ``csrc/threefry.cuh`` is the device-side twin.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_MANT52 = (1 << 52) - 1
_MIX_MULS = (0x7FEB352D, 0x846CA68B)


def chrom_hash(seqid: str) -> int:
    """Stable 31-bit chromosome identifier for RNG stream derivation
    (``divergence_tpu/kernels/perm.py:chrom_hash``)."""
    return zlib.crc32(seqid.encode()) & 0x7FFFFFFF


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, on int64 tensors of uint32 words
    (broadcasting).  The key schedule and rotations of
    ``jax/_src/prng.py:_threefry2x32_lowering``."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (64-bit seed, as under x64) as a
    ``[2]`` int64 tensor of uint32 words."""
    s = int(seed) % (1 << 64)
    return torch.tensor([s >> 32, s & MASK32], dtype=torch.int64, device=device)


def key_from_words(words: np.ndarray, device: str | torch.device = "cpu") -> torch.Tensor:
    """A key from its uint32 words (e.g. ``jax.random.key_data(key)``)."""
    w = np.asarray(words, dtype=np.uint32).astype(np.int64)
    return torch.from_numpy(w).to(device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``key`` ``[..., 2]``, ``data`` an int or an
    integer tensor broadcasting against ``key[..., 0]`` (taken mod 2**32,
    as JAX's cast to uint32)."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data) & MASK32, dtype=torch.int64, device=key.device)
    data = data.to(torch.int64) & MASK32
    zero = torch.zeros_like(data)
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], zero, data)
    return torch.stack([b0, b1], dim=-1)


def slot_keys(key: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Per-window keys ``[B, 2]`` from a chromosome key:
    ``fold_in(key, slot)`` (``divergence_tpu/kernels/perm.py:slot_keys``)."""
    return fold_in(key, slots)


def window_keys(key: torch.Tensor, chroms, slots) -> torch.Tensor:
    """Per-window MC keys ``[B, 2]`` from the run-level MC key:
    ``fold_in(fold_in(key, chrom), slot)`` elementwise, the chromosome
    first (``divergence_tpu/kernels/perm.py:window_keys``).  ``chroms``
    and ``slots`` are integer arrays or tensors of length B."""
    chroms = torch.as_tensor(np.asarray(chroms, dtype=np.int64)).to(key.device)
    slots = torch.as_tensor(np.asarray(slots, dtype=np.int64)).to(key.device)
    return fold_in(fold_in(key, chroms), slots)


def _counter_bits(key: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``threefry2x32(key, (0, i))`` for i < n: two ``[..., n]`` words."""
    ctr = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(
        key[..., 0:1], key[..., 1:2], torch.zeros_like(ctr), ctr
    )


def uniform_bits32(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as int64 ``[..., n]``."""
    b0, b1 = _counter_bits(key, n)
    return b0 ^ b1


def uniform_bits64(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint64)`` as int64 ``[..., n]`` holding
    the uint64 bit pattern (values >= 2**63 read as negative)."""
    b0, b1 = _counter_bits(key, n)
    return (b0 << 32) | b1


def uniform(key: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), dtype)`` in [0, 1), for a key
    ``[..., 2]`` → ``[..., n]``."""
    if dtype == torch.float32:
        bits = (uniform_bits32(key, n) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        # arithmetic shift, then mask: the sign-extended bits drop out
        bits = ((uniform_bits64(key, n) >> 12) & _MANT52) | 0x3FF0000000000000
        return bits.view(torch.float64) - 1.0
    raise TypeError(f"uniform supports float32 and float64, got {dtype}")


def smacof_inits(wkeys: torch.Tensor, n_init: int, m: int, dtype: torch.dtype) -> torch.Tensor:
    """The SMACOF restarts' uniform starting configurations, ``[B, n_init,
    m, 2]`` from per-window keys ``[B, 2]``:
    ``jax.random.uniform(wkey, (n_init, m, 2), dtype)`` under ``vmap``
    (``divergence_tpu/kernels/css.py:smacof_runs``).  The partitionable
    layout counts a multi-dimensional draw by its flat index, so element
    ``(i, j, c)`` is flat draw ``(i*m + j)*2 + c``."""
    return uniform(wkeys, n_init * m * 2, dtype).reshape(-1, n_init, m, 2)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for uint32 words in int64, without int64
    overflow: the high half of ``c`` only reaches the low 32 bits
    through the low 16 bits of its partial product."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche (murmur3-style finaliser, Prospector constants),
    ``divergence_tpu/kernels/perm.py:_mix32``, on int64 tensors of
    uint32 words."""
    x = _mul32(x ^ (x >> 16), _MIX_MULS[0])
    x = _mul32(x ^ (x >> 15), _MIX_MULS[1])
    return x ^ (x >> 16)


def mix_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` counter-expanded words of a key ``[..., 2]``:
    ``mix32(mix32(k0 ^ c) + k1)`` for ``c < n``, as int64 ``[..., n]``
    (``divergence_tpu/kernels/perm.py:_mix_bits`` before its reshape to
    ``[chunk, m]``)."""
    ctr = torch.arange(n, dtype=torch.int64, device=key.device)
    h = mix32(key[..., 0:1] ^ ctr)
    return mix32((h + key[..., 1:2]) & MASK32)
