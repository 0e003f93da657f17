"""Frozen copy of ``divergence_tpu_torch/rng.py`` (threefry-2x32 keys and
uniforms, ``fold_in``, the MC's counter mix, ``chrom_hash``): the streams
the configurations name, worked out again without importing the program.

The functions are the original's text, less those the reference does not
call.  Keys are int64 tensors ``[..., 2]`` of uint32 words.
"""

from __future__ import annotations

import zlib

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


def uniform(key: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), dtype)`` in [0, 1), for a key
    ``[..., 2]`` → ``[..., n]``."""
    if dtype == torch.float32:
        bits = (uniform_bits32(key, n) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        # arithmetic shift, then mask: the sign-extended bits drop out
        b0, b1 = _counter_bits(key, n)
        bits = ((((b0 << 32) | b1) >> 12) & _MANT52) | 0x3FF0000000000000
        return bits.view(torch.float64) - 1.0
    raise TypeError(f"uniform supports float32 and float64, got {dtype}")


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
