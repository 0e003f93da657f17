"""The port's threefry replica (divergence_tpu_torch.rng) is bit-equal to
jax.random: keys, fold_in, slot keys, raw bits and float32/float64
uniforms, over several seeds, slots and shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from divergence_tpu.kernels import perm as kperm
from divergence_tpu_torch import rng

SEEDS = [0, 1, 42, 987654321, 2**32 + 7]
FOLD_DATA = [0, 1, 7, 255, 123456, 2**31 - 1, 2**32 - 1]


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _bits_of(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    assert np.array_equal(rng.prng_key(seed).numpy(), _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_scalar(seed):
    key = jax.random.PRNGKey(seed)
    tkey = rng.prng_key(seed)
    for d in FOLD_DATA:
        want = _words(jax.random.fold_in(key, d))
        assert np.array_equal(rng.fold_in(tkey, d).numpy(), want), d


def test_fold_in_tensor_data_and_key_words():
    key = jax.random.fold_in(jax.random.PRNGKey(3), 99)
    tkey = rng.key_from_words(np.asarray(jax.random.key_data(key)))
    data = np.array([0, 5, 77, 2**31 + 3, 4000000000], dtype=np.int64)
    got = rng.fold_in(tkey, torch.from_numpy(data)).numpy()
    want = np.stack([_words(jax.random.fold_in(key, int(d))) for d in data])
    assert np.array_equal(got, want)


def test_chrom_hash():
    for s in ["chrI", "chrXXI", "_", "scaffold_1234", "chrUn"]:
        assert rng.chrom_hash(s) == kperm.chrom_hash(s)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_slot_keys(seed):
    ck = jax.random.fold_in(jax.random.PRNGKey(seed), kperm.chrom_hash("chrVII"))
    slots = np.array([0, 1, 40, 123456, 799999, 2**31 - 1], dtype=np.int64)
    want = np.asarray(jax.random.key_data(kperm.slot_keys(ck, jnp.asarray(slots))))
    tck = rng.fold_in(rng.prng_key(seed), rng.chrom_hash("chrVII"))
    got = rng.slot_keys(tck, torch.from_numpy(slots)).numpy()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("n", [1, 2, 33, 100])
def test_raw_bits(seed, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    tkey = rng.key_from_words(np.asarray(jax.random.key_data(key)))
    b32 = np.asarray(jax.random.bits(key, (n,), jnp.uint32))
    b64 = np.asarray(jax.random.bits(key, (n,), jnp.uint64))
    assert np.array_equal(rng.uniform_bits32(tkey, n).numpy(), b32.astype(np.int64))
    assert np.array_equal(rng.uniform_bits64(tkey, n).numpy().view(np.uint64), b64)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 2, 100, 1001])
def test_uniform_bootstrap_chain_bit_equal(dtype, n):
    """The bootstrap's exact draw chain:
    uniform(fold_in(fold_in(fold_in(PRNGKey(seed), chrom), slot), j), (n,))."""
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    for seed in (0, 5):
        ck = jax.random.fold_in(jax.random.PRNGKey(seed), kperm.chrom_hash("chrII"))
        tck = rng.fold_in(rng.prng_key(seed), rng.chrom_hash("chrII"))
        for slot in (0, 17, 50000):
            wk = jax.random.fold_in(ck, slot)
            twk = rng.fold_in(tck, slot)
            for j in (0, 1, 9):
                want = np.asarray(
                    jax.random.uniform(jax.random.fold_in(wk, j), (n,), dtype=jdt)
                )
                got = rng.uniform(rng.fold_in(twk, j), n, tdt).numpy()
                assert got.dtype == want.dtype
                assert np.array_equal(_bits_of(got), _bits_of(want)), (seed, slot, j)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_batched_keys(dtype):
    """A [B, 2] key batch draws [B, n], row b equal to the JAX draw of key b."""
    ck = jax.random.fold_in(jax.random.PRNGKey(8), 1234)
    slots = np.arange(0, 700, 37, dtype=np.int64)
    wkeys = kperm.slot_keys(ck, jnp.asarray(slots))
    want = np.asarray(
        jax.vmap(lambda k: jax.random.uniform(k, (100,), dtype=jnp.dtype(dtype)))(wkeys)
    )
    tck = rng.key_from_words(np.asarray(jax.random.key_data(ck)))
    got = rng.uniform(rng.slot_keys(tck, torch.from_numpy(slots)), 100, getattr(torch, dtype))
    assert got.shape == (len(slots), 100)
    assert np.array_equal(_bits_of(got.numpy()), _bits_of(want))


def test_uniform_range_and_type_check():
    u = rng.uniform(rng.prng_key(0), 5000, torch.float32)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    with pytest.raises(TypeError):
        rng.uniform(rng.prng_key(0), 4, torch.float16)


def test_mix32_bit_equal(rng):
    """The MC's counter mix (perm.py:_mix32) on uint32 words held in
    int64, over random words and the extremes."""
    x = rng.integers(0, 2**32, 20_000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 2**31, 2**32 - 1]
    want = np.asarray(kperm._mix32(jnp.asarray(x))).astype(np.int64)
    assert np.array_equal(rng_mix32(x), want)


def rng_mix32(x: np.ndarray) -> np.ndarray:
    return rng.mix32(torch.from_numpy(x.astype(np.int64))).numpy()


@pytest.mark.parametrize("chunk,m", [(256, 21), (16, 9), (7, 4)])
def test_mix_bits_bit_equal(chunk, m):
    """``mix_bits(key, chunk*m)`` is perm.py:_mix_bits flattened, for a
    batch of keys, including the shared stream's fold_in(fold_in(
    PRNGKey(seed), 2), k) chain."""
    mc_key = jax.random.fold_in(jax.random.PRNGKey(11), 2)
    keys = jnp.stack([jax.random.fold_in(mc_key, k) for k in (0, 1, 781)])
    want = np.asarray(kperm._mix_bits(keys, chunk, m)).reshape(3, -1)
    tmc = rng.fold_in(rng.prng_key(11), 2)
    tkeys = torch.stack([rng.fold_in(tmc, k) for k in (0, 1, 781)])
    assert np.array_equal(
        tkeys.numpy(), np.asarray(jax.random.key_data(keys)).astype(np.int64)
    )
    got = rng.mix_bits(tkeys, chunk * m).numpy()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n_init,m", [(4, 21), (4, 2), (1, 9), (6, 64)])
def test_smacof_inits_bit_equal(dtype, n_init, m):
    """The SMACOF restarts' starting configurations (css.py:smacof_runs):
    uniform(fold_in(fold_in(PRNGKey(seed), chrom), slot), (n_init, m, 2))
    under vmap, bit for bit."""
    ck = jax.random.fold_in(jax.random.PRNGKey(7), kperm.chrom_hash("chr2L"))
    slots = np.array([0, 3, 999, 123456, 2**31 - 1], dtype=np.int64)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (n_init, m, 2), dtype=jnp.dtype(dtype))
    )(kperm.slot_keys(ck, jnp.asarray(slots))))
    tck = rng.fold_in(rng.prng_key(7), rng.chrom_hash("chr2L"))
    got = rng.smacof_inits(rng.slot_keys(tck, torch.from_numpy(slots)), n_init, m,
                           getattr(torch, dtype)).numpy()
    assert got.shape == (len(slots), n_init, m, 2) and got.dtype == want.dtype
    assert np.array_equal(_bits_of(got), _bits_of(want))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_window_keys_bit_equal(seed):
    """perm.py:window_keys: fold_in(fold_in(key, chrom), slot), the
    chromosome first, on the MC key fold_in(PRNGKey(seed), 2)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
    tkey = rng.fold_in(rng.prng_key(seed), 2)
    chroms = np.array([kperm.chrom_hash(s) for s in ("chrI", "chrXXI", "_", "2L")] * 2,
                      dtype=np.int64)
    slots = np.array([0, 1, 40, 123456, 799999, 2**31 - 1, 5, 2**32 - 1], dtype=np.int64)
    want = np.asarray(jax.random.key_data(
        kperm.window_keys(key, jnp.asarray(chroms), jnp.asarray(slots))))
    got = rng.window_keys(tkey, chroms, slots)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    swapped = rng.window_keys(tkey, slots, chroms).numpy()
    assert not np.array_equal(swapped, got.numpy())


def test_fold_chunk_bit_equal():
    """perm.py:_fold_chunk: the chunk key fold_in(wkey, k) of every window."""
    key = jax.random.fold_in(jax.random.PRNGKey(9), 2)
    chroms = np.full(5, kperm.chrom_hash("chrIV"), dtype=np.int64)
    slots = np.arange(100, 105, dtype=np.int64)
    jk = kperm.window_keys(key, jnp.asarray(chroms), jnp.asarray(slots))
    tk = rng.window_keys(rng.fold_in(rng.prng_key(9), 2), chroms, slots)
    for k in (0, 1, 781, 2**20):
        want = np.asarray(jax.random.key_data(kperm._fold_chunk(jk, k))).astype(np.int64)
        assert np.array_equal(rng.fold_in(tk, k).numpy(), want), k


def test_threefry_permutation_draws_bit_equal_with_ties():
    """The threefry MC draws jax.random.uniform(fold_in(wkey, k), (chunk, m),
    float32) under vmap: element (K, j) is flat draw K*m + j.  At m = 64
    over 3 x 4096 permutations some permutations hold tied draws."""
    chunk, m = 4096, 64
    key = jax.random.fold_in(jax.random.PRNGKey(1), 2)
    chroms = np.zeros(3, dtype=np.int64)
    slots = np.array([7, 8, 2**31 - 1], dtype=np.int64)
    jk = kperm._fold_chunk(kperm.window_keys(key, jnp.asarray(chroms), jnp.asarray(slots)), 5)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (chunk, m), dtype=jnp.float32))(jk))
    tk = rng.fold_in(rng.window_keys(rng.fold_in(rng.prng_key(1), 2), chroms, slots), 5)
    got = rng.uniform(tk, chunk * m, torch.float32).reshape(3, chunk, m).numpy()
    assert np.array_equal(_bits_of(got), _bits_of(want))
    tied = (np.diff(np.sort(got, axis=-1), axis=-1) == 0).any(axis=-1)
    assert int(tied.sum()) > 0
