"""K3's bit-plane design (csrc/css_dissim.cu) mirrored in torch
(divergence_tpu_torch.kernels.css: pack_bitplanes_plain,
dissimilarity_bitplanes_plain, gathered_bitplanes_plain) and the
gathered form's plain twin, against the JAX package's counts run on the
CPU: dissimilarity_prefix + dissimilarity_from_prefix (K3) and
dissimilarity_counts (K4).  Counts are integers: every comparison is
exact equality.

The windows cover the funnel shift's edges: first SNPs at lo % 32 in
{0, 1, 31}, window lengths n in {0, 1, 31, 32, 33, 87, 4096} (a tail
mask of 0, 1, 31 bits, whole words, and a window whose words straddle
the last word of the chromosome), m in {2, 21, 64}, and codes with the
missing value -10000 and heterozygotes 0 among the homozygotes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.kernels import css as jcss
from divergence_tpu_torch.kernels import css as tcss

LENGTHS = [0, 1, 31, 32, 33, 87, 4096]
CODES = np.array([3, -3, 0, -10000], dtype=np.int16)


def _codes(rs, shape):
    return rs.choice(CODES, size=shape, p=[0.35, 0.3, 0.25, 0.1])


def _chromosome(m, shift, seed):
    """Codes [N, m] and windows (lo, npos): one window of each length,
    each starting at a multiple of 32 plus ``shift``; the longest ends on
    the chromosome's last SNP."""
    rs = np.random.default_rng(seed)
    N = 4096 + 64 + shift
    vals = _codes(rs, (N, m))
    lo = np.array([32 * (3 * i) + shift for i in range(len(LENGTHS) - 1)]
                  + [N - 4096], dtype=np.int64)
    npos = np.array(LENGTHS, dtype=np.int64)
    assert (lo % 32 == shift).all() and (lo + npos <= N).all() and lo[-1] + npos[-1] == N
    return vals, lo, npos


@pytest.mark.parametrize("shift", [0, 1, 31])
@pytest.mark.parametrize("m", [2, 21, 64])
def test_bitplane_mirror_equals_jax_prefix(m, shift):
    vals, lo, npos = _chromosome(m, shift, seed=m + shift)
    planes = tcss.pack_bitplanes_plain(torch.from_numpy(vals))
    assert planes.shape == (2, (vals.shape[0] + 31) // 32 + 1, m)
    assert int(planes[:, -1].abs().sum()) == 0 and int(planes.max()) < 2**32
    got = tcss.dissimilarity_bitplanes_plain(planes, torch.from_numpy(lo),
                                             torch.from_numpy(npos)).numpy()
    pref = jcss.dissimilarity_prefix(jnp.asarray(vals))
    want = np.asarray(jcss.dissimilarity_from_prefix(pref, jnp.asarray(lo), jnp.asarray(npos)))
    assert np.array_equal(got, want)
    assert got[0].sum() == 0 and got[-1].sum() > 0           # n = 0, n = 4096
    assert (np.diagonal(got, axis1=1, axis2=2) == 0).all()


@pytest.mark.parametrize("shift", [0, 1, 31])
@pytest.mark.parametrize("m", [2, 21, 64])
def test_bitplane_mirror_equals_jax_counts(m, shift):
    """The same windows gathered, against the one-hot product (K4)."""
    vals, lo, npos = _chromosome(m, shift, seed=10 * m + shift)
    P = 4096
    offs = np.arange(P)[None, :]
    mask = offs < npos[:, None]
    g = vals[np.where(mask, lo[:, None] + offs, 0)]
    want = np.asarray(jcss.dissimilarity_counts(jnp.asarray(g), jnp.asarray(mask)))
    planes = tcss.pack_bitplanes_plain(torch.from_numpy(vals))
    got = tcss.dissimilarity_bitplanes_plain(planes, torch.from_numpy(lo),
                                             torch.from_numpy(npos)).numpy()
    assert np.array_equal(got, want)


def test_bitplane_words_hold_the_codes():
    """Bit b of word k of individual i is SNP 32 k + b: hom-major for 3,
    hom-minor for -3, neither for 0 and -10000."""
    vals = torch.tensor([[3, -3], [0, -10000], [-3, 3]] + [[0, 0]] * 30 + [[3, 3]],
                        dtype=torch.int16)
    planes = tcss.pack_bitplanes_plain(vals)
    assert planes.shape == (2, 3, 2)
    assert planes[0, 0].tolist() == [1, 1 << 2] and planes[1, 0].tolist() == [1 << 2, 1]
    assert planes[0, 1].tolist() == [2, 2] and planes[1, 1].tolist() == [0, 0]   # SNP 33
    assert planes[:, 2].abs().sum() == 0


@pytest.mark.parametrize("P", [32, 128])
@pytest.mark.parametrize("asize,bsize", [(1, 1), (11, 10), (5, 4), (32, 32)])
def test_gathered_form_equals_jax_counts(asize, bsize, P):
    """The gathered form from separate a and b codes — the kernel's
    mirror and the plain twin (the CPU path of css_dissim_gathered) —
    against JAX's counts; rows past npos hold codes that must not count."""
    rs = np.random.default_rng(asize * 100 + bsize + P)
    npos = np.array([0, 1, 31, 32, 33, P - 1, P, 7], dtype=np.int64)
    av, bv = _codes(rs, (len(npos), P, asize)), _codes(rs, (len(npos), P, bsize))
    mask = np.arange(P)[None, :] < npos[:, None]
    want = np.asarray(jcss.dissimilarity_counts(
        jnp.asarray(np.concatenate([av, bv], axis=-1)), jnp.asarray(mask)))
    a, b, n = torch.from_numpy(av), torch.from_numpy(bv), torch.from_numpy(npos)
    mirror = tcss.gathered_bitplanes_plain(a, b, n).numpy()
    assert np.array_equal(mirror, want)
    assert np.array_equal(tcss.dissimilarity_gathered_plain(a, b, n).numpy(), want)
    for dt in (torch.float64, torch.float32):
        got = tcss.css_dissim_gathered(a, b, n, dt)
        assert got.dtype == dt and np.array_equal(got.double().numpy(), want)
    assert tcss.LAUNCHES["css_dissim_gathered"] == 0


def test_gathered_twin_batches_alike(monkeypatch):
    """The plain twin's window batches change nothing."""
    rs = np.random.default_rng(5)
    av, bv = torch.from_numpy(_codes(rs, (9, 64, 11))), torch.from_numpy(_codes(rs, (9, 64, 10)))
    npos = torch.from_numpy(rs.integers(0, 65, size=9))
    whole = tcss.dissimilarity_gathered_plain(av, bv, npos)
    monkeypatch.setattr(tcss, "_COUNT_BATCH_ELEMS", 64 * 21 * 2)
    assert torch.equal(tcss.dissimilarity_gathered_plain(av, bv, npos), whole)


@pytest.mark.parametrize("shift", [0, 1, 31])
@pytest.mark.parametrize("m", [65, 129, 200, 209])
def test_rows_mirror_equals_jax_counts(m, shift):
    """The large-panel kernel's counting (``css_dissim_rows``: the words
    in slabs, one popcount of the two opposite-homozygote masks a word)
    at panel sizes past the warp forms, against the one-hot product (K4):
    the 4,096-SNP window takes 16 slabs of 8 words (m = 65 .. 209 all
    stage 8 words a slab; row_slab_words says fewer past m = 256)."""
    vals, lo, npos = _chromosome(m, shift, seed=7 * m + shift)
    assert tcss.row_slab_words(m) == 8
    assert [tcss.row_slab_words(k) for k in (256, 257, 1024, 2048, 2049)] == [8, 7, 2, 1, 1]
    P = 4096
    offs = np.arange(P)[None, :]
    mask = offs < npos[:, None]
    g = vals[np.where(mask, lo[:, None] + offs, 0)]
    want = np.asarray(jcss.dissimilarity_counts(jnp.asarray(g), jnp.asarray(mask)))
    planes = tcss.pack_bitplanes_plain(torch.from_numpy(vals))
    lo_t, npos_t = torch.from_numpy(lo), torch.from_numpy(npos)
    got = tcss.dissimilarity_rows_plain(planes, lo_t, npos_t).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, tcss.dissimilarity_bitplanes_plain(planes, lo_t, npos_t).numpy())
    assert got[0].sum() == 0 and got[-1].sum() > 0
