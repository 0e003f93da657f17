"""The port's FET rank path (K1r ``fet_snp_ranks`` / ``fet_lut_rank`` and
K2r ``fet_aggregate_ranks``, plain torch on the CPU) against the JAX
package's ``fet_snp_ranks_joint`` and ``fet_aggregate_all_ranks`` run on
the CPU, and against the port's own float path (K1 -> K2).

Tolerances, relative to max(|reference|, 1): exact (float64) 1e-12, fast
(float32) 1e-5, the stddev on at least 99.99 % of windows (a 1-ulp pow
difference can move a ceil(n u) rank).  The rank path equals the float
path bit for bit.

Ranks against JAX's: the rank of a table depends on the whole LUT (every
entry below or tied with it), so one ulp anywhere can move it even where
that table's own score agrees (at 11 + 10 exact, 13,986 of 17,424 entries
of the two LUTs agree bit for bit, and 13,711 of those keep their rank).
The tests therefore hold the two halves apart: the port's sort of JAX's
own LUT gives JAX's lut_sorted and every SNP's rank exactly, and the
port's scores ``lut_sorted[ranks]`` equal JAX's to the FET tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.config import FetConfig as JFetConfig
from divergence_tpu.core.windows import plan_windows
from divergence_tpu.engine import run_fet as jax_run_fet
from divergence_tpu.engine.snp import SnpPair as JSnpPair
from divergence_tpu.kernels import fet as jfet
from divergence_tpu.kernels.perm import chrom_hash
from divergence_tpu_torch import FetConfig, rng
from divergence_tpu_torch.engine import SnpPair, run_fet, run_fet_multi
from divergence_tpu_torch.engine import fet_engine
from divergence_tpu_torch.kernels import fet as tfet
from divergence_tpu_torch.parallel import make_mesh
from test_torch_smacof import one_torch_thread  # noqa: F401 (autouse)

TOL = {"exact": 1e-12, "fast": 1e-5}
STDDEV_BEYOND_SHARE = 1e-4
JDT = {"exact": jnp.float64, "fast": jnp.float32}
BITS = {"exact": np.uint64, "fast": np.uint32}
CPU = torch.device("cpu")


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


def _jax_lut(asize, bsize, prec):
    """The JAX package's LUT as ``fet_snp_ranks_joint`` computes it (jitted)."""
    maxs, nmax = jfet.support_size(asize, bsize), asize + bsize + 2
    grid = jnp.asarray(jfet._table_grid(asize, bsize))
    return np.asarray(jax.jit(lambda g: jfet._neglog10_p(g, maxs, nmax, JDT[prec]))(grid))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lut_rank_is_jax_stable_argsort(dtype):
    """Duplicates and both signed zeros: IEEE < with ties by index, so
    -0.0 and +0.0 stay in index order (JAX's stable argsort)."""
    rs = np.random.default_rng(5)
    lut = rs.choice(np.array([0.0, -0.0, 1.5, 0.25, 3.0, 1e-300]), size=500)
    lut = lut.astype(np.float64 if dtype == torch.float64 else np.float32)
    order = np.asarray(jnp.argsort(jnp.asarray(lut)))
    want_sorted = lut[order]
    want_rank = np.empty(len(lut), np.int32)
    want_rank[order] = np.arange(len(lut), dtype=np.int32)
    got_sorted, got_rank = tfet.fet_lut_rank(torch.from_numpy(lut))
    bits = np.uint64 if dtype == torch.float64 else np.uint32
    assert got_rank.dtype == torch.int32
    assert np.array_equal(got_rank.numpy(), want_rank)
    assert np.array_equal(got_sorted.numpy().view(bits), want_sorted.view(bits))


@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize", [(3, 2), (11, 10), (15, 15)])
def test_rank_step_on_jax_lut_gives_jax_ranks(prec, asize, bsize):
    """The state carried across: the port's sort of the JAX package's LUT
    reproduces JAX's lut_sorted bit for bit and every SNP's rank exactly
    (15 + 15: G = 2^16, the largest LUT whose indices fit 16 bits)."""
    rs = np.random.default_rng(6)
    vals = _codes(rs, (3000, asize + bsize))
    maxs, nmax = jfet.support_size(asize, bsize), asize + bsize + 2
    jls, jranks = jfet.fet_snp_ranks_joint(
        jnp.asarray(vals), asize, maxs, nmax, fast=prec == "fast"
    )
    lut_sorted, rank_of_entry = tfet.fet_lut_rank(torch.from_numpy(_jax_lut(asize, bsize, prec).copy()))
    tables = tfet.count_tables(torch.from_numpy(vals[:, :asize]), torch.from_numpy(vals[:, asize:]))
    ranks = rank_of_entry[tfet._lut_index(tables, asize, bsize)]
    bits = BITS[prec]
    assert np.array_equal(lut_sorted.numpy().view(bits), np.asarray(jls).view(bits))
    assert np.array_equal(ranks.numpy(), np.asarray(jranks))


@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize", [(3, 2), (11, 10)])
def test_snp_ranks_matches_jax(prec, asize, bsize):
    """The port's own LUT and ranks: the SNPs' scores lut_sorted[ranks]
    equal JAX's fet_snp_logs_joint (and JAX's lut_sorted[ranks]) to the FET
    tolerances; where the two LUTs agree on every entry (3 + 2 fast), the
    ranks are JAX's exactly."""
    rs = np.random.default_rng(7)
    vals = _codes(rs, (3000, asize + bsize))
    maxs, nmax = jfet.support_size(asize, bsize), asize + bsize + 2
    fast = prec == "fast"
    lut_sorted, ranks = tfet.fet_snp_ranks(torch.from_numpy(vals), asize, maxs, nmax, fast)
    G = (asize + 1) ** 2 * (bsize + 1) ** 2
    assert lut_sorted.shape == (G,) and ranks.dtype == torch.int32
    assert lut_sorted.dtype == (torch.float32 if fast else torch.float64)
    assert bool((lut_sorted[1:] >= lut_sorted[:-1]).all())
    scores = lut_sorted[ranks].numpy()
    assert_close(scores, jfet.fet_snp_logs_joint(jnp.asarray(vals), asize, maxs, nmax, fast=fast),
                 TOL[prec])
    jls, jranks = jfet.fet_snp_ranks_joint(jnp.asarray(vals), asize, maxs, nmax, fast=fast)
    assert_close(scores, np.asarray(jls)[np.asarray(jranks)], TOL[prec])
    # the same scores as the port's float path, bit for bit
    assert torch.equal(lut_sorted[ranks], tfet.fet_snp_logs(torch.from_numpy(vals), asize, maxs,
                                                            nmax, fast))
    bits = BITS[prec]
    port_lut = tfet.fet_lut(asize, bsize, maxs, nmax, lut_sorted.dtype, CPU).numpy()
    if np.array_equal(port_lut.view(bits), _jax_lut(asize, bsize, prec).view(bits)):
        assert np.array_equal(ranks.numpy(), np.asarray(jranks))


def _rows(rs, N, B, P):
    lo = rs.integers(0, N - P, size=B)
    npos = rs.integers(1, P + 1, size=B)
    npos[::7] = 0                                 # empty windows
    slot = rs.permutation(np.arange(50, 50 + B))
    return (torch.from_numpy(a.astype(np.int64)) for a in (lo, npos, slot))


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("asize,bsize", [(3, 2), (11, 10)])
def test_rank_path_bit_equal_to_float_path(fast, asize, bsize):
    """fet_snp_ranks -> fet_aggregate_ranks == fet_snp_logs ->
    fet_aggregate bit for bit, both precisions, with empty windows
    (tests/test_fet_kernel.py::test_rank_path_bit_identical)."""
    rs = np.random.default_rng(8)
    G = (asize + 1) ** 2 * (bsize + 1) ** 2
    N = min(4 * G, 20_000)
    vals = torch.from_numpy(_codes(rs, (N, asize + bsize)))
    maxs, nmax = tfet.support_size(asize, bsize), asize + bsize + 2
    lo, npos, slot = _rows(rs, N, 40, 32)
    key = rng.prng_key(3)
    lut_sorted, ranks = tfet.fet_snp_ranks(vals, asize, maxs, nmax, fast)
    got = tfet.fet_aggregate_ranks(lut_sorted, ranks, lo, npos, slot, key, 0.95, 50)
    logs = tfet.fet_snp_logs(vals, asize, maxs, nmax, fast)
    want = tfet.fet_aggregate(logs, lo, npos, slot, key, 0.95, 50)
    assert got.dtype == want.dtype and got.shape == (2, 40)
    assert (npos == 0).any() and (want[1] > 0).sum() > 10
    assert torch.equal(got, want)


def _window_rows(positions, regend):
    plan = plan_windows(positions, regend, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    return np.stack([plan.lo[ids], plan.npos[ids], plan.slot[ids]])


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_aggregate_ranks_matches_jax(panel, prec):
    """K2r's plain version fed JAX's own (lut_sorted, ranks) reproduces
    JAX's fet_aggregate_all_ranks; fed the port's, it meets the FET
    tolerances too."""
    _, _, _, _, positions, amat, bmat = panel
    vals = np.concatenate([amat, bmat], axis=1)
    asize, bsize = amat.shape[1], bmat.shape[1]
    maxs, nmax = jfet.support_size(asize, bsize), asize + bsize + 2
    fast = prec == "fast"
    jls, jranks = jfet.fet_snp_ranks_joint(jnp.asarray(vals), asize, maxs, nmax, fast=fast)
    rows = _window_rows(positions, 20_000)
    P = tfet._window_pad(int(rows[1].max()))
    key = jax.random.fold_in(jax.random.PRNGKey(11), chrom_hash("chrIV"))
    want = np.asarray(jfet.fet_aggregate_all_ranks(
        jls, jranks, jnp.asarray(rows), key, Bp=rows.shape[1], P=P, perc=0.95,
        nsamples=100, fast=fast,
    ))
    tkey = rng.fold_in(rng.prng_key(11), rng.chrom_hash("chrIV"))
    lo, npos, slot = (torch.from_numpy(r.copy()) for r in rows)
    from_jax = tfet.fet_aggregate_ranks(
        torch.from_numpy(np.array(jls)), torch.from_numpy(np.array(jranks)), lo, npos, slot,
        tkey, 0.95, 100,
    )
    lut_sorted, ranks = tfet.fet_snp_ranks(torch.from_numpy(vals), asize, maxs, nmax, fast)
    own = tfet.fet_aggregate_ranks(lut_sorted, ranks, lo, npos, slot, tkey, 0.95, 100)
    assert (want[1] > 0).sum() > rows.shape[1] // 2
    for got in (from_jax, own):
        assert_close(got[0].numpy(), want[0], TOL[prec])
        err = np.abs(got[1].numpy() - want[1]) / np.maximum(np.abs(want[1]), 1.0)
        assert (err > TOL[prec]).sum() <= STDDEV_BEYOND_SHARE * len(err) + (prec == "fast")


@pytest.fixture
def spy(monkeypatch):
    """Counts the plain aggregates the engine reaches (on the CPU the
    wrappers run them)."""
    calls = {"ranks": 0, "floats": 0, "snp_ranks": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tfet, "fet_aggregate_ranks_plain",
                        count("ranks", tfet.fet_aggregate_ranks_plain))
    monkeypatch.setattr(tfet, "fet_aggregate_plain", count("floats", tfet.fet_aggregate_plain))
    monkeypatch.setattr(tfet, "fet_snp_ranks_plain",
                        count("snp_ranks", tfet.fet_snp_ranks_plain))
    return calls


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_fet_routes_exact_mode_through_ranks(panel, spy, prec):
    """Exact mode in the LUT regime takes K1r -> K2r, fast mode K1 -> K2
    (the JAX engine's use_ranks); either way run_fet equals JAX's."""
    _, _, _, _, positions, amat, bmat = panel
    cfg = FetConfig(precision=prec, seed=3)
    s, d = run_fet(SnpPair(positions, amat, bmat), 20_000, cfg, device="cpu", seqid="chrT")
    js, jd = jax_run_fet(JSnpPair(positions, amat, bmat), 20_000,
                         JFetConfig(precision=prec, seed=3), seqid="chrT")
    ranked = prec == "exact"
    assert fet_engine.use_ranks(cfg, SnpPair(positions, amat, bmat)) == ranked
    assert (spy["ranks"], spy["floats"]) == ((1, 0) if ranked else (0, 1))
    assert (d > 0).sum() > 10
    assert_close(s, js, TOL[prec])
    assert_close(d, jd, TOL[prec])


def test_no_lut_panel_keeps_the_float_path(spy):
    """48 + 48 has no LUT: exact mode takes K1 -> K2, as the JAX engine."""
    from divergence_tpu_torch.tools.synth import make_panel

    pos, am, bm = make_panel(200, 10_000, 48, 48, seed=2)
    pair = SnpPair(pos, am, bm)
    assert not fet_engine.use_ranks(FetConfig(), pair)
    run_fet(pair, 10_000, FetConfig(), device="cpu")
    assert (spy["ranks"], spy["floats"]) == (0, 1)
    with pytest.raises(ValueError, match="LUT"):
        tfet.fet_snp_ranks(torch.zeros((4, 96), dtype=torch.int16), 48, 50, 98)


def test_rank_path_over_a_mesh_and_a_slot_split(panel, spy):
    """Four shares of one CPU run K1r once and K2r per share, and a
    slot-range split gives the unsplit run's values, bit for bit."""
    _, _, _, _, positions, amat, bmat = panel
    pair = SnpPair(positions, amat, bmat)
    cfg = FetConfig(precision="exact")
    ref = run_fet(pair, 20_000, cfg, device="cpu", seqid="c")
    spy.update(ranks=0, snp_ranks=0)
    got = run_fet(pair, 20_000, cfg, sharding=make_mesh(devices=[CPU] * 4), seqid="c")
    assert (spy["snp_ranks"], spy["ranks"]) == (1, 4)
    cut = 17   # of 40 slots
    lo = run_fet(pair.slice_span(0, (cut - 1) * 500 + 2500), 20_000, cfg, device="cpu",
                 seqid="c", slot_range=(0, cut))
    hi = run_fet(pair.slice_span(cut * 500, 39 * 500 + 2500), 20_000, cfg, device="cpu",
                 seqid="c", slot_range=(cut, 1 << 62))
    multi = run_fet_multi({"c": (pair, 20_000)}, cfg, sharding=make_mesh(devices=[CPU] * 3))
    for i in range(2):
        assert np.array_equal(got[i], ref[i])
        assert np.array_equal(lo[i] + hi[i], ref[i])
        assert np.array_equal(multi["c"][i], ref[i])
    assert spy["floats"] == 0


def test_rank_wrappers_refuse_other_devices():
    meta = torch.zeros((4, 21), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfet.fet_snp_ranks(meta, 11, 12, 23)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfet.fet_lut_rank(torch.zeros(8, dtype=torch.float64, device="meta"))
    idx = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfet.fet_aggregate_ranks(torch.zeros(8, dtype=torch.float64), meta[:, 0].int(), idx,
                                 idx + 1, idx, rng.prng_key(0), 0.95, 10)
