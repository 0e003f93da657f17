"""The port's permutation Monte-Carlo past 64 individuals and its FET on
wide windows, on the CPU, against the JAX package: the paths whose card
kernels take a large-panel form (K8 ``css_mc_window_block``, K11
``css_perm_chunk_block``, K9 ``css_mc_power_window_block``) and a wide
form (K2 / K2r / K10 ``*_wide``) hold their plain versions, and these
are what the tests below hold to JAX at today's resequencing panel sizes
(70 + 58, 110 + 90, and 150 + 150 for K11) and at windows of ~5,000 and
~20,000 SNPs.  (The kernels against the plain versions, and where each
wrapper switches forms: tests/test_torch_kernels_gpu.py.)

Tolerances: the window stream's and K11's (p, n, hits) / (hits,
reached, pos) equal on every window but float32 near ties, each shown to
be one by rescoring the window's permutations in float64 (TIE_RTOL, as in
tests/test_torch_mc.py; the permutations are bit-equal, the float32 sums
run in another order than XLA's); the native form equal to
``divergence_tpu.native.mc_native`` on every window.  Approx mode: the
power sums within LARGE_POWER_BAND of JAX's and |log10 p| within
LARGE_LOG10_P_BAND where nscores agree, bands measured on these panels
before they were written down (the sums of m^2 float32 terms a score
drift with m: see the constants).  FET exact 1e-12, fast 1e-5 (stddev
beyond them on at most one window: a ceil(n u) rank flip from an ulp of
pow).  The step at 70 + 58: FET 1e-12, CSS 1e-9 on the eigengap windows,
MC hits equal but on near ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu import native
from divergence_tpu.config import FetConfig as JFetConfig
from divergence_tpu.config import WindowConfig as JWindowConfig
from divergence_tpu.engine import run_fet as jax_run_fet
from divergence_tpu.engine.snp import SnpPair as JSnpPair
from divergence_tpu.kernels import fet as jfet
from divergence_tpu.kernels import perm as jperm
from divergence_tpu.parallel import make_divergence_step as jax_step
from divergence_tpu.parallel import make_mesh as jax_mesh
from divergence_tpu.parallel import window_sharding
from divergence_tpu_torch import rng
from divergence_tpu_torch.config import FetConfig, WindowConfig
from divergence_tpu_torch.core.windows import plan_windows
from divergence_tpu_torch.engine import SnpPair, run_fet
from divergence_tpu_torch.kernels import css as tcss
from divergence_tpu_torch.kernels import fet as tfet
from divergence_tpu_torch.kernels import perm as tperm
from divergence_tpu_torch.parallel import make_divergence_step, make_mesh
from divergence_tpu_torch.tools.synth import make_chromosome
from test_torch_css import EXACT_TOL, GAP_BOUND, eigengap
from test_torch_large_panels import REGEND, WSIZE, WSTEP, _panel
from test_torch_mc import TIE_RTOL
from test_torch_parallel import _batch, _near_ties
from test_torch_smacof import one_torch_thread  # noqa: F401 (autouse)

PANELS = [(70, 58), (110, 90)]
CHUNK_M = {65: (33, 32), 128: (70, 58), 200: (110, 90), 300: (150, 150)}
TOL = {"exact": 1e-12, "fast": 1e-5}
# approx mode at m = 128 and 200: the port's plain power sums against
# JAX's _null_power_sums (both draw streams, chunks 3 and 4 of 256, on
# _power_case's four windows a panel), each sum's error against its
# magnitude (power_err), measured at most LARGE_POWER_MEASURED by stream
# over both panels (the window stream's as its relative error before) and
# held to twice that rounded up (the window stream's earlier band, the
# reading rounded up to the next power of ten, kept); |log10 p| of
# approx_significance (chunk 256, one escalation round) where nscores
# agree, keyed by the largest m it covers, at most LARGE_LOG10_P_MEASURED
# on windows whose log10 p lies between -33 and -68, held to the reading
# rounded up to the next power of ten
LARGE_POWER_MEASURED = {"shared": 9.88e-8, "window": 4.17e-6}
LARGE_POWER_BAND = {"shared": 2e-7, "window": 1e-5}
LARGE_LOG10_P_MEASURED = {128: 1.33e-3, 200: 3.17e-3}
LARGE_LOG10_P_BAND = {128: 1e-2, 200: 1e-2}


def power_err(got: np.ndarray, want: np.ndarray, n: int) -> float:
    """Largest |got - want| of [chunks, 3, B] power sums of n scores
    against n rms^q (rms^2 = want[:, 1] / n): each sum's error against its
    magnitude, which a sum near zero cannot inflate."""
    rms = np.sqrt(want[:, 1:2] / n)
    q = np.arange(1, 4)[None, :, None]
    return float((np.abs(got - want) / (n * rms**q)).max())


def band(table: dict, m: int) -> float:
    return table[min(k for k in table if k >= m)]


def _keys(seed):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), 2),
            rng.fold_in(rng.prng_key(seed), 2))


def _phase1(asize, bsize, seed, limit):
    """(dist [B, m, m] float64, observed scores, chroms, slots) of at most
    ``limit`` valid windows of tests/test_torch_large_panels.py's panel."""
    positions, amat, bmat = _panel(seed, asize, bsize, 120)
    plan = plan_windows(positions, REGEND, WSIZE, WSTEP)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    s, d, v = tcss.css_phase1(torch.from_numpy(np.concatenate([amat, bmat], axis=1)),
                              plan.lo[ids], plan.npos[ids], asize, bsize)
    vn = v.numpy()
    idx = np.nonzero(vn)[0][:limit]
    chroms = np.full(len(idx), rng.chrom_hash("chrL"), dtype=np.int64)
    return d[idx], s.numpy()[idx], chroms, plan.slot[ids][idx]


def _mixed_scores(dist, scores, keys, asize, bsize):
    """The observed scores with every other window's replaced by the 80th
    percentile of 64 of its own permuted scores: those windows stop early
    (p ~ 0.2), the others run on."""
    null = tperm._perm_scores(dist.float(), rng.fold_in(keys, 999), asize, bsize, 64)
    q = torch.quantile(null.double(), 0.8, dim=1).numpy()
    out = scores.copy()
    out[::2] = q[::2]
    return out


def _stream_near_tie(dist, obs, wkey, asize, bsize, chunk, nchunks, bitgen):
    """The smallest |s64 - obs| / max(|obs|, 1) over the first nchunks
    chunks of one window's stream, s64 its permuted scores in float64."""
    m = asize + bsize
    best = np.inf
    o = float(np.float32(obs))
    for k in range(nchunks):
        r = tperm._ranks(rng.fold_in(wkey[None], k), chunk, m, bitgen)[0]
        C = tperm._rank_coeff(r, asize, bsize).double()
        s64 = (dist.double().float().double()[..., None] * C).sum(dim=(0, 1))
        best = min(best, float((s64 - o).abs().min()) / max(abs(o), 1.0))
    return best


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("asize,bsize", PANELS)
def test_window_stream_large_panel_matches_jax(asize, bsize, bitgen):
    """significance(stream="window") at m = 128 and 200 (K8's large-panel
    form on the card): windows that stop at their 10th hit and windows
    that run to the cap."""
    dist, scores, chroms, slots = _phase1(asize, bsize, 31 + asize, 6)
    jkey, tkey = _keys(3)
    wkeys = rng.window_keys(tkey, chroms, slots)
    scores = _mixed_scores(dist, scores, wkeys, asize, bsize)
    runs, chunk = 512, 128
    kw = dict(chunk=chunk, chroms=chroms, slots=slots, stream="window", bitgen=bitgen)
    want = jperm.significance(np.asarray(dist), scores, asize, bsize, 10, runs, jkey, **kw)
    got = tperm.significance(dist, scores, asize, bsize, 10, runs, tkey, **kw)
    assert (got.nscores < runs).any() and (got.nscores == runs).any()
    differ = np.nonzero((got.nscores != want.nscores) | (got.hits != want.hits))[0]
    for w in differ:
        n = max(got.nscores[w], want.nscores[w])
        gap = _stream_near_tie(dist[w], scores[w], wkeys[w], asize, bsize, chunk,
                               -(-n // chunk), bitgen)
        assert gap <= TIE_RTOL, (w, gap)
    same = np.setdiff1d(np.arange(len(scores)), differ)
    assert np.array_equal(got.pvals[same], want.pvals[same])
    assert len(differ) <= 1


needs_native = pytest.mark.skipif(
    not native.native_available(), reason="the JAX package's native toolchain is unavailable"
)


@needs_native
def test_native_large_panel_equals_mc_native():
    """perm_backend="native" at 70 + 58 (K8's float64 large-panel form on
    the card): (p, n, hits) equal to native/mc_native.cpp on every window."""
    dist, scores, chroms, slots = _phase1(70, 58, 41, 6)
    _, tkey = _keys(4)
    wkeys = rng.window_keys(tkey, chroms, slots)
    scores = _mixed_scores(dist, scores, wkeys, 70, 58)
    want = native.mc_native(dist.numpy(), scores, wkeys.numpy().astype(np.uint32), 70, 128,
                            512, 10)
    got = tperm.significance(dist, scores, 70, 58, 10, 512, tkey, chunk=128, chroms=chroms,
                             slots=slots, backend="native", stream="window")
    assert (want[1] < 512).any()
    for g, w in zip((got.pvals, got.nscores, got.hits), want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("m", sorted(CHUNK_M))
def test_permutation_chunk_large_panel_matches_jax(m, bitgen):
    """K11's function at m = 65, 128, 200 and 300: against JAX's
    permutation_chunk (near ties aside), and the composition the kernel
    runs (perm_chunk_words_plain folded by chunk_epilogue_plain) equal to
    the plain version on every window; need <= 0 and never reached, limit
    < chunk."""
    asize, bsize = CHUNK_M[m]
    dist, scores, chroms, slots = _phase1(asize, bsize, 7 + m, 3 if m >= 200 else 6)
    B = dist.shape[0]
    keys = rng.window_keys(rng.fold_in(rng.prng_key(4), 2), chroms, slots)
    obs = _mixed_scores(dist, scores, keys, asize, bsize)
    jkeys = jax.random.wrap_key_data(jnp.asarray(keys.numpy().astype(np.uint32)))
    need = np.array([-1, 1000, 1, 3, 0, 2][:B], dtype=np.int32)
    n_ties = 0
    for chunk, limit in ((64, 64), (48, 40) if m >= 200 else (96, 40)):
        got = tperm.permutation_chunk(dist, obs, torch.from_numpy(need), limit, keys, asize,
                                      bsize, chunk, bitgen)
        words = tperm.perm_chunk_words_plain(dist, obs, keys, limit, asize, bsize, chunk,
                                             bitgen)
        for g, c in zip(got, tperm.chunk_epilogue_plain(words, torch.from_numpy(need))):
            assert torch.equal(g, c)
        want = jperm.permutation_chunk(
            jnp.asarray(dist.numpy()), jnp.asarray(obs), jnp.asarray(need),
            jnp.asarray(limit), jkeys, asize, bsize, chunk, bitgen=bitgen)
        n_ties += _near_ties(dist, obs, keys, want[0], got[0].numpy(), asize, bsize, chunk,
                             bitgen)
        same = got[0].numpy() == np.asarray(want[0])
        for g, w in zip(got[1:], want[1:]):
            assert np.array_equal(g.numpy()[same], np.asarray(w)[same])
        assert got[0].numpy().max() <= min(chunk, limit)
        assert (got[2].numpy()[need <= 0] == 0).all() and not got[1].numpy()[need == 1000].any()
    assert n_ties <= 1


def _power_case(asize, bsize, stream, bitgen):
    dist, scores, chroms, slots = _phase1(asize, bsize, 51 + asize, 4)
    jkey, tkey = _keys(7)
    if stream == "window":
        jk = jperm.window_keys(jkey, jnp.asarray(chroms), jnp.asarray(slots))
        tk = rng.window_keys(tkey, chroms, slots)
    else:
        jk, tk = jkey, tkey
    want = np.asarray(jperm._null_power_sums(jnp.asarray(np.asarray(dist)), jk, asize, bsize,
                                             256, 2, jnp.int32(3), bitgen=bitgen,
                                             stream=stream))
    got = tperm.null_power_sums(dist, tk, asize, bsize, 256, 3, 2, stream, bitgen).numpy()
    return got, want


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("stream", ["shared", "window"])
@pytest.mark.parametrize("asize,bsize", PANELS)
def test_null_power_sums_large_panel_within_band(asize, bsize, stream, bitgen):
    """K9's function at m = 128 and 200, both streams: the shared stream
    runs K7's tile product at any m, the window stream the large-panel
    form."""
    got, want = _power_case(asize, bsize, stream, bitgen)
    assert got.shape == want.shape == (2, 3, 4) and got.dtype == np.float64
    err = power_err(got, want, 256)
    assert err <= LARGE_POWER_BAND[stream], err


@pytest.mark.parametrize("stream", ["shared", "window"])
@pytest.mark.parametrize("asize,bsize", PANELS)
def test_approx_large_panel_matches_jax(asize, bsize, stream):
    """approx_significance end to end at m = 128 and 200."""
    m = asize + bsize
    dist, scores, chroms, slots = _phase1(asize, bsize, 51 + asize, 4)
    jkey, tkey = _keys(7)
    kw = dict(chunk=256, chroms=chroms, slots=slots, stream=stream, max_rounds=1)
    want = jperm.approx_significance(np.asarray(dist), scores, asize, bsize, jkey, **kw)
    got = tperm.approx_significance(dist, scores, asize, bsize, tkey, **kw)
    same = got.nscores == want.nscores
    assert same.all(), np.nonzero(~same)[0]
    dl = np.abs(np.log10(got.pvals) - np.log10(want.pvals))
    assert dl.max() <= band(LARGE_LOG10_P_BAND, m), dl.max()
    assert ((got.pvals > 0) & (got.pvals <= 1)).all() and (got.hits == 0).all()


def test_step_large_panel_matches_jax():
    """make_divergence_step(70, 58) with plain=True on the CPU (the twin
    the card's step, K11's large-panel form included, is held to) against
    JAX's make_divergence_step."""
    av, bv, npos = _batch(8, 32, 70, 58, seed=17)
    slot = np.arange(8)
    kw = dict(nsamples=8, mc_chunk=64)
    mesh = jax_mesh(1)
    sh = window_sharding(mesh)
    jout = jax_step(mesh, 70, 58, **kw)(
        *(jax.device_put(jnp.asarray(x), sh) for x in (av, bv, npos, slot)),
        jax.random.PRNGKey(0))
    want = {k: np.asarray(v) for k, v in jout.items()}
    got = {k: v.numpy() for k, v in make_divergence_step(
        make_mesh(devices=[torch.device("cpu")]), 70, 58, plain=True, **kw)(
        av, bv, npos, slot, rng.prng_key(0)).items()}
    rel = lambda a, b: np.abs(a - b) / np.maximum(np.abs(b), 1.0)  # noqa: E731
    assert rel(got["fet_scores"], want["fet_scores"]).max() <= TOL["exact"]
    assert rel(got["fet_stddev"], want["fet_stddev"]).max() <= TOL["exact"]
    assert np.array_equal(got["css_valid"], want["css_valid"])
    mask = torch.arange(32)[None, :] < torch.from_numpy(npos)[:, None]
    dis = tcss.dissimilarity_counts(torch.from_numpy(np.concatenate([av, bv], axis=-1)), mask)
    ok = (eigengap(dis) > GAP_BOUND) & want["css_valid"]
    assert ok.sum() >= 6
    assert rel(got["css_scores"][ok], want["css_scores"][ok]).max() <= EXACT_TOL
    scores, dist, _ = tcss.css_window_batch(
        torch.from_numpy(av), torch.from_numpy(bv), torch.from_numpy(npos),
        rng.fold_in(rng.prng_key(0), 1), 70, 58, slot=torch.from_numpy(slot))
    keys = rng.window_keys(rng.fold_in(rng.prng_key(0), 2), np.zeros(8), slot)
    assert _near_ties(dist, scores.numpy(), keys, want["mc_hits"], got["mc_hits"], 70, 58,
                      64, "mix") <= 1


# ------------------------------------------------------------ wide FET windows


def _wide_case(nwide, seed):
    """Per-SNP codes of an 11 + 10 chromosome and windows of ~nwide SNPs
    (the widest pads to P = next power of two), with their slots."""
    rs = np.random.default_rng(seed)
    N = 3 * nwide
    codes = np.array([3.0, -3.0, 0.0, -10000.0])
    vals = rs.choice(codes, size=(N, 21), p=[0.4, 0.3, 0.25, 0.05])
    npos = rs.integers(nwide - nwide // 8, nwide + 1, size=4)
    lo = rs.integers(0, N - npos + 1)
    slot = np.arange(4, dtype=np.int64) * 7 + 3
    return vals, np.stack([lo, npos, slot])


@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("nwide", [5_000, 20_000])
def test_wide_window_aggregates_match_jax(nwide, prec):
    """K2's and K2r's functions on windows of ~5,000 and ~20,000 SNPs (P =
    8,192 and 32,768, past the card's old 4,096-SNP limit): the plain
    versions against JAX's fet_aggregate_all and fet_aggregate_all_ranks
    fed the same scores, and the rank path equal to the float path."""
    fast = prec == "fast"
    vals, rows = _wide_case(nwide, nwide)
    maxs, nmax = jfet.support_size(11, 10), 23
    P = tfet._window_pad(int(rows[1].max()))
    assert P == {5_000: 8192, 20_000: 32768}[nwide]
    jkey = jax.random.fold_in(jax.random.PRNGKey(11), 5)
    tkey = rng.fold_in(rng.prng_key(11), 5)
    logs = np.array(jfet.fet_snp_logs_joint(jnp.asarray(vals), 11, maxs, nmax, fast=fast))
    want = np.asarray(jfet.fet_aggregate_all(jnp.asarray(logs), jnp.asarray(rows), jkey,
                                             Bp=4, P=P, perc=0.95, nsamples=100, fast=fast))
    lo, npos, slot = (torch.from_numpy(r.copy()) for r in rows)
    got = tfet.fet_aggregate(torch.from_numpy(logs), lo, npos, slot, tkey, 0.95, 100)
    assert (want[1] > 0).all()
    for g, w in zip(got.numpy(), want):
        err = np.abs(g - w) / np.maximum(np.abs(w), 1.0)
        assert (err > TOL[prec]).sum() <= 1, err.max()
    assert np.abs(got[0].numpy() - want[0]).max() / max(np.abs(want[0]).max(), 1) <= TOL[prec]
    jls, jranks = jfet.fet_snp_ranks_joint(jnp.asarray(vals), 11, maxs, nmax, fast=fast)
    jr = np.asarray(jfet.fet_aggregate_all_ranks(jls, jranks, jnp.asarray(rows), jkey, Bp=4,
                                                 P=P, perc=0.95, nsamples=100, fast=fast))
    ls, r = tfet.fet_snp_ranks(torch.from_numpy(vals), 11, maxs, nmax, fast)
    gr = tfet.fet_aggregate_ranks(ls, r, lo, npos, slot, tkey, 0.95, 100)
    assert torch.equal(gr, tfet.fet_aggregate(ls[r], lo, npos, slot, tkey, 0.95, 100))
    for g, w in zip(gr.numpy(), jr):
        err = np.abs(g - w) / np.maximum(np.abs(w), 1.0)
        assert (err > TOL[prec]).sum() <= 1, err.max()


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_wide_window_batch_matches_jax(prec):
    """K10's function on windows gathered at P = 8,192 (~5,000 SNPs)."""
    fast = prec == "fast"
    vals, rows = _wide_case(5_000, 3)
    lo, npos = rows[0], rows[1]
    P = tfet._window_pad(int(npos.max()))
    idx = np.where(np.arange(P)[None, :] < npos[:, None], lo[:, None] + np.arange(P), 0)
    av, bv = vals[idx][..., :11], vals[idx][..., 11:]
    maxs, nmax = jfet.support_size(11, 10), 23
    jkey = jax.random.PRNGKey(5)
    want = jfet.fet_window_batch(jnp.asarray(av), jnp.asarray(bv), jnp.asarray(npos), 0.95,
                                 jkey, 100, maxs, nmax, fast=fast,
                                 slot=jnp.asarray(rows[2]))
    got = tfet.fet_window_batch(torch.from_numpy(av), torch.from_numpy(bv),
                                torch.from_numpy(npos), 0.95, rng.prng_key(5), 100, maxs, nmax,
                                fast, torch.from_numpy(rows[2]))
    for g, w in zip(got, want):
        err = np.abs(g.numpy() - np.asarray(w)) / np.maximum(np.abs(np.asarray(w)), 1.0)
        assert (err > TOL[prec]).sum() <= 1, err.max()


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_fet_wide_windows_matches_jax(prec):
    """run_fet at wsize 250,000 / wstep 50,000 (~5,000 SNPs a window at one
    SNP per 50 bp) on the CPU against JAX's run_fet."""
    regend = 1_000_000
    positions, amat, bmat = make_chromosome(20_000, regend, 11, 10, 7)
    kw = dict(bootstrap_samples=50, seed=2)
    cfg = FetConfig(window=WindowConfig(wsize=250_000, wstep=50_000), precision=prec, **kw)
    jcfg = JFetConfig(window=JWindowConfig(wsize=250_000, wstep=50_000), precision=prec, **kw)
    s, sd = run_fet(SnpPair(positions, amat, bmat), regend, cfg, device="cpu", seqid="chrW")
    js, jsd = jax_run_fet(JSnpPair(positions, amat, bmat), regend, jcfg, seqid="chrW")
    assert (js != 0).sum() >= 10 and np.array_equal(s != 0, js != 0)
    plan = plan_windows(positions, regend, 250_000, 50_000)
    assert plan.npos.max() > 4096
    for g, w in ((s, js), (sd, jsd)):
        err = np.abs(g - w) / np.maximum(np.abs(w), 1.0)
        assert (err > TOL[prec]).sum() <= 1, err.max()


@pytest.mark.parametrize("P", [32, 4096, 8192, 65536])
@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_wide_sort_stage_grouping_is_the_network(P, dtype):
    """The wide body's grouping of the bitonic network (stages of stride >=
    the chunk over the slab, each run of shorter stages chunk by chunk,
    csrc/fet_window_stats.cuh:wide_sort) mirrored in torch: the same
    comparators in the same order as the one-pass network, so the same
    bits (signed zeros keep their places), and an ascending sort."""
    rs = np.random.default_rng(P)
    if dtype == torch.int32:
        keys = torch.from_numpy(rs.integers(-1, 50, size=(3, P)).astype(np.int32))
    else:
        v = rs.choice([0.0, -0.0, 1.5, -np.inf, 2.25, 7.0], size=(3, P))
        keys = torch.from_numpy(v)
    one = tfet.bitonic_network(keys, tfet.bitonic_schedule(P, None))
    for chunk in (32, 1024, tfet.WIDE_CHUNK):
        sched = tfet.bitonic_schedule(P, chunk)
        assert [(k, j) for k, j, _ in sched] == [(k, j) for k, j, _ in
                                                 tfet.bitonic_schedule(P, None)]
        got = tfet.bitonic_network(keys, sched)
        bits = torch.int64 if dtype == torch.float64 else torch.int32
        assert torch.equal(got.view(bits), one.view(bits))
    assert torch.equal(one, torch.sort(keys, dim=-1).values)


def test_cpu_wrappers_take_any_m_and_width():
    """On CPU tensors the wrappers run their plain versions at any m and
    window width, and nothing in the port names a refused envelope."""
    from pathlib import Path

    dist, scores, chroms, slots = _phase1(33, 32, 5, 2)
    keys = rng.window_keys(rng.prng_key(1), chroms, slots)
    B = dist.shape[0]
    flat = dist.float().reshape(B, -1).contiguous()
    words = tperm.mc_window_hit_words(flat, torch.from_numpy(scores).float(), keys,
                                      torch.arange(B), 0, 1, 33, 32, 64, 64)
    assert words.shape == (B, 1, 2)
    out = tperm.null_power_sums(dist, keys, 33, 32, 64, 0, 1, "window")
    assert out.shape == (1, 3, B)
    hits, _, _ = tperm.permutation_chunk(dist, scores, torch.ones(B), 64, keys, 33, 32, 64)
    assert hits.shape == (B,)
    logs = torch.rand(6000, dtype=torch.float64)
    one = torch.zeros(1, dtype=torch.int64)
    assert tfet.fet_aggregate(logs, one, one + 5000, one, rng.prng_key(0), 0.95, 10).shape \
        == (2, 1)
    pkg = Path(tperm.__file__).resolve().parent.parent
    for path in pkg.rglob("*"):
        if path.suffix in (".py", ".cu", ".cuh"):
            assert "P12" not in path.read_text(), path
