"""The port's sharded divergence step and its pieces
(divergence_tpu_torch.parallel, kernels.fet.fet_window_batch,
kernels.css.css_window_batch, kernels.perm.permutation_chunk; CPU path)
against the JAX package's, run on the CPU; the port's 1-vs-8-share and
sub-batch invariance (``devices=[cpu] * 8`` stands in for JAX's virtual
8-device mesh); the engines under a mesh and a slot-range split; the
bench-scaling harness.

Tolerances, relative to max(|reference|, 1): FET exact 1e-12, fast 1e-5
(scores and stddev).  CSS exact 1e-9 on windows whose eigengap exceeds
1e-6 (tests/test_torch_css.py), fast rtol 2e-3 / atol 1e-4 for CMDS and
the measured FAST_BAND for SMACOF (tests/test_torch_smacof.py); ``valid``
equal.  The permutation chunk's (hits, reached, pos) equal except on
windows shown to be float32 near ties (TIE_RTOL, tests/test_torch_mc.py):
the permutations are bit-equal, the float32 scores are summed in another
order than XLA's.  The step: ``windows_evaluated`` equal, ``score_sum``
within rtol 1e-9.  The port against itself over any mesh: per-window
outputs bit-equal, ``score_sum`` within rtol 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.kernels import css as jcss
from divergence_tpu.kernels import fet as jfet
from divergence_tpu.kernels import perm as jperm
from divergence_tpu.parallel import make_divergence_step as jax_step
from divergence_tpu.parallel import make_mesh as jax_mesh
from divergence_tpu.parallel import window_sharding
from divergence_tpu_torch import rng
from divergence_tpu_torch.config import CssConfig, FetConfig
from divergence_tpu_torch.engine import SnpPair, run_css, run_css_multi, run_fet, run_fet_multi
from divergence_tpu_torch.kernels import css as tcss
from divergence_tpu_torch.kernels import fet as tfet
from divergence_tpu_torch.kernels import perm as tperm
from divergence_tpu_torch.parallel import (
    make_divergence_step,
    make_mesh,
    pad_to_multiple,
    window_slices,
)
from divergence_tpu_torch.tools.synth import make_panel
from test_torch_css import EXACT_TOL, FAST_ATOL, FAST_RTOL, GAP_BOUND, eigengap
from test_torch_mc import TIE_RTOL
from test_torch_smacof import assert_in_fast_band, one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
TOL = {"exact": 1e-12, "fast": 1e-5}
OUTPUTS = ("fet_scores", "fet_stddev", "css_scores", "css_valid", "mc_hits")


def _batch(B, P, asize=5, bsize=4, seed=3):
    """Random windows with the bench's code frequencies (JAX
    tests/test_parallel.py:_batch): [B, P, a], [B, P, b] float64 codes and
    npos in [P/2, P]."""
    rs = np.random.default_rng(seed)
    codes = np.array([3.0, -3.0, 0.0, -10000.0])
    av = rs.choice(codes, size=(B, P, asize), p=[0.45, 0.35, 0.15, 0.05])
    bv = rs.choice(codes, size=(B, P, bsize), p=[0.45, 0.35, 0.15, 0.05])
    npos = rs.integers(P // 2, P + 1, size=(B,))
    return av, bv, npos


def _freq_batch(B, P, seed=5):
    """Drosophila windows: one allele frequency per SNP and population."""
    rs = np.random.default_rng(seed)
    fa = rs.uniform(0, 1, size=(B, P, 1))
    fb = np.clip(fa + rs.normal(0, 0.2, size=(B, P, 1)), 0, 1)
    return fa, fb, rs.integers(P // 2, P + 1, size=(B,))


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return np.abs(got - want) / np.maximum(np.abs(want), 1.0)


def _gap_ok(av, bv, npos):
    P = av.shape[1]
    mask = torch.arange(P)[None, :] < torch.from_numpy(npos)[:, None]
    vals = torch.from_numpy(np.concatenate([av, bv], axis=-1))
    return eigengap(tcss.dissimilarity_counts(vals, mask)) > GAP_BOUND


def _near_ties(dist, scores, keys, want_hits, got_hits, asize, bsize, chunk, bitgen):
    """Every window whose hits differ holds a permutation of the chunk
    whose float64 score lies within TIE_RTOL of the float32 observed one."""
    bad = np.nonzero(np.asarray(got_hits) != np.asarray(want_hits))[0]
    for w in bad:
        r = tperm._ranks(keys[w:w + 1], chunk, asize + bsize, bitgen)[0]
        C = tperm._rank_coeff(r, asize, bsize).double()
        s64 = (dist[w].double().float().double()[..., None] * C).sum(dim=(0, 1))
        obs = float(np.float32(scores[w]))
        gap = float((s64 - obs).abs().min()) / max(abs(obs), 1.0)
        assert gap <= TIE_RTOL, (w, gap)
    return len(bad)


# ------------------------------------------------------------------ the mesh


def test_mesh_construction():
    mesh = make_mesh(devices=[CPU] * 8)
    assert mesh == (CPU,) * 8
    assert make_mesh(3, devices=[CPU] * 8) == (CPU,) * 3
    with pytest.raises(ValueError, match="requested"):
        make_mesh(10_000, devices=[CPU] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            make_mesh()


def test_pad_to_multiple():
    assert pad_to_multiple(13, 8) == 16
    assert pad_to_multiple(16, 8) == 16
    assert pad_to_multiple(1, 8) == 8


@pytest.mark.parametrize("B,n", [(16, 8), (17, 4), (3, 4), (0, 2)])
def test_window_slices_cover_in_order(B, n):
    sl = window_slices(B, (CPU,) * n)
    assert len(sl) == n and sl[0].start == 0 and sl[-1].stop == B
    assert all(a.stop == b.start for a, b in zip(sl, sl[1:]))
    sizes = [s.stop - s.start for s in sl]
    assert max(sizes) - min(sizes) <= 1


# ------------------------------------------------- the step's three pieces


@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize", [(5, 4), (11, 10)])
def test_fet_window_batch_matches_jax(asize, bsize, prec):
    av, bv, npos = _batch(16, 32, asize, bsize, seed=asize)
    fast = prec == "fast"
    maxs, nmax = tfet.support_size(asize, bsize), asize + bsize + 2
    slot = np.arange(100, 116)
    js, jd = jfet.fet_window_batch(
        jnp.asarray(av), jnp.asarray(bv), jnp.asarray(npos), 0.95,
        jax.random.PRNGKey(4), nsamples=50, maxs=maxs, nmax=nmax, fast=fast,
        slot=jnp.asarray(slot),
    )
    ts, td = tfet.fet_window_batch(
        torch.from_numpy(av), torch.from_numpy(bv), torch.from_numpy(npos), 0.95,
        rng.prng_key(4), 50, maxs, nmax, fast, torch.from_numpy(slot),
    )
    assert ts.dtype == (torch.float32 if fast else torch.float64)
    assert _rel(ts, js).max() <= TOL[prec]
    assert _rel(td, jd).max() <= TOL[prec]
    assert (td.numpy() > 0).all()


def test_fet_window_batch_code_map_is_result_identical():
    """int16 {3, -3, 0} codes score as the raw codes do."""
    av, bv, npos = _batch(8, 32, seed=9)
    a16, b16 = (tfet.codes_int16(torch.from_numpy(x)) for x in (av, bv))
    assert a16.dtype == torch.int16 and set(a16.unique().tolist()) <= {-3, 0, 3}
    key = rng.prng_key(1)
    raw = tfet.fet_window_batch(torch.from_numpy(av), torch.from_numpy(bv), npos, 0.9,
                                key, 20, 7, 11)
    mapped = tfet.fet_window_batch(a16, b16, npos, 0.9, key, 20, 7, 11)
    for x, y in zip(raw, mapped):
        assert torch.equal(x, y)


CSS_CASES = [
    ("cmds", {"mds": 0}, (5, 4)),
    ("smacof", {"mds": 1, "smacof_iters": 20, "smacof_inits": 2}, (5, 4)),
    ("cmds+smacof", {"mds": 2, "smacof_iters": 20}, (11, 10)),
    ("drosophila", {"mds": 0, "drosophila": True}, (1, 1)),
]


@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("name,kw,panel", CSS_CASES, ids=[c[0] for c in CSS_CASES])
def test_css_window_batch_matches_jax(name, kw, panel, prec):
    asize, bsize = panel
    if kw.get("drosophila"):
        av, bv, npos = _freq_batch(16, 32)
    else:
        av, bv, npos = _batch(16, 32, asize, bsize, seed=asize + 1)
    fast = prec == "fast"
    slot = np.arange(40, 56)
    js, jd, jv = jcss.css_window_batch(
        jnp.asarray(av), jnp.asarray(bv), jnp.asarray(npos), jax.random.PRNGKey(6),
        asize=asize, bsize=bsize, fast=fast, slot=jnp.asarray(slot), **kw,
    )
    ts, td, tv = tcss.css_window_batch(
        torch.from_numpy(av), torch.from_numpy(bv), torch.from_numpy(npos),
        rng.prng_key(6), asize, bsize, fast=fast, slot=torch.from_numpy(slot), **kw,
    )
    js, jv = np.asarray(js), np.asarray(jv)
    assert np.array_equal(tv.numpy(), jv) and jv.sum() >= 12
    assert td.shape == tuple(jd.shape)
    ts = ts.numpy()
    mds = kw["mds"]
    if prec == "exact":
        ok = np.ones(len(js), bool) if mds or kw.get("drosophila") else _gap_ok(av, bv, npos)
        assert ok.sum() >= 12
        assert _rel(ts[ok], js[ok]).max() <= EXACT_TOL
    elif mds == 0:
        np.testing.assert_allclose(ts, js, rtol=FAST_RTOL, atol=FAST_ATOL)
    else:
        assert_in_fast_band(ts, js, mds)


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("asize,bsize", [(5, 4), (11, 10)])
def test_permutation_chunk_matches_jax(asize, bsize, bitgen):
    av, bv, npos = _batch(16, 32, asize, bsize, seed=2 * asize)
    scores, dist, _ = tcss.css_window_batch(
        torch.from_numpy(av), torch.from_numpy(bv), torch.from_numpy(npos),
        rng.prng_key(0), asize, bsize,
    )
    slot = np.arange(16)
    jkeys = jperm.window_keys(jax.random.fold_in(jax.random.PRNGKey(3), 2),
                              jnp.zeros(16, jnp.int64), jnp.asarray(slot))
    tkeys = rng.window_keys(rng.fold_in(rng.prng_key(3), 2), np.zeros(16), slot)
    assert np.array_equal(np.asarray(jax.random.key_data(jkeys)), tkeys.numpy())
    need = np.random.default_rng(asize).integers(0, 6, size=16).astype(np.int32)
    n_ties = 0
    for chunk, limit in ((128, 128), (64, 50)):
        want = jperm.permutation_chunk(
            jnp.asarray(dist.numpy()), jnp.asarray(scores.numpy()), jnp.asarray(need),
            jnp.asarray(limit), jkeys, asize, bsize, chunk, bitgen=bitgen,
        )
        got = tperm.permutation_chunk(dist, scores, torch.from_numpy(need), limit, tkeys,
                                      asize, bsize, chunk, bitgen)
        assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32
        assert got[1].dtype == torch.bool
        n_ties += _near_ties(dist, scores.numpy(), tkeys, want[0], got[0].numpy(), asize,
                             bsize, chunk, bitgen)
        same = got[0].numpy() == np.asarray(want[0])
        for g, w in zip(got[1:], want[1:]):
            assert np.array_equal(g.numpy()[same], np.asarray(w)[same])
        assert (got[0].numpy() <= min(chunk, limit)).all()
    assert n_ties <= 2


def test_permutation_chunk_pos_rules():
    """pos is the 0-based index of the need-th hit; 0 where need is never
    reached or need <= 0; chunk_hits counts the whole chunk."""
    av, bv, npos = _batch(8, 32, seed=4)
    scores, dist, _ = tcss.css_window_batch(
        torch.from_numpy(av), torch.from_numpy(bv), torch.from_numpy(npos),
        rng.prng_key(0), 5, 4,
    )
    keys = rng.slot_keys(rng.prng_key(8), torch.arange(8))
    new = tperm._perm_scores(dist.float(), keys, 5, 4, 64)
    hit = (new >= scores.float()[:, None]).numpy()
    for need in (0, 1, 3, 1000):
        hits, reached, pos = tperm.permutation_chunk(
            dist, scores, torch.full((8,), need), 64, keys, 5, 4, 64)
        assert np.array_equal(hits.numpy(), hit.sum(axis=1))
        assert np.array_equal(reached.numpy(), hit.sum(axis=1) >= need)
        for w in range(8):
            idx = np.nonzero(hit[w])[0]
            want = idx[need - 1] if 0 < need <= len(idx) else 0
            assert pos[w] == want


# ----------------------------------------------------------------- the step


def _jax_run(av, bv, npos, slot, **kw):
    mesh = jax_mesh(1)
    sh = window_sharding(mesh)
    step = jax_step(mesh, av.shape[-1], bv.shape[-1], **kw)
    out = step(*(jax.device_put(jnp.asarray(x), sh) for x in (av, bv, npos, slot)),
               jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in out.items()}


def _torch_run(devices, av, bv, npos, slot, **kw):
    step = make_divergence_step(make_mesh(devices=devices), av.shape[-1], bv.shape[-1], **kw)
    return step(av, bv, npos, slot, rng.prng_key(0))


STEP_CASES = [
    ("mds0", {"nsamples": 8, "mc_chunk": 16}, (5, 4)),
    # the dryrun's configuration (__graft_entry__.py:101-111)
    ("mds2", {"nsamples": 8, "mds": 2, "smacof_iters": 5, "smacof_inits": 2,
              "mc_chunk": 16}, (11, 10)),
    ("drosophila", {"nsamples": 8, "mc_chunk": 16, "drosophila": True}, (1, 1)),
]


@pytest.mark.parametrize("name,kw,panel", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_step_matches_jax(name, kw, panel):
    asize, bsize = panel
    if kw.get("drosophila"):
        av, bv, npos = _freq_batch(16, 32, seed=11)
    else:
        av, bv, npos = _batch(16, 32, asize, bsize, seed=13)
    slot = np.arange(16)
    want = _jax_run(av, bv, npos, slot, **kw)
    got = {k: v.numpy() for k, v in _torch_run([CPU], av, bv, npos, slot, **kw).items()}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
    assert _rel(got["fet_scores"], want["fet_scores"]).max() <= TOL["exact"]
    assert _rel(got["fet_stddev"], want["fet_stddev"]).max() <= TOL["exact"]
    assert np.array_equal(got["css_valid"], want["css_valid"])
    ok = np.ones(16, bool) if kw.get("mds") or kw.get("drosophila") else _gap_ok(av, bv, npos)
    assert ok.sum() >= 12
    assert _rel(got["css_scores"][ok], want["css_scores"][ok]).max() <= EXACT_TOL
    assert got["windows_evaluated"] == want["windows_evaluated"] == 16
    assert abs(got["score_sum"] - want["score_sum"]) <= 1e-9 * abs(want["score_sum"])
    # the MC chunk: equal but on float32 near ties of the port's own scores
    a_mc, b_mc = (1, 1) if kw.get("drosophila") else panel
    scores, dist, _ = tcss.css_window_batch(
        torch.from_numpy(av), torch.from_numpy(bv), torch.from_numpy(npos),
        rng.fold_in(rng.prng_key(0), 1), asize, bsize, drosophila=bool(kw.get("drosophila")),
        mds=kw.get("mds", 0), smacof_iters=kw.get("smacof_iters", 300),
        smacof_inits=kw.get("smacof_inits", 4), slot=torch.from_numpy(slot),
    )
    keys = rng.window_keys(rng.fold_in(rng.prng_key(0), 2), np.zeros(16), slot)
    assert _near_ties(dist, scores.numpy(), keys, want["mc_hits"], got["mc_hits"], a_mc,
                      b_mc, kw["mc_chunk"], "mix") <= 1


def test_one_vs_eight_shares_bit_equal():
    """Every output, the bootstrap stddev and the MC hits included, is
    bit-equal across mesh sizes: the streams are keyed by slot, not by
    share (JAX tests/test_parallel.py:64-93)."""
    av, bv, npos = _batch(16, 32)
    slot = np.arange(16)
    out1 = _torch_run([CPU], av, bv, npos, slot, nsamples=4, mc_chunk=8)
    out8 = _torch_run([CPU] * 8, av, bv, npos, slot, nsamples=4, mc_chunk=8)
    for name in OUTPUTS:
        assert torch.equal(out1[name], out8[name]), name
    assert float(out1["windows_evaluated"]) == float(out8["windows_evaluated"]) == 16
    s1, s8 = float(out1["score_sum"]), float(out8["score_sum"])
    assert abs(s1 - s8) <= 1e-9 * abs(s1)
    assert (out8["fet_stddev"] >= 0).all()


def test_step_sub_batch_invariance():
    """One call over 16 windows equals two calls over halves (JAX
    tests/test_parallel.py:94-109)."""
    av, bv, npos = _batch(16, 32, seed=7)
    slot = np.arange(16)
    kw = dict(nsamples=4, mc_chunk=8, mds=1, smacof_iters=5, smacof_inits=2)
    full = _torch_run([CPU] * 8, av, bv, npos, slot, **kw)
    halves = [_torch_run([CPU] * 8, av[s], bv[s], npos[s], slot[s], **kw)
              for s in (slice(0, 8), slice(8, 16))]
    for name in ("fet_scores", "fet_stddev", "css_scores", "mc_hits"):
        assert torch.equal(full[name], torch.cat([h[name] for h in halves])), name


def test_step_plain_twin_and_batch_checks():
    av, bv, npos = _batch(8, 32, seed=21)
    slot = np.arange(8)
    a = _torch_run([CPU] * 2, av, bv, npos, slot, nsamples=4, mc_chunk=8)
    b = _torch_run([CPU] * 2, av, bv, npos, slot, nsamples=4, mc_chunk=8, plain=True)
    for name in OUTPUTS:
        assert torch.equal(a[name], b[name]), name
    with pytest.raises(ValueError, match="divide"):
        _torch_run([CPU] * 3, av, bv, npos, slot)
    # empty (padding) windows: npos 0 scores 0 and counts as not evaluated
    npos0 = npos.copy()
    npos0[:2] = 0
    c = _torch_run([CPU] * 2, av, bv, npos0, slot, nsamples=4, mc_chunk=8)
    assert float(c["windows_evaluated"]) == 6
    assert (c["fet_scores"][:2] == 0).all() and not c["css_valid"][:2].any()


# --------------------------------------------------------------- the engines


@pytest.fixture(scope="module")
def chrom():
    pos, am, bm = make_panel(2500, 120_000, 6, 5, seed=12)
    return SnpPair(pos, am, bm), 120_000


def _split_runs(engine, pair, regend, cfg, cut):
    """The union of a two-range slot split: each half on its own span,
    as two hosts run it (tools/cli.py:_host_filter)."""
    nslots = regend // cfg.window.wstep
    lo = engine(pair.slice_span(0, (cut - 1) * 500 + 2500), regend, cfg, device="cpu",
                seqid="c", slot_range=(0, cut))
    hi = engine(pair.slice_span(cut * 500, (nslots - 1) * 500 + 2500), regend, cfg,
                device="cpu", seqid="c", slot_range=(cut, 1 << 62))
    return lo, hi


@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_run_fet_sharded_and_split_equal_unsharded(chrom, prec):
    pair, regend = chrom
    cfg = FetConfig(precision=prec)
    ref = run_fet(pair, regend, cfg, device="cpu", seqid="c")
    got = run_fet(pair, regend, cfg, sharding=make_mesh(devices=[CPU] * 4), seqid="c")
    lo, hi = _split_runs(run_fet, pair, regend, cfg, 97)
    for i in range(2):
        assert np.array_equal(got[i], ref[i])
        assert not (lo[i][97:].any() or hi[i][:97].any())
        assert np.array_equal(lo[i] + hi[i], ref[i])
    multi = run_fet_multi({"c": (pair, regend)}, cfg, sharding=make_mesh(devices=[CPU] * 3),
                          slot_ranges={"c": (0, 97)})["c"]
    assert np.array_equal(multi[0], lo[0])


@pytest.mark.parametrize("kw", [{}, {"mc_stream": "window"}, {"p_mode": "approx"},
                                {"mds": 1}])
def test_run_css_sharded_and_split_equal_unsharded(chrom, kw):
    pair, regend = chrom
    cfg = CssConfig(mc_runs=1000, **kw)
    ref = run_css(pair, regend, cfg, device="cpu", seqid="c")
    got = run_css(pair, regend, cfg, sharding=make_mesh(devices=[CPU] * 4), seqid="c")
    lo, hi = _split_runs(run_css, pair, regend, cfg, 120)
    assert (ref[0] != 0).sum() > 150
    for i in range(2):
        assert np.array_equal(got[i], ref[i])
        assert np.array_equal(lo[i] + hi[i], ref[i])
    other = SnpPair(*make_panel(900, 40_000, 6, 5, seed=13))
    pairs = {"c": (pair, regend), "d": (other, 40_000)}
    multi = run_css_multi(pairs, cfg, sharding=make_mesh(devices=[CPU] * 2))
    assert np.array_equal(multi["c"][1], ref[1])


def test_engines_need_a_device_or_a_mesh(chrom, monkeypatch):
    """Without a device or a mesh an engine asks for the card; with none
    present it raises, naming device='cpu' (there is no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pair, regend = chrom
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fet(pair, regend)


def test_scaling_bench_smoke():
    """run_scaling_bench (the bench-scaling core) over a 2-share CPU mesh
    reports both series with finite efficiencies (JAX
    tests/test_parallel.py:165-184)."""
    from divergence_tpu_torch.tools.bench_scaling import run_scaling_bench

    report = run_scaling_bench(
        max_devices=2, windows_per_device=8, total_windows=16, npos=16, nsamples=2,
        mc_chunk=8, repeats=1, devices=[CPU] * 2,
    )
    assert report["backend"] == "cpu"
    assert [r["devices"] for r in report["weak_scaling"]] == [1, 2]
    assert [r["devices"] for r in report["strong_scaling"]] == [1, 2]
    for series in ("weak_scaling", "strong_scaling"):
        for r in report[series]:
            assert np.isfinite(r["efficiency"]) and r["windows_per_s"] > 0
