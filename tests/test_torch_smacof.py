"""SMACOF in the port (divergence_tpu_torch.kernels.css, CPU path) against
the JAX package run on the CPU: _stress, _guttman, smacof, smacof_runs,
the batch freeze, css_phase1 with mds 1 and 2 against
css_window_batch_prefix, batching invariance, and the wrapper's
diagnostics.

Tolerances, relative to max(|reference|, 1): exact (float64) 1e-9 on every
window (the restart inits are bit-equal, tests/test_torch_rng.py).  Fast
(float32) is noise-bound: with epsilon 1e-6 below one float32 ulp of a
stress of ~1e2-1e3, the loop stops where float32 rounding stops the
descent, so two float32 implementations stop at different transforms.
FAST_BAND is the JAX package's own float32-vs-float64 SMACOF score
difference, measured on the CPU before the port's fast mode was compared
(mds 1 from the same float32 inits, mds 2 from CMDS): over the 265
windows of the five panels of test_css_phase1_smacof_fast_in_band (the
conftest panel and PANELS), mds 1 max 5.03e-2 and 90th percentile
6.93e-4, mds 2 max 1.52e-1 (the 5+4 panel) and 90th percentile 6.94e-4;
over the 19,997 windows of the 200 k-SNP / 10 Mbp bench chromosome, mds 1
max 5.46e-2 / q90 2.54e-4, mds 2 max 6.67e-2 / q90 2.83e-4.  The port's
fast scores must lie within that band of JAX's fast scores: every window
within the maximum, and over the same five panels pooled, the 90th
percentile too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.kernels import css as jcss
from divergence_tpu.kernels.perm import slot_keys as jslot_keys
from divergence_tpu.oracle import reference as orc
from divergence_tpu_torch import rng
from divergence_tpu_torch.core.windows import plan_windows
from divergence_tpu_torch.kernels import css as tcss
from divergence_tpu_torch.tools.synth import make_panel

EXACT_TOL = 1e-9
# mds -> (max, 90th percentile) of the measured float32-vs-float64 band
FAST_BAND = {1: (5.5e-2, 7e-4), 2: (1.53e-1, 7e-4)}
PANELS = [(11, 10), (5, 4), (1, 6), (2, 2)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the SMACOF loops are thousands of
    small ops, which several test workers' thread pools oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_in_fast_band(got, want, mds) -> np.ndarray:
    """Fast scores within the maximum of the measured band around the
    reference's fast scores; returns the relative errors (to
    max(|want|, 1)) for a pooled percentile check."""
    ok = ~np.isnan(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    rel = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1.0)
    assert rel.max(initial=0.0) <= FAST_BAND[mds][0], rel.max()
    return rel


def _sym(rs, B, m, scale=4.0):
    d = rs.random((B, m, m)) * scale
    d = (d + d.swapaxes(-1, -2)) / 2
    for b in range(B):
        np.fill_diagonal(d[b], 0.0)
    return d


def _close(got, want, tol=EXACT_TOL):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max(initial=0.0) <= tol, err.max()


def test_smacof_golden_fixture():
    # reference testcss.c (tests/test_css_kernel.py::test_smacof_golden_fixture)
    dis = np.array([[0, 5, 3, 4], [5, 0, 2, 2], [3, 2, 0, 1], [4, 2, 1, 0]], dtype=float)
    x0 = np.array([[-0.266, -0.539], [0.451, 0.252], [0.016, -0.238], [-0.200, 0.524]])
    x, sigma = tcss.smacof(torch.from_numpy(dis)[None], torch.from_numpy(x0)[None])
    golden = np.array([[-1.457, -2.575], [1.730, 1.23], [-0.028, 0.16], [-0.245, 1.185]])
    np.testing.assert_allclose(x[0].numpy(), golden, atol=0.01)
    want_x, want_sig = orc.smacof(dis, x0)
    np.testing.assert_allclose(x[0].numpy(), want_x, rtol=1e-9)
    assert float(sigma[0]) == pytest.approx(want_sig, rel=1e-9)
    jx, jsig = jcss.smacof(jnp.asarray(dis)[None], jnp.asarray(x0)[None])
    _close(x.numpy(), jx)
    _close(sigma.numpy(), jsig)


def test_stress_and_guttman_match_jax(rng):
    dis = _sym(rng, 5, 8)
    x = rng.random((5, 8, 2))
    d = np.array(jcss.calc_dist(jnp.asarray(x)))
    d[0, 1, 2] = d[0, 2, 1] = 0.0          # a coincident pair: the d == 0 guard
    td, tdis, tx = (torch.from_numpy(a) for a in (d, dis, x))
    _close(tcss._stress(tdis, td).numpy(), jcss._stress(jnp.asarray(dis), jnp.asarray(d)))
    _close(tcss._guttman(tx, td, tdis).numpy(),
           jcss._guttman(jnp.asarray(x), jnp.asarray(d), jnp.asarray(dis)), 1e-12)


@pytest.mark.parametrize("m", [2, 7, 21])
@pytest.mark.parametrize("max_iters", [300, 12])
def test_smacof_matches_jax(m, max_iters):
    rs = np.random.default_rng(m + max_iters)
    dis = _sym(rs, 12, m)
    filled, _ = tcss.fill_averages(torch.from_numpy(dis))
    x0 = rs.random((12, m, 2))
    x, sig, n = tcss._smacof_loop(filled, torch.from_numpy(x0), max_iters, 1e-6)
    jx, jsig = jcss.smacof(jnp.asarray(filled.numpy()), jnp.asarray(x0), max_iters)
    _close(x.numpy(), jx)
    _close(sig.numpy(), jsig)
    assert int(n.min()) >= 1 and int(n.max()) <= max_iters + 1


def test_smacof_batch_freeze_matches_serial(rng):
    """Windows converge at different transforms; the frozen batch equals
    per-window serial runs (port and oracle)."""
    B, m = 6, 7
    dis = _sym(rng, B, m)
    x0 = rng.random((B, m, 2))
    x, sig, n = tcss._smacof_loop(torch.from_numpy(dis), torch.from_numpy(x0), 300, 1e-6)
    assert len(set(n.tolist())) > 1
    for b in range(B):
        xb, sb = tcss.smacof(torch.from_numpy(dis[b]), torch.from_numpy(x0[b]))
        _close(xb.numpy(), x[b].numpy())
        _close(sb.numpy(), sig[b].numpy())
        want_x, want_sig = orc.smacof(dis[b], x0[b])
        np.testing.assert_allclose(x[b].numpy(), want_x, rtol=1e-8)
        assert float(sig[b]) == pytest.approx(want_sig, rel=1e-8)


def test_smacof_from_nan_never_iterates():
    """A NaN start (CMDS after a truly negative eigenvalue) stays NaN with
    zero transforms, as JAX's active0 = (sig0 == sig0)."""
    dis = _sym(np.random.default_rng(2), 2, 5)
    x0 = np.random.default_rng(3).random((2, 5, 2))
    x0[1, 2, 0] = np.nan
    x, sig, n = tcss._smacof_loop(torch.from_numpy(dis), torch.from_numpy(x0), 300, 1e-6)
    jx, jsig = jcss.smacof(jnp.asarray(dis), jnp.asarray(x0))
    assert n[1] == 0 and n[0] > 0
    assert np.array_equal(np.isnan(x.numpy()), np.isnan(np.asarray(jx)))
    assert bool(sig[1].isnan()) and np.isnan(np.asarray(jsig)[1])


def test_argmin_nan_first_is_numpy_rule():
    sig = torch.tensor([[3.0, 1.0, 2.0, np.nan],
                        [1.0, np.nan, 2.0, 1.0],
                        [1.0, 0.5, np.nan, 5.0],
                        [2.0, 0.5, 1.0, np.nan]])
    want = np.argmin(sig.numpy(), axis=0)
    assert np.array_equal(tcss._argmin_nan_first(sig).numpy(), want)
    assert np.array_equal(np.asarray(jnp.argmin(jnp.asarray(sig.numpy()), axis=0)), want)


@pytest.mark.parametrize("n_init", [4, 1, 6])
def test_smacof_runs_matches_jax(n_init):
    rs = np.random.default_rng(5 + n_init)
    m, B = 9, 10
    dis = _sym(rs, B, m)
    slots = np.arange(100, 100 + B, dtype=np.int64)
    jk = jax.random.fold_in(jax.random.PRNGKey(4), 77)
    tk = rng.fold_in(rng.prng_key(4), 77)
    want = np.asarray(jcss.smacof_runs(
        jnp.asarray(dis), jslot_keys(jk, jnp.asarray(slots)), n_init=n_init))
    wkeys = rng.slot_keys(tk, torch.from_numpy(slots))
    got = tcss.smacof_runs(torch.from_numpy(dis), wkeys, n_init=n_init)
    _close(got.numpy(), want)
    x, restart, ntrans = tcss._smacof_best(torch.from_numpy(dis), wkeys, n_init, 300, 1e-6)
    assert torch.equal(x, got)
    assert ((restart >= 0) & (restart < n_init)).all() and (ntrans >= 1).all()
    assert n_init == 1 or restart.max() > 0


def _windows(asize, bsize, npos=600, region=30_000, seed=None):
    pos, am, bm = make_panel(npos, region, asize, bsize, seed=asize if seed is None else seed)
    vals = np.concatenate([am, bm], axis=1)
    plan = plan_windows(pos, region, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    return vals, plan.lo[ids], plan.npos[ids], plan.slot[ids]


def _phase1_pair(vals, lo, npos, slots, asize, bsize, mds, fast):
    """(port, JAX) css_phase1 / css_window_batch_prefix on the same
    windows and chromosome key, as numpy (scores, dist, valid)."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 5)
    tkey = rng.fold_in(rng.prng_key(0), 5)
    js, jd, jv = jcss.css_window_batch_prefix(
        jcss.dissimilarity_prefix(jnp.asarray(vals)), jnp.asarray(lo),
        jnp.asarray(npos), jkey, asize, bsize, mds=mds, fast=fast,
        slot=jnp.asarray(slots),
    )
    ts, td, tv = tcss.css_phase1(torch.from_numpy(vals), lo, npos, asize, bsize,
                                 fast, mds=mds, key=tkey, slots=slots)
    assert td.dtype == (torch.float32 if fast else torch.float64)
    got = (ts.numpy(), td.numpy(), tv.numpy())
    want = (np.asarray(js), np.asarray(jd), np.asarray(jv))
    assert np.array_equal(got[2], want[2]) and want[2].sum() > 10
    assert np.array_equal(np.isnan(got[0]), np.isnan(want[0]))
    return got, want


@pytest.mark.parametrize("asize,bsize", PANELS)
@pytest.mark.parametrize("mds", [1, 2])
def test_css_phase1_smacof_matches_jax(asize, bsize, mds):
    """The port's _score_pipeline with mds 1 and 2 (through css_phase1)
    against css_window_batch_prefix, exact: 1e-9 on every window's score
    and distances; valid and NaN patterns identical."""
    (ts, td, tv), (js, jd, jv) = _phase1_pair(*_windows(asize, bsize), asize, bsize,
                                              mds, False)
    _close(ts, js)
    _close(td[jv], jd[jv])


@pytest.mark.parametrize("mds", [1, 2])
def test_css_phase1_smacof_fast_in_band(panel, mds):
    """Fast mode over the five panels the band was measured on: every
    window within the band's maximum, the pooled 90th percentile within
    its 90th percentile."""
    _, _, _, _, positions, amat, bmat = panel
    plan = plan_windows(positions, 20_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    cases = [((np.concatenate([amat, bmat], axis=1).astype(np.int16), plan.lo[ids],
               plan.npos[ids], plan.slot[ids]), 11, 10)]
    cases += [(_windows(a, b), a, b) for a, b in PANELS]
    rel = []
    for windows, a, b in cases:
        (ts, _, tv), (js, _, jv) = _phase1_pair(*windows, a, b, mds, True)
        rel.append(assert_in_fast_band(ts[jv], js[jv], mds))
    rel = np.concatenate(rel)
    assert len(rel) == 265
    assert np.quantile(rel, 0.9) <= FAST_BAND[mds][1], np.quantile(rel, 0.9)


def test_smacof_scores_batching_invariant():
    """Restart inits are slot-pinned: one batch or any split of it picks
    bit-identical embeddings, hence scores (tests/test_css_kernel.py::
    test_smacof_scores_batching_invariant)."""
    vals, lo, npos, slots = _windows(5, 4, seed=9)
    tkey = rng.fold_in(rng.prng_key(21), 3)
    whole = tcss.css_phase1(torch.from_numpy(vals), lo, npos, 5, 4, mds=1,
                            key=tkey, slots=slots, smacof_iters=60)
    for split in (2, 3):
        parts = np.array_split(np.arange(len(lo)), split)
        got = [tcss.css_phase1(torch.from_numpy(vals), lo[p], npos[p], 5, 4, mds=1,
                               key=tkey, slots=slots[p], smacof_iters=60) for p in parts]
        assert torch.equal(torch.cat([g[0] for g in got]), whole[0])
        assert torch.equal(torch.cat([g[2] for g in got]), whole[2])


@pytest.mark.parametrize("mds", [1, 2])
def test_css_smacof_wrapper_on_cpu_is_plain(mds):
    vals, lo, npos, slots = _windows(5, 4, seed=4)
    dis = tcss.dissimilarity_plain(torch.from_numpy(vals), torch.from_numpy(lo),
                                   torch.from_numpy(npos))
    key = rng.prng_key(8)
    tcss.reset_launches()
    got = tcss.css_smacof(dis, torch.from_numpy(npos), 5, 4, mds, key, slots,
                          max_iters=40)
    want = tcss.css_smacof_plain(dis, torch.from_numpy(npos), 5, 4, mds, key,
                                 torch.from_numpy(slots), max_iters=40)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    scores, dist, valid, restart, ntrans = got
    assert restart.dtype == ntrans.dtype == torch.int32
    assert ((ntrans >= 1) & (ntrans <= 41)).all() and (ntrans == 41).any()
    assert (restart == 0).all() if mds == 2 else restart.max() > 0
    assert tcss.LAUNCHES["css_smacof"] == 0
    with pytest.raises(ValueError, match="mds 1 or 2"):
        tcss.css_smacof(dis, torch.from_numpy(npos), 5, 4, 0, key, slots)


def test_css_phase1_smacof_needs_key_and_slots():
    vals, lo, npos, _ = _windows(2, 2)
    with pytest.raises(ValueError, match="chromosome key"):
        tcss.css_phase1(torch.from_numpy(vals), lo, npos, 2, 2, mds=1)
