"""K6's order of operations mirrored in torch (divergence_tpu_torch.kernels.
css: smacof_pairs, _pair_pass, _row_pass, _lane_sum) against the JAX
package's smacof / smacof_runs and _score_pipeline on the CPU.

The kernel computes each pair's distance once a transform: the pair pass
of XN gives its stress and the next transform's B(X), the stress summed
over the pairs i < j (plus half the diagonal's constant) in lane order and
a warp butterfly, the row sums in j order.  Tolerances, relative to
max(|reference|, 1), as tests/test_torch_smacof.py: exact (float64) 1e-9
on every element where the transform count (and, over restarts, the
chosen restart) agrees with the JAX loop's, the rest at most one window
(a 1e-16 difference in a stress can flip a stop decision); fast (float32)
within FAST_BAND of JAX's fast scores, pooled as the band was measured,
or nearer JAX's exact score than JAX's fast score is."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.kernels import css as jcss
from divergence_tpu.kernels.perm import slot_keys as jslot_keys
from divergence_tpu_torch import rng
from divergence_tpu_torch.kernels import css as tcss
from divergence_tpu_torch.core.windows import plan_windows
from test_torch_smacof import (
    FAST_BAND,
    PANELS,
    _close,
    _phase1_pair,
    _sym,
    _windows,
    one_torch_thread,  # noqa: F401 (autouse)
)

SIZES = [2, 3, 21, 33, 64]


def _filled(rs, B, m):
    dis = _sym(rs, B, m)
    return tcss.fill_averages(torch.from_numpy(dis))[0]


def _count(m):
    return 4 if m > 32 else 10


def test_lane_sum_is_the_warp_order():
    """_lane_sum adds element p on lane p % 32 in p order, then the xor
    butterfly: the same bits as that order written out in numpy float32."""
    v = np.random.default_rng(1).standard_normal((3, 77)).astype(np.float32) * 1e3
    lanes = np.zeros((3, 32), np.float32)
    for p in range(77):
        lanes[:, p % 32] = lanes[:, p % 32] + v[:, p]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ o]
    got = tcss._lane_sum(torch.from_numpy(v))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), lanes[:, 0])
    assert (lanes == lanes[:, :1]).all()   # every lane the same bits


def test_pair_pass_is_stress_and_guttman():
    """One pair pass gives _stress of x and the off-diagonal b of
    _guttman; a row pass on it gives _guttman's transform."""
    rs = np.random.default_rng(4)
    dis = _filled(rs, 5, 9)
    x = torch.from_numpy(rs.random((5, 9, 2)))
    x[0, 3] = x[0, 5]                      # a coincident pair: b = 0
    i, j = torch.triu_indices(9, 9, 1)
    dd = torch.diagonal(dis, dim1=-2, dim2=-1)
    sig, bm = tcss._pair_pass(dis[..., i, j], x, i, j, 0.5 * tcss._lane_sum(dd * dd))
    d = tcss.calc_dist(x)
    _close(sig.numpy(), tcss._stress(dis, d).numpy(), 1e-13)
    assert bm[0, 3, 5] == 0 and bm[0, 5, 3] == 0
    assert torch.equal(bm, bm.transpose(-1, -2))
    _close(tcss._row_pass(bm, x).numpy(), tcss._guttman(x, d, dis).numpy(), 1e-13)


@pytest.mark.parametrize("max_iters", [300, 0])
@pytest.mark.parametrize("m", SIZES)
def test_smacof_pairs_matches_jax(m, max_iters):
    rs = np.random.default_rng(m + max_iters)
    B = _count(m)
    dis = _filled(rs, B, m)
    x0 = torch.from_numpy(rs.random((B, m, 2)))
    x, sig, n = tcss.smacof_pairs(dis, x0, max_iters, 1e-6)
    _, _, want_n = tcss._smacof_loop(dis, x0, max_iters, 1e-6)
    jx, jsig = jcss.smacof(jnp.asarray(dis.numpy()), jnp.asarray(x0.numpy()), max_iters)
    agree = (n == want_n).numpy()
    assert (~agree).sum() <= 1
    _close(x.numpy()[agree], np.asarray(jx)[agree])
    _close(sig.numpy()[agree], np.asarray(jsig)[agree])
    assert int(n.min()) >= 1 and int(n.max()) <= max_iters + 1
    if max_iters == 0:
        assert (n == 1).all()


@pytest.mark.parametrize("n_init", [1, 4, 8])
@pytest.mark.parametrize("m", [3, 21, 64])
def test_smacof_pairs_restarts_match_jax_runs(monkeypatch, m, n_init):
    """The restarts from the slot keys, the best by numpy's argmin, as
    smacof_runs; the transforms of every restart summed as the kernel's
    diagnostic counts them."""
    rs = np.random.default_rng(7 * m + n_init)
    B = 3 if m > 32 else 8
    dis = _filled(rs, B, m)
    slots = np.arange(40, 40 + B, dtype=np.int64)
    jk = jax.random.fold_in(jax.random.PRNGKey(2), 9)
    wkeys = rng.slot_keys(rng.fold_in(rng.prng_key(2), 9), torch.from_numpy(slots))
    iters = 120 if m > 32 else 300
    px, pr, pn, pt = tcss._smacof_restarts(dis, wkeys, n_init, iters, 1e-6)
    monkeypatch.setattr(tcss, "_smacof_loop", tcss.smacof_pairs)
    x, restart, ntrans, total = tcss._smacof_restarts(dis, wkeys, n_init, iters, 1e-6)
    want = np.asarray(jcss.smacof_runs(jnp.asarray(dis.numpy()),
                                       jslot_keys(jk, jnp.asarray(slots)), n_init=n_init,
                                       max_iters=iters))
    agree = ((restart == pr) & (ntrans == pn)).numpy()
    assert (~agree).sum() <= 1
    _close(x.numpy()[agree], want[agree])
    assert ((total >= ntrans) & (total <= n_init * (iters + 1))).all()
    assert int((total != pt).sum()) <= 1
    if n_init == 1:
        assert torch.equal(total, ntrans) and (restart == 0).all()


def test_smacof_pairs_from_nan_never_iterates():
    rs = np.random.default_rng(3)
    dis = _filled(rs, 3, 6)
    x0 = torch.from_numpy(rs.random((3, 6, 2)))
    x0[1, 4, 1] = float("nan")
    x, sig, n = tcss.smacof_pairs(dis, x0, 300, 1e-6)
    jx, jsig = jcss.smacof(jnp.asarray(dis.numpy()), jnp.asarray(x0.numpy()))
    assert n[1] == 0 and (n[[0, 2]] > 0).all()
    assert bool(sig[1].isnan()) and np.isnan(np.asarray(jsig)[1])
    assert np.array_equal(np.isnan(x.numpy()), np.isnan(np.asarray(jx)))
    assert torch.equal(x[1].isnan(), x0[1].isnan())


@pytest.mark.parametrize("mds", [1, 2])
@pytest.mark.parametrize("asize,bsize", PANELS)
def test_score_pipeline_on_pairs_matches_jax(monkeypatch, asize, bsize, mds):
    """css_phase1 with K6's order in place of the plain loop, against
    css_window_batch_prefix, exact: 1e-9 on the scores and distances of all
    but one window (a flipped stop)."""
    monkeypatch.setattr(tcss, "_smacof_loop", tcss.smacof_pairs)
    (ts, td, tv), (js, jd, jv) = _phase1_pair(*_windows(asize, bsize), asize, bsize, mds,
                                              False)
    err = np.abs(ts - js) / np.maximum(np.abs(js), 1.0)
    assert (err > 1e-9).sum() <= 1
    ok = jv & (err <= 1e-9)
    _close(td[ok], jd[ok])


@pytest.mark.parametrize("mds", [1, 2])
def test_score_pipeline_on_pairs_fast_in_band(monkeypatch, panel, mds):
    """Fast mode in K6's order over the five panels FAST_BAND was measured
    on (tests/test_torch_smacof.py:test_css_phase1_smacof_fast_in_band):
    the pooled 90th percentile within the band's, and every window within
    the band's maximum of JAX's fast score or nearer JAX's exact score
    than JAX's fast score is (the band's maximum is a window of the 5 + 4
    panel on which JAX's fast mode stops far from its exact score; K6's
    order stops elsewhere there)."""
    _, _, _, _, positions, amat, bmat = panel
    plan = plan_windows(positions, 20_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    cases = [((np.concatenate([amat, bmat], axis=1).astype(np.int16), plan.lo[ids],
               plan.npos[ids], plan.slot[ids]), 11, 10)]
    cases += [(_windows(a, b), a, b) for a, b in PANELS]
    monkeypatch.setattr(tcss, "_smacof_loop", tcss.smacof_pairs)
    rel, n_nearer = [], 0
    for windows, a, b in cases:
        (fs, _, _), (gs, _, gv) = _phase1_pair(*windows, a, b, mds, True)
        _, (es, _, _) = _phase1_pair(*windows, a, b, mds, False)
        fs, gs, es = fs[gv], gs[gv], es[gv]
        assert np.array_equal(np.isnan(fs), np.isnan(gs))
        ok = ~np.isnan(gs)
        r = np.abs(fs[ok] - gs[ok]) / np.maximum(np.abs(gs[ok]), 1.0)
        nearer = np.abs(fs[ok] - es[ok]) < np.abs(gs[ok] - es[ok])
        assert ((r <= FAST_BAND[mds][0]) | nearer).all(), r.max()
        n_nearer += int((nearer & (r > FAST_BAND[mds][0])).sum())
        rel.append(r)
    rel = np.concatenate(rel)
    assert len(rel) == 265 and n_nearer <= 1
    assert np.quantile(rel, 0.9) <= FAST_BAND[mds][1], np.quantile(rel, 0.9)
