"""CSS phase 1 of the port (divergence_tpu_torch.kernels.css and .linalg,
CPU path) against the JAX package's kernels run on the CPU: dissimilarity
counts, fill-averages, CMDS, distances, the score, and css_phase1 against
css_window_batch_prefix.

Tolerances, relative to max(|reference|, 1): counts exactly equal; exact
(float64) 1e-9 on windows whose eigengap (l2 - l3) / max(|l1|, 1) exceeds
1e-6 (a smaller gap leaves the 2-D embedding to the eigensolver,
docs/PARITY.md deviation 8a); fast (float32) the JAX package's own band
between its fast and exact scores, rtol 2e-3 with atol 1e-4
(tests/test_engines.py::test_fast_precision_mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.kernels import css as jcss
from divergence_tpu.kernels import linalg as jlinalg
from divergence_tpu.oracle import reference as orc
from divergence_tpu_torch.core.windows import plan_windows
from divergence_tpu_torch.kernels import css as tcss
from divergence_tpu_torch.kernels import linalg as tlinalg
from divergence_tpu_torch.tools.synth import make_panel

EXACT_TOL = 1e-9
GAP_BOUND = 1e-6
FAST_RTOL, FAST_ATOL = 2e-3, 1e-4
PANELS = [(11, 10), (5, 4), (1, 6), (2, 2)]


def _windows(asize, bsize, npos=500, region=25_000, seed=1):
    pos, am, bm = make_panel(npos, region, asize, bsize, seed=seed)
    vals = np.concatenate([am, bm], axis=1)
    plan = plan_windows(pos, region, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    return vals, plan.lo[ids], plan.npos[ids]


def eigengap(dis: torch.Tensor) -> np.ndarray:
    """(l2 - l3) / max(|l1|, 1) of each window's double-centred matrix,
    float64: windows below GAP_BOUND are excluded from value parity."""
    filled, _ = tcss.fill_averages(dis.to(torch.float64))
    ev = torch.linalg.eigvalsh(tcss.double_centre(filled)).flip(-1)
    if ev.shape[-1] < 3:
        return np.full(ev.shape[0], np.inf)
    return ((ev[:, 1] - ev[:, 2]) / ev[:, 0].abs().clamp(min=1.0)).numpy()


@pytest.mark.parametrize("asize,bsize", PANELS)
def test_dissimilarity_equals_jax_prefix_and_counts(asize, bsize):
    vals, lo, npos = _windows(asize, bsize)
    got = tcss.dissimilarity_plain(
        torch.from_numpy(vals), torch.from_numpy(lo), torch.from_numpy(npos)
    ).numpy()
    pref = jcss.dissimilarity_prefix(jnp.asarray(vals))
    want = np.asarray(jcss.dissimilarity_from_prefix(pref, jnp.asarray(lo), jnp.asarray(npos)))
    assert np.array_equal(got, want)
    P = 32
    while P < npos.max():
        P *= 2
    offs = np.arange(P)[None, :]
    mask = offs < npos[:, None]
    gathered = vals[np.where(mask, lo[:, None] + offs, 0)]
    want_c = np.asarray(jcss.dissimilarity_counts(jnp.asarray(gathered), jnp.asarray(mask)))
    assert np.array_equal(got, want_c)
    assert np.array_equal(
        tcss.dissimilarity_counts(torch.from_numpy(gathered), torch.from_numpy(mask)).numpy(),
        want_c,
    )
    assert got.sum() > 0


def test_dissimilarity_counts_form_above_the_prefix_budget(monkeypatch):
    vals, lo, npos = _windows(11, 10, seed=3)
    args = (torch.from_numpy(vals), torch.from_numpy(lo), torch.from_numpy(npos))
    prefix = tcss.dissimilarity_plain(*args)
    monkeypatch.setattr(tcss, "PREFIX_MAX_ELEMS", 1)
    monkeypatch.setattr(tcss, "_COUNT_BATCH_ELEMS", 64 * 21 * 3)   # several batches
    assert torch.equal(tcss.dissimilarity_plain(*args), prefix)


def test_css_dissim_wrapper_on_cpu_is_plain():
    vals, lo, npos = _windows(5, 4, seed=4)
    args = (torch.from_numpy(vals), torch.from_numpy(lo), torch.from_numpy(npos))
    for dt in (torch.float64, torch.float32):
        got = tcss.css_dissim(*args, dt)
        assert got.dtype == dt and torch.equal(got, tcss.dissimilarity_plain(*args).to(dt))
    assert tcss.LAUNCHES == {"css_dissim": 0, "css_dissim_gathered": 0, "css_dissim_tiles": 0,
                             "css_cmds": 0, "css_cmds_block": 0, "css_smacof": 0,
                             "css_smacof_block": 0}


def test_fill_averages_golden_and_discard():
    # reference testcss.c:422-473: off-diagonal i+j, avg = 80/25 = 3.2
    m = 5
    d = np.add.outer(np.arange(m), np.arange(m)).astype(float)
    np.fill_diagonal(d, 0.0)
    d2 = d.copy()
    d2[:, 0] = 0
    d2[:, m - 1] = 0
    d2[0, :] = 0
    filled, keep = tcss.fill_averages(torch.from_numpy(np.stack([d, d2])))
    assert bool(keep[0]) and not bool(keep[1])
    assert float(filled[0, 0, 0]) == pytest.approx(3.2)
    assert float(filled[0, 2, 2]) == pytest.approx(3.2)
    assert float(filled[0, 0, 1]) == 1.0
    jf, jk = jcss.fill_averages(jnp.asarray(np.stack([d, d2])))
    assert np.array_equal(np.asarray(jk), keep.numpy())
    np.testing.assert_allclose(filled.numpy(), np.asarray(jf), rtol=1e-15)


def test_cmds_golden_distances():
    # reference testcss.c:569-630 (eigenvector signs are arbitrary: the
    # parity is on the embedding's distances)
    dis = np.array(
        [[0, 4.05, 8.25, 5.57],
         [4.05, 0, 2.54, 2.69],
         [8.25, 2.54, 0, 2.11],
         [5.57, 2.69, 2.11, 0]])
    golden_x = np.array([[4.62, 0.07], [0.09, -1.11], [-3.63, -0.34], [-1.08, 1.38]])
    got = tcss.calc_dist(tcss.cmds(torch.from_numpy(dis)[None]))[0].numpy()
    np.testing.assert_allclose(got, orc.calc_dist(golden_x), atol=0.02)


def test_cmds_distances_match_jax(rng):
    for _ in range(10):
        m = 9
        d = rng.random((m, m)) * 5
        d = (d + d.T) / 2
        np.fill_diagonal(d, 0)
        got = tcss.calc_dist(tcss.cmds(torch.from_numpy(d)[None]))[0].numpy()
        want = np.asarray(jcss.calc_dist(jcss.cmds(jnp.asarray(d)[None])))[0]
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_top2_eig_matches_jax_cpu_route(rng):
    a = rng.normal(size=(6, 12, 12))
    a = a + a.transpose(0, 2, 1)
    w, v = tlinalg.top2_eig(torch.from_numpy(a))
    jw, jv = jlinalg.top2_eig(jnp.asarray(a))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-12)
    # eigenvectors up to sign
    dots = np.abs(np.einsum("bmk,bmk->bk", v.numpy(), np.asarray(jv)))
    np.testing.assert_allclose(dots, 1.0, rtol=1e-10)


def test_css_score_golden():
    # testcss.c:701-751: 100-point ramp -> 70.5975410337
    m = 100
    x = np.add.outer(np.arange(m), np.arange(2)).astype(float)
    dist = torch.from_numpy(orc.calc_dist(x))[None]
    assert float(tcss.css_from_dist(dist, 50, 50)[0]) == pytest.approx(70.5975410337, abs=1e-5)
    assert np.array_equal(
        tcss.chain_weights_host(7, 5), np.asarray(jcss.chain_weights_host(7, 5))
    )


@pytest.mark.parametrize("asize,bsize", PANELS)
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_css_phase1_matches_jax(asize, bsize, prec):
    fast = prec == "fast"
    vals, lo, npos = _windows(asize, bsize, npos=600, region=30_000, seed=asize)
    pref = jcss.dissimilarity_prefix(jnp.asarray(vals))
    js, jd, jv = jcss.css_window_batch_prefix(
        pref, jnp.asarray(lo), jnp.asarray(npos), jax.random.PRNGKey(0),
        asize, bsize, fast=fast,
    )
    ts, td, tv = tcss.css_phase1(torch.from_numpy(vals), lo, npos, asize, bsize, fast)
    js, jv, ts, tv = np.asarray(js), np.asarray(jv), ts.numpy(), tv.numpy()
    assert ts.shape == js.shape == (len(lo),)
    assert td.shape == (len(lo), asize + bsize, asize + bsize)
    assert np.array_equal(tv, jv) and jv.sum() > 10
    assert np.array_equal(np.isnan(ts), np.isnan(js))
    ok = ~np.isnan(js)
    if prec == "exact":
        ok &= eigengap(tcss.dissimilarity_plain(
            torch.from_numpy(vals), torch.from_numpy(lo), torch.from_numpy(npos))) > GAP_BOUND
        assert ok.sum() >= 0.95 * len(lo)
        err = np.abs(ts - js) / np.maximum(np.abs(js), 1.0)
        assert err[ok].max(initial=0.0) <= EXACT_TOL
    else:
        np.testing.assert_allclose(ts[ok], js[ok], rtol=FAST_RTOL, atol=FAST_ATOL)


def test_css_phase1_empty_and_discarded_windows():
    # an all-missing block: every cell unset -> the window is discarded
    vals = np.full((40, 5), -10000, dtype=np.int16)
    vals[20:] = np.random.default_rng(0).choice(np.array([3, -3], np.int16), (20, 5))
    lo = np.array([0, 20, 5], dtype=np.int64)
    npos = np.array([10, 20, 0], dtype=np.int64)
    s, d, v = tcss.css_phase1(torch.from_numpy(vals), lo, npos, 2, 3)
    assert v.tolist() == [False, True, False]
    assert s[0] == 0 and s[2] == 0
    js, _, jv = jcss.css_window_batch_prefix(
        jcss.dissimilarity_prefix(jnp.asarray(vals)), jnp.asarray(lo),
        jnp.asarray(npos), jax.random.PRNGKey(0), 2, 3,
    )
    assert np.asarray(jv).tolist() == v.tolist()
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-12, atol=1e-12)


def test_css_phase1_rejects_descriptors_outside_the_matrix():
    vals = torch.zeros((10, 4), dtype=torch.int16)
    with pytest.raises(ValueError, match="outside"):
        tcss.css_phase1(vals, np.array([8]), np.array([5]), 2, 2)


