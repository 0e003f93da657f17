"""The CMDS kernel's eigensolver, mirrored on the CPU
(divergence_tpu_torch.kernels.linalg:top2_eig_tridiag: Householder
tridiagonalisation, multisection on Sturm counts, inverse iteration, the
back-transform), against the JAX package's top2_eig on the CPU (LAPACK
eigh).

Tolerances, float64, relative to max(|lambda1|, 1): eigenvalues 1e-9; the
2-D embedding's distances 1e-9 where the eigengap (l2 - l3) / max(|l1|, 1)
exceeds 1e-6 (a smaller gap leaves the second vector to the solver, as in
tests/test_torch_css.py), and wherever l1 and l2 tie (any orthonormal
basis of their plane gives the same distances).  NaN coordinates (a
retained eigenvalue below the dust band) in the same windows.  Scores
through css_cmds_plain with the mirror swapped in: the tolerances of
tests/test_torch_css.py (exact 1e-9 on eigengap > 1e-6, fast rtol 2e-3 /
atol 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.kernels import css as jcss
from divergence_tpu.kernels import linalg as jlinalg
from divergence_tpu_torch.kernels import css as tcss
from divergence_tpu_torch.kernels import linalg as tlinalg
from test_torch_css import FAST_ATOL, FAST_RTOL, GAP_BOUND, _windows, eigengap

TOL = 1e-9


def _centred(rs, B, m, dims=4):
    """[B, m, m] double-centred matrices of seeded windows: filled squared
    distances of m random points in ``dims`` dimensions, with noise (so
    most are not Euclidean)."""
    x = rs.normal(size=(B, m, dims))
    d = np.sqrt(((x[:, :, None] - x[:, None]) ** 2).sum(-1))
    d = d * (1.0 + 0.05 * rs.random((B, m, m)))
    d = (d + d.transpose(0, 2, 1)) / 2
    filled, _ = tcss.fill_averages(torch.from_numpy(d))
    return tcss.double_centre(filled).numpy()


def _rotated(rs, spectra):
    """Symmetric matrices Q diag(spectrum) Q' with random orthogonal Q."""
    out = []
    for lam in spectra:
        q, _ = np.linalg.qr(rs.normal(size=(len(lam), len(lam))))
        out.append((q * np.asarray(lam)) @ q.T)
    a = np.stack(out)
    return (a + a.transpose(0, 2, 1)) / 2


def _embed(vals, vecs, dtype=np.float64):
    """X = Q sqrt(L) with css.py's dust clamp: [B, m, 2]."""
    dust = 1e-9 if dtype == np.float64 else 1e-5
    scale = np.maximum(np.abs(vals[:, :1]), 1.0)
    vals = np.where((vals < 0) & (vals > -dust * scale), 0.0, vals)
    with np.errstate(invalid="ignore"):
        return vecs * np.sqrt(vals)[:, None, :]


def _dist(x):
    return np.sqrt(((x[:, :, None] - x[:, None]) ** 2).sum(-1))


def _both(a):
    w, v, steps = tlinalg.top2_eig_tridiag(torch.from_numpy(a), return_steps=True)
    jw, jv = jlinalg.top2_eig(jnp.asarray(a))
    return w.numpy(), v.numpy(), steps.numpy(), np.asarray(jw), np.asarray(jv)


def _gap(a):
    ev = np.linalg.eigvalsh(a)[:, ::-1]
    if a.shape[-1] == 2:
        return np.full(len(a), np.inf)
    return (ev[:, 1] - ev[:, 2]) / np.maximum(np.abs(ev[:, 0]), 1.0)


@pytest.mark.parametrize("m", [2, 3, 21, 33, 64])
def test_random_centred_windows(m):
    a = _centred(np.random.default_rng(m), 40, m)
    w, v, steps, jw, jv = _both(a)
    scale = np.maximum(np.abs(jw[:, :1]), 1.0)
    assert np.max(np.abs(w - jw) / scale) <= TOL
    ok = _gap(a) > GAP_BOUND
    assert ok.sum() >= 0.9 * len(a)
    dt, jdt = _dist(_embed(w, v)), _dist(_embed(jw, jv))
    err = np.abs(dt - jdt) / np.maximum(np.abs(jdt), 1.0)
    assert err[ok].max() <= TOL
    # unit, orthogonal vectors; 13 multisection steps at most in float64
    gram = np.einsum("bmi,bmj->bij", v, v)
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(2), gram.shape), atol=1e-12)
    assert (steps >= 1).all() and (steps <= 16).all()


@pytest.mark.parametrize("m", [3, 21, 64])
def test_equal_top_eigenvalues(m):
    """lambda1 = lambda2 (to rounding): the pair is re-orthogonalised, and
    the distances equal LAPACK's within 1e-9 whatever basis each picks."""
    rs = np.random.default_rng(m + 100)
    spectra = [[5.0, 5.0] + list(rs.uniform(-1, 2, m - 2)) for _ in range(6)]
    spectra += [[3.0, 3.0 + 1e-13] + list(rs.uniform(-1, 1, m - 2)) for _ in range(6)]
    a = _rotated(rs, spectra)
    w, v, _, jw, jv = _both(a)
    assert np.max(np.abs(w - jw)) <= TOL * 5
    dt, jdt = _dist(_embed(w, v)), _dist(_embed(jw, jv))
    assert np.max(np.abs(dt - jdt) / np.maximum(np.abs(jdt), 1.0)) <= TOL
    assert np.abs(np.einsum("bm,bm->b", v[..., 0], v[..., 1])).max() <= 1e-12


@pytest.mark.parametrize("m,dims", [(2, 1), (5, 1), (21, 1), (21, 2), (64, 1)])
def test_rank_deficient(m, dims):
    """Centred Gram matrices of points in 1 or 2 dimensions: lambda2 (or
    lambda3) is zero to rounding, so one eigenvector is left to the
    solver but scaled by ~0 (the dust clamp); the distances agree."""
    rs = np.random.default_rng(m * dims)
    x = rs.normal(size=(8, m, dims))
    x = x - x.mean(axis=1, keepdims=True)
    a = np.einsum("bid,bjd->bij", x, x)
    a = (a + a.transpose(0, 2, 1)) / 2
    w, v, _, jw, jv = _both(a)
    assert np.max(np.abs(w - jw) / np.maximum(np.abs(jw[:, :1]), 1.0)) <= TOL
    dt, jdt = _dist(_embed(w, v)), _dist(_embed(jw, jv))
    assert np.max(np.abs(dt - jdt) / np.maximum(np.abs(jdt), 1.0)) <= 1e-7
    np.testing.assert_allclose(dt, _dist(x if dims <= 2 else x[..., :2]), rtol=1e-7,
                               atol=1e-7)


@pytest.mark.parametrize("m", [2, 3, 21])
def test_negative_second_eigenvalue(m):
    """A negative lambda2 inside the dust band is clamped to 0 (finite
    coordinates); outside it the coordinates are NaN, as LAPACK's route
    gives, in the same windows."""
    rs = np.random.default_rng(m + 7)
    rest = list(-3.0 - rs.random(m - 2))
    spectra = [[4.0, -1e-12] + rest, [4.0, -2e-9 * 4 * 0.4] + rest,   # inside the band
               [4.0, -0.5] + rest, [-0.2, -1.0] + rest[:m - 2],        # outside
               [0.5, -1e-3] + rest]
    a = _rotated(rs, spectra)
    w, v, _, jw, jv = _both(a)
    x, jx = _embed(w, v), _embed(jw, jv)
    assert np.array_equal(np.isnan(x).any(axis=(1, 2)), np.isnan(jx).any(axis=(1, 2)))
    assert np.isnan(jx).any(axis=(1, 2)).tolist() == [False, False, True, True, True]
    fin = ~np.isnan(jx).any(axis=(1, 2))
    dt, jdt = _dist(x[fin]), _dist(jx[fin])
    assert np.max(np.abs(dt - jdt) / np.maximum(np.abs(jdt), 1.0)) <= TOL


def test_cmds_with_the_mirror_matches_jax_cmds(monkeypatch):
    """css.cmds (dust clamp, X = Q sqrt(L)) on the mirror against JAX's
    cmds: the same NaN windows, distances within 1e-9."""
    rs = np.random.default_rng(3)
    d = rs.random((30, 9, 9)) * 5
    d = (d + d.transpose(0, 2, 1)) / 2
    d[:, np.arange(9), np.arange(9)] = 0
    d[:4, np.arange(9), np.arange(9)] = 12.0     # B negative off the ones vector: NaN
    monkeypatch.setattr(tcss, "top2_eig", tlinalg.top2_eig_tridiag)
    got = tcss.calc_dist(tcss.cmds(torch.from_numpy(d))).numpy()
    want = np.asarray(jcss.calc_dist(jcss.cmds(jnp.asarray(d))))
    nan = np.isnan(want).all(axis=(1, 2))
    assert nan[:4].all() and np.array_equal(np.isnan(got).all(axis=(1, 2)), nan)
    ok = ~nan & (_gap(tcss.double_centre(torch.from_numpy(d)).numpy()) > GAP_BOUND)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert ok.sum() >= 20 and err[ok].max() <= TOL


@pytest.mark.parametrize("asize,bsize", [(11, 10), (5, 4), (1, 1)])
@pytest.mark.parametrize("prec", ["exact", "fast"])
def test_cmds_plain_scores_with_the_mirror_match_jax(monkeypatch, asize, bsize, prec):
    """css_cmds_plain with top2_eig_tridiag in place of eigh against the
    JAX package's _score_pipeline(mds=0) on a small genome."""
    dt = torch.float64 if prec == "exact" else torch.float32
    vals, lo, npos = _windows(asize, bsize, npos=600, region=30_000, seed=asize + 40)
    dis64 = tcss.dissimilarity_plain(torch.from_numpy(vals), torch.from_numpy(lo),
                                     torch.from_numpy(npos))
    js, _, jv = jcss._score_pipeline(jnp.asarray(dis64.numpy()).astype(
        np.float64 if prec == "exact" else np.float32), jnp.asarray(npos), None, asize,
        bsize, 0, 300, 4, 1e-6)
    monkeypatch.setattr(tcss, "top2_eig", tlinalg.top2_eig_tridiag)
    ts, _, tv = tcss.css_cmds_plain(dis64.to(dt), torch.from_numpy(npos), asize, bsize)
    js, jv, ts, tv = np.asarray(js), np.asarray(jv), ts.double().numpy(), tv.numpy()
    assert np.array_equal(tv, jv) and jv.sum() > 10
    assert np.array_equal(np.isnan(ts), np.isnan(js))
    ok = ~np.isnan(js)
    if asize + bsize > 2:
        ok &= eigengap(dis64) > GAP_BOUND
    assert ok.sum() >= 0.95 * len(lo)
    if prec == "exact":
        err = np.abs(ts - js) / np.maximum(np.abs(js), 1.0)
        assert err[ok].max() <= TOL
    else:
        np.testing.assert_allclose(ts[ok], js[ok], rtol=FAST_RTOL, atol=FAST_ATOL)


def test_float32_steps_and_shapes():
    """float32 converges in fewer multisection steps; batch dimensions
    pass through."""
    a = _centred(np.random.default_rng(5), 12, 21).reshape(3, 4, 21, 21)
    w, v, steps = tlinalg.top2_eig_tridiag(torch.from_numpy(a).float(), return_steps=True)
    assert w.shape == (3, 4, 2) and v.shape == (3, 4, 21, 2) and steps.shape == (3, 4)
    assert w.dtype == torch.float32 and (steps <= 8).all()
    jw, _ = jlinalg.top2_eig(jnp.asarray(a.reshape(12, 21, 21)))
    np.testing.assert_allclose(w.reshape(12, 2).double().numpy(), np.asarray(jw),
                               rtol=2e-5, atol=1e-4)
