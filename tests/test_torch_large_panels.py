"""The port at today's resequencing panel sizes (m = 128 and 200), on the
CPU, against the JAX package: tests/test_large_panels.py's engine cases
(run_css and run_fet on a seeded 120-160-SNP chromosome at 70 + 58 and
110 + 90), the pieces the card's large-panel kernels follow (K7's
coefficients, K5's eigensolver mirror, K6's order of operations with the
block form's thread count) at m = 65 to 300, the MC's range schedule at
m = 200, and the default device.  (Where each wrapper switches between a
kernel's forms the kernel library reckons on the card:
tests/test_torch_kernels_gpu.py.)

Tolerances, relative to max(|reference|, 1): CSS exact 1e-9 on windows
whose eigengap (l2 - l3) / max(|l1|, 1) exceeds 1e-6, fast rtol 2e-3 /
atol 1e-4 (the JAX package's fast-vs-exact band); MC p-values equal but
on float32 near-tie windows, counted (at most MAX_P_DIFF_SHARE of the
scored windows); FET exact 1e-12, fast 1e-5; the coefficients bit-equal;
eigenvalues 1e-9 and the 2-D embedding's distances 1e-9 where the
eigengap exceeds 1e-6; SMACOF float64 1e-9 where the transform counts
agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.config import CssConfig as JCssConfig
from divergence_tpu.config import FetConfig as JFetConfig
from divergence_tpu.config import WindowConfig as JWindowConfig
from divergence_tpu.engine import run_css as jax_run_css
from divergence_tpu.engine import run_fet as jax_run_fet
from divergence_tpu.engine.snp import SnpPair as JSnpPair
from divergence_tpu.kernels import css as jcss
from divergence_tpu.kernels import perm as jperm
from divergence_tpu_torch import rng
from divergence_tpu_torch.config import CssConfig, FetConfig, WindowConfig
from divergence_tpu_torch.core.windows import plan_windows
from divergence_tpu_torch.engine import SnpPair, run_css, run_fet
from divergence_tpu_torch.kernels import css as tcss
from divergence_tpu_torch.kernels import linalg as tlinalg
from divergence_tpu_torch.kernels import perm as tperm
from test_torch_css import FAST_ATOL, FAST_RTOL, GAP_BOUND, eigengap
from test_torch_smacof import _close, _sym, one_torch_thread  # noqa: F401 (autouse)

REGEND = 8_000
WSIZE, WSTEP = 2500, 500
PANELS = [(70, 58), (110, 90)]
MODULE_M = [65, 128, 200, 300]
MAX_P_DIFF_SHARE = 0.02   # near-tie windows allowed, relative to scored windows


def _panel(seed, asize, bsize, npos):
    """tests/test_large_panels.py's _panel_pair: positions and the a and b
    genotype codes (Hardy-Weinberg draws around diverging frequencies, 2 %
    missing) from a numpy generator."""
    rs = np.random.default_rng(seed)
    positions = np.sort(rs.choice(np.arange(1, REGEND - 100), size=npos, replace=False))
    p_a = rs.uniform(0.15, 0.95, size=(npos, 1))
    p_b = np.clip(p_a + rs.normal(0, 0.25, size=(npos, 1)), 0.05, 0.95)

    def draw(p, size):
        g = rs.random((npos, size))
        het = 2 * p * (1 - p)
        mat = np.where(g < p**2, 3.0, np.where(g < p**2 + het, 0.0, -3.0))
        return np.where(rs.random((npos, size)) < 0.02, -10000.0, mat)

    return positions, draw(p_a, asize), draw(p_b, bsize)


def _slot_gap(positions, amat, bmat):
    """Each slot's eigengap (0 where no window), from the plain counts."""
    plan = plan_windows(positions, REGEND, WSIZE, WSTEP)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    dis = tcss.dissimilarity_plain(torch.from_numpy(np.concatenate([amat, bmat], axis=1)),
                                   torch.from_numpy(plan.lo[ids]),
                                   torch.from_numpy(plan.npos[ids]))
    gap = np.zeros(REGEND // WSTEP)
    gap[plan.slot[ids]] = eigengap(dis)
    return gap


@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize", PANELS)
def test_run_css_large_panel_matches_jax(asize, bsize, prec):
    """CSS end to end at m = 128 and 200 (dissimilarities, fill, CMDS
    across the old 64-individual limit, score, the shared-stream MC)."""
    positions, amat, bmat = _panel(11 + asize, asize, bsize, 120)
    kw = dict(mc_runs=300, mc_threshold=5, seed=4)
    cfg = CssConfig(window=WindowConfig(wsize=WSIZE, wstep=WSTEP), precision=prec, **kw)
    jcfg = JCssConfig(window=JWindowConfig(wsize=WSIZE, wstep=WSTEP), precision=prec, **kw)
    s, p = run_css(SnpPair(positions, amat, bmat), REGEND, cfg, device="cpu", seqid="chrL")
    js, jp = jax_run_css(JSnpPair(positions, amat, bmat), REGEND, jcfg, seqid="chrL")
    scored = js != 0
    assert scored.sum() >= 5 and np.array_equal(s != 0, scored)
    ok = scored & (_slot_gap(positions, amat, bmat) > GAP_BOUND)
    assert ok.sum() >= 0.9 * scored.sum()
    if prec == "exact":
        _close(s[ok], js[ok], 1e-9)
    else:
        np.testing.assert_allclose(s[ok], js[ok], rtol=FAST_RTOL, atol=FAST_ATOL)
    differ = (p != jp) & scored
    assert differ.sum() <= MAX_P_DIFF_SHARE * scored.sum(), differ.sum()
    assert ((p > 0) & (p <= 1))[scored].all()


@pytest.mark.parametrize("prec", ["exact", "fast"])
@pytest.mark.parametrize("asize,bsize", PANELS)
def test_run_fet_large_panel_matches_jax(asize, bsize, prec):
    """FET off the LUT at m = 128 and 200 (the per-SNP support scan)."""
    positions, amat, bmat = _panel(7 + asize, asize, bsize, 160)
    kw = dict(bootstrap_samples=40, seed=2)
    cfg = FetConfig(window=WindowConfig(wsize=WSIZE, wstep=WSTEP), precision=prec, **kw)
    jcfg = JFetConfig(window=JWindowConfig(wsize=WSIZE, wstep=WSTEP), precision=prec, **kw)
    s, sd = run_fet(SnpPair(positions, amat, bmat), REGEND, cfg, device="cpu", seqid="chrL")
    js, jsd = jax_run_fet(JSnpPair(positions, amat, bmat), REGEND, jcfg, seqid="chrL")
    assert (js != 0).sum() >= 5 and np.array_equal(s != 0, js != 0)
    tol = 1e-12 if prec == "exact" else 1e-5
    _close(s, js, tol)
    _close(sd, jsd, tol)


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
@pytest.mark.parametrize("m", MODULE_M)
def test_coeff_range_plain_matches_jax_shared_coeff(m, bitgen):
    """K7's coefficient columns at large m (what css_mc_coeff_block
    writes) bit-equal to JAX's _shared_coeff, a ragged chunk included."""
    asize, bsize = (m + 1) // 2, m // 2
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 2)
    tkey = rng.fold_in(rng.prng_key(3), 2)
    chunk = 40
    got = tperm.coeff_range_plain(tkey, 1, 2, m, asize, bsize, chunk, "cpu", bitgen).numpy()
    cs = tperm.chunk_stride(chunk)
    assert got.shape == (m * m, 2 * cs)
    for kk, k in enumerate((1, 2)):
        want = np.asarray(jperm._shared_coeff(jkey, k, m, asize, bsize, chunk, bitgen))
        cols = got[:, kk * cs: kk * cs + chunk]
        assert np.array_equal(cols.view(np.uint32), want.view(np.uint32)), k
        assert not got[:, kk * cs + chunk: (kk + 1) * cs].any()


def _centred(rs, B, m, dims=4):
    x = rs.normal(size=(B, m, dims))
    d = np.sqrt(((x[:, :, None] - x[:, None]) ** 2).sum(-1))
    d = d * (1.0 + 0.05 * rs.random((B, m, m)))
    filled, _ = tcss.fill_averages(torch.from_numpy((d + d.transpose(0, 2, 1)) / 2))
    return tcss.double_centre(filled)


@pytest.mark.parametrize("m", MODULE_M)
def test_top2_eig_tridiag_large_panels(m):
    """K5's eigensolver steps (css_block.cuh's cmds_embed_block runs them
    at m > 64) against numpy's eigh: the two largest eigenvalues, and the
    2-D embedding's distances where the eigengap exceeds 1e-6."""
    a = _centred(np.random.default_rng(m), 3, m)
    vals, vecs = tlinalg.top2_eig_tridiag(a)
    w, v = np.linalg.eigh(a.numpy())
    scale = np.maximum(np.abs(w[:, -1:]), 1.0)
    assert np.max(np.abs(vals.numpy() - w[:, ::-1][:, :2]) / scale) <= 1e-9
    gap = (w[:, -2] - w[:, -3]) / scale[:, 0] > GAP_BOUND
    assert gap.all()
    x = vecs.numpy() * np.sqrt(np.maximum(vals.numpy(), 0.0))[:, None, :]
    xw = v[:, :, ::-1][:, :, :2] * np.sqrt(np.maximum(w[:, ::-1][:, :2], 0.0))[:, None, :]

    def dist(e):
        return np.sqrt(((e[:, :, None] - e[:, None]) ** 2).sum(-1))

    _close(dist(x), dist(xw), 1e-9)


@pytest.mark.parametrize("m", sorted(MODULE_M + [69]))
def test_smacof_pairs_block_order_matches_jax(m):
    """K6's order of operations in the block form (256 threads: the fused
    pass over the pairs, the transform's sums from the warps' column
    partials and each row's own, the stress from the lanes' partials)
    against JAX's smacof in float64, where the transform counts agree; and
    the block sum equals the 32-lane sum's value to rounding."""
    rs = np.random.default_rng(m)
    lanes = tcss.BLOCK_LANES
    dis = tcss.fill_averages(torch.from_numpy(_sym(rs, 2, m)))[0]
    x0 = torch.from_numpy(rs.random((2, m, 2)))
    iters = 40
    x, sig, n = tcss.smacof_pairs(dis, x0, iters, 1e-6, lanes=lanes)
    jx, jsig = jcss.smacof(jnp.asarray(dis.numpy()), jnp.asarray(x0.numpy()), iters)
    _, _, want_n = tcss._smacof_loop(dis, x0, iters, 1e-6)
    agree = (n == want_n).numpy()
    assert agree.sum() >= 1
    _close(x.numpy()[agree], np.asarray(jx)[agree])
    _close(sig.numpy()[agree], np.asarray(jsig)[agree])
    v = torch.from_numpy(rs.random((4, 3 * lanes + 17)))
    _close(tcss._block_sum(v, lanes).numpy(), v.sum(-1).numpy(), 1e-14)


def _fused_pass_in_order(dis, x):
    """One pass of css_smacof.cu's pair_sums and guttman_finish written out
    in plain loops, in the kernel's order: warp w's rows snaked (s NW + w
    for even s, s NW + NW - 1 - w for odd); each pair's residual and b_ij
    from torch (as the
    mirror forms them), each lane on the pairs j = i + 1 + lane + 32t of
    row i, the lanes' partials, butterflies, the warps' column partials
    added in warp order, then the row's own."""
    m, NW = dis.shape[0], tcss.BLOCK_LANES // 32
    iu, ju = np.triu_indices(m, 1)
    r, b = tcss._pair_terms(torch.from_numpy(dis[iu, ju]), torch.from_numpy(x),
                            torch.from_numpy(iu), torch.from_numpy(ju))
    r, b = r.numpy(), b.numpy()
    pair = {(i, j): k for k, (i, j) in enumerate(zip(iu, ju))}
    xor = [np.arange(32) ^ o for o in (16, 8, 4, 2, 1)]
    colp, rowp, spw = np.zeros((NW, 3, m)), np.zeros((3, m)), []
    for w in range(NW):
        sp = np.zeros(32)
        for s in range(-(-m // NW)):
            i = s * NW + (NW - 1 - w if s % 2 else w)
            if i >= m:
                continue
            lp = np.zeros((3, 32))
            for lane in range(32):
                for j in range(i + 1 + lane, m, 32):
                    k = pair[(i, j)]
                    sp[lane] += r[k] * r[k]
                    lp[:, lane] += (b[k], b[k] * x[j, 0], b[k] * x[j, 1])
                    colp[w, :, j] += (b[k], b[k] * x[i, 0], b[k] * x[i, 1])
            for ix in xor:
                lp = lp + lp[:, ix]
            rowp[:, i] = lp[:, 0]
        for ix in xor:
            sp = sp + sp[ix]
        spw.append(sp[0])
    st, tot = spw[0], colp[0]
    for q in range(1, NW):
        st, tot = st + spw[q], tot + colp[q]
    tot = tot + rowp
    return st, np.stack([(tot[1] - tot[0] * x[:, 0]) / m, (tot[2] - tot[0] * x[:, 1]) / m], -1)


@pytest.mark.parametrize("m", [9, 40, 69])
def test_fused_pass_is_the_block_order(m):
    """The mirror's fused pass (kernels/css.py _fused_pass, _block_plan)
    equals the kernel's order written out in loops, bit for bit."""
    rs = np.random.default_rng(m)
    dis = tcss.fill_averages(torch.from_numpy(_sym(rs, 1, m)))[0][0].numpy()
    x = rs.random((m, 2))
    i, j = torch.triu_indices(m, m, 1)
    st, xn = tcss._fused_pass(torch.from_numpy(dis)[i, j], torch.from_numpy(x), i, j,
                              torch.zeros((), dtype=torch.float64),
                              tcss._block_plan(m, torch.device("cpu")))
    want_st, want_xn = _fused_pass_in_order(dis, x)
    assert float(st) == want_st
    assert np.array_equal(xn.numpy(), want_xn)


@pytest.mark.parametrize("m", [69, 128, 200])
def test_fused_pass_is_stress_and_guttman(m):
    """One fused pass gives _stress of x and _guttman's transform of x, to
    rounding, on a few windows (a coincident pair: b = 0)."""
    rs = np.random.default_rng(m + 1)
    dis = tcss.fill_averages(torch.from_numpy(_sym(rs, 3, m)))[0]
    x = torch.from_numpy(rs.random((3, m, 2)))
    x[1, 5] = x[1, 60]
    i, j = torch.triu_indices(m, m, 1)
    dd = torch.diagonal(dis, dim1=-2, dim2=-1)
    st, xn = tcss._fused_pass(dis[..., i, j], x, i, j, 0.5 * tcss._block_sum(dd * dd, 256),
                              tcss._block_plan(m, torch.device("cpu")))
    d = tcss.calc_dist(x)
    _close(st.numpy(), tcss._stress(dis, d).numpy(), 1e-13)
    _close(xn.numpy(), tcss._guttman(x, d, dis).numpy(), 1e-13)


def test_block_sum_is_the_block_order():
    """_block_sum adds element p on thread p % 256 in p order, the xor
    butterfly in each warp, then the warps in order: the same bits as that
    order written out in numpy float32."""
    v = np.random.default_rng(2).standard_normal((3, 700)).astype(np.float32) * 1e3
    t = np.zeros((3, 256), np.float32)
    for p in range(700):
        t[:, p % 256] = t[:, p % 256] + v[:, p]
    t = t.reshape(3, 8, 32)
    for o in (16, 8, 4, 2, 1):
        t = t + t[:, :, np.arange(32) ^ o]
    want = t[:, 0, 0]
    for q in range(1, 8):
        want = want + t[:, q, 0]
    got = tcss._block_sum(torch.from_numpy(v), 256)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(tcss._block_sum(torch.from_numpy(v), 32),
                       tcss._lane_sum(torch.from_numpy(v)))


@pytest.mark.parametrize("mds", [1, 2])
def test_css_smacof_plain_large_panel_matches_jax_runs(mds):
    """css_smacof_plain (K6's plain version, any m) at m = 200 against
    JAX's _score_pipeline in float64."""
    m, asize, bsize = 200, 110, 90
    rs = np.random.default_rng(5 + mds)
    dis = torch.from_numpy(_sym(rs, 2, m, scale=20.0))
    npos = torch.tensor([40, 40])
    slots = torch.tensor([3, 9])
    tkey = rng.fold_in(rng.prng_key(6), 1)
    jkey = jax.random.fold_in(jax.random.PRNGKey(6), 1)
    got = tcss.css_smacof_plain(dis, npos, asize, bsize, mds, tkey, slots, 4, 30)
    wkeys = jperm.slot_keys(jkey, jnp.asarray(slots.numpy())) if mds == 1 else None
    want = jcss._score_pipeline(jnp.asarray(dis.numpy()), jnp.asarray(npos.numpy()), wkeys,
                                asize, bsize, mds, smacof_iters=30, smacof_inits=4, smacof_eps=1e-6)
    _close(got[0].numpy(), np.asarray(want[0]), 1e-9)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


def test_range_schedule_at_m200():
    """The shared stream's ranges at m = 200 on 997 windows and 20,000
    permutations: the coefficient cap leaves the schedule free to grow
    (8 ranges, not one chunk each), covering every chunk once."""
    n_chunks, chunk, mm = -(-20_000 // 256), 256, 200 * 200
    k, sizes = 0, []
    while k < n_chunks:
        nk = tperm.range_chunks(k, n_chunks, 997, mm, chunk)
        assert 4 * mm * tperm.chunk_stride(chunk) * nk <= tperm._RANGE_COEFF_BYTES or nk == 1
        sizes.append(nk)
        k += nk
    assert sum(sizes) == n_chunks and len(sizes) <= 8


def test_default_device_is_the_card(monkeypatch):
    """run_css, run_css_multi, run_fet and run_fet_multi without a device
    ask for the card: with none present they raise, naming device='cpu';
    device='cpu' runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    positions, amat, bmat = _panel(3, 4, 3, 60)
    pair = SnpPair(positions, amat, bmat)
    from divergence_tpu_torch.engine import run_css_multi, run_fet_multi

    for call in (lambda **kw: run_css(pair, REGEND, CssConfig(mc_runs=50), **kw),
                 lambda **kw: run_fet(pair, REGEND, FetConfig(bootstrap_samples=5), **kw),
                 lambda **kw: run_css_multi({"c": (pair, REGEND)}, CssConfig(mc_runs=50), **kw),
                 lambda **kw: run_fet_multi({"c": (pair, REGEND)}, FetConfig(bootstrap_samples=5),
                                            **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        out = call(device="cpu")
        assert out is not None
