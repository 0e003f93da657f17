"""Measure the JAX package's own float32-vs-float64 SMACOF score band on
the panels of tests/test_torch_kernels_gpu.py's test_css_smacof_kernel
(make_panel(20_000, 1_000_000, a, b, seed=m), 1,997 windows), the way
FAST_BAND was measured (tests/test_torch_smacof.py): mode 1 from the same
float32 restart inits in both precisions, the best restart by numpy's
argmin, the CSS score of its distances; relative to max(|float64|, 1),
over the windows the fill rule keeps, from the test's restart keys.  Then
the same float32 restarts in K6's order of operations
(divergence_tpu_torch.kernels.css.smacof_pairs with the kernel's thread
count, which the card's kernel equals bit for bit): its band, and for the
window farthest from float64 each restart's final stress and transform
count in K6's order, JAX's float32 and JAX's float64.  Mode 2 (one restart
from CMDS) likewise: JAX's float32 against its float64, and the port's
plain float32 against JAX's float64.  Runs on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/measure_smacof_band.py 21 33 64

(a few minutes at m = 64).  An argument ``m:n:lanes`` takes the panel's
first n windows only (the large panels, whose float64 restarts would
otherwise hold gigabytes) and mirrors K6 with ``lanes`` threads a restart
(32, the warp form, by default; 256 for the block form that float32 mode 1
takes from m = 98, ``kernels.css.smacof_lanes`` on the card):
``128:300:256 200:200:256``.  ``--mds 2`` measures mode 2 instead."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import divergence_tpu  # noqa: F401  (x64 on)
from divergence_tpu.kernels import css as jcss
from divergence_tpu.kernels.perm import chrom_hash
from divergence_tpu.kernels.perm import slot_keys as jslot_keys
from divergence_tpu_torch.core.windows import plan_windows
from divergence_tpu_torch.kernels import css as tcss
from divergence_tpu_torch.tools.synth import make_panel

N_INIT = 4


def _rel(got, want):
    return np.abs(got - want) / np.maximum(np.abs(want), 1.0)


def band(m: int, limit: int | None = None, lanes: int = tcss.WARP_LANES,
         mds: int = 1) -> None:
    asize, bsize = (m + 1) // 2, m // 2
    pos, am, bm = make_panel(20_000, 1_000_000, asize, bsize, seed=m)
    plan = plan_windows(pos, 1_000_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0][:limit]
    vals = torch.from_numpy(np.concatenate([am, bm], axis=1))
    dis = tcss.dissimilarity_plain(vals, torch.from_numpy(plan.lo[ids]),
                                   torch.from_numpy(plan.npos[ids])).numpy()
    if mds == 2:
        band_mode2(dis, plan.npos[ids], asize, bsize)
        return
    # the test's chromosome key: fold_in(PRNGKey(3), chrom_hash("chrK"))
    key = jax.random.fold_in(jax.random.PRNGKey(3), chrom_hash("chrK"))
    wk = jslot_keys(key, jnp.asarray(plan.slot[ids]))
    x0 = jax.vmap(lambda k: jax.random.uniform(k, (N_INIT, m, 2), dtype=jnp.float32))(wk)
    x0 = jnp.moveaxis(x0, 0, 1)                                  # [I, B, m, 2]
    scores, sigs = {}, {}
    for dt in (jnp.float32, jnp.float64):
        filled, keep = jcss.fill_averages(jnp.asarray(dis.astype(dt)))
        x, sig = jcss.smacof(filled[None], x0.astype(dt), 300, 1e-6)
        best = jnp.argmin(sig, axis=0)
        xb = jnp.take_along_axis(x, best[None, :, None, None], axis=0)[0]
        scores[dt] = np.asarray(jcss.css_from_dist(jcss.calc_dist(xb), asize, bsize))
        sigs[dt] = np.asarray(sig)
    filled, _ = tcss.fill_averages(torch.from_numpy(dis.astype(np.float32)))
    x, ksig, kn = tcss.smacof_pairs(filled[None], torch.from_numpy(np.asarray(x0)), 300, 1e-6,
                                    lanes=lanes)
    best = tcss._argmin_nan_first(ksig)
    xb = x[best, torch.arange(x.shape[1])]
    kscore = tcss.css_from_dist(tcss.calc_dist(xb), asize, bsize).numpy()
    ok = np.asarray(keep)
    f32, f64, k32 = scores[jnp.float32][ok], scores[jnp.float64][ok], kscore[ok]
    for label, r in (("JAX float32", _rel(f32, f64)), ("K6's order, float32", _rel(k32, f64))):
        print(f"m={m}: {int(ok.sum())} windows, {label} vs JAX float64 max {r.max():.3e} "
              f"q90 {np.quantile(r, 0.9):.3e}", flush=True)
    w = int(np.nonzero(ok)[0][np.argmax(_rel(k32, f64))])
    print(f"m={m} window {w}: K6's order restart {int(best[w])}, stresses "
          f"{[f'{float(v):.7g}' for v in ksig[:, w]]}, transforms {kn[:, w].tolist()}; "
          f"JAX float32 restart {int(np.argmin(sigs[jnp.float32][:, w]))}, stresses "
          f"{[f'{float(v):.7g}' for v in sigs[jnp.float32][:, w]]}; JAX float64 restart "
          f"{int(np.argmin(sigs[jnp.float64][:, w]))}, stresses "
          f"{[f'{float(v):.9g}' for v in sigs[jnp.float64][:, w]]}", flush=True)


def band_mode2(dis: np.ndarray, npos: np.ndarray, asize: int, bsize: int) -> None:
    m = asize + bsize
    scores, valid = {}, None
    for dt in (jnp.float32, jnp.float64):
        s, _, v = jcss._score_pipeline(jnp.asarray(dis.astype(dt)), jnp.asarray(npos), None,
                                       asize, bsize, 2, 300, 1, 1e-6)
        scores[dt], valid = np.asarray(s), np.asarray(v)
    plain = tcss.css_smacof_plain(torch.from_numpy(dis.astype(np.float32)),
                                  torch.from_numpy(npos), asize, bsize, 2, None, None)
    f64 = scores[jnp.float64][valid]
    for label, got in (("JAX float32", scores[jnp.float32][valid]),
                       ("the port's plain float32", plain[0].double().numpy()[valid])):
        r = _rel(got, f64)
        print(f"m={m} mode 2: {int(valid.sum())} windows, {label} vs JAX float64 max "
              f"{r.max():.3e} q90 {np.quantile(r, 0.9):.3e}", flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    mds = 1
    if args[:1] == ["--mds"]:
        mds, args = int(args[1]), args[2:]
    for arg in args or ["21"]:
        m, n, lanes = (arg.split(":") + ["", ""])[:3]
        band(int(m), int(n) if n else None, int(lanes) if lanes else tcss.WARP_LANES, mds)
