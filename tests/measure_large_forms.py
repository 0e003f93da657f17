"""Two measurements behind choices of the large-panel and wide-window
kernels, on one CUDA card:

1. K9's shared stream (``css_mc_power_shared``, K7's tile product) against
   exact sums.  For m = 21 to 300 (a stickleback-shaped panel of
   (m + 1) / 2 + m / 2, its first 48 valid CSS windows in fast mode, key
   fold_in(prng_key(7), 2)), the float32 permuted scores of each chunk
   three ways: the kernel (sequential float32 FMAs, tile_gemm's e order),
   the plain version (one float32 matmul) and the product in float64
   rounded once to float32 (the best a float32 score can be).  Per score
   (chunks of one permutation, so s^1 is the score): each version's
   largest error over the product's absolute terms, sum |D_e M_e|, in
   float32 ulps.  Per power sum (chunks of 512, the tests' shape): the
   largest relative error, and the error against the sums' magnitude,
   |k - p| / (n rms^q) with rms^2 = s^2 / n (``power_err``).

2. The FET window body by padded width P = 256 to 32,768: K2
   (float32 and float64 logs) and K2r (int32 rank keys, float64 values)
   on the block body (the window's keys in shared memory, one block a
   window) and on the wide body (no sort: the bootstrap, then a radix
   select of the band of ranks it picks; a persistent grid), launched
   directly, on windows of ~0.6 P SNPs at a fifth of a
   window's step over 8 M random per-SNP scores (the bench FET workload's
   widths at 125 kb to 1 Mb); CUDA event ms, mean of 3 after a
   warm call, and whether the two bodies give the same bits.

    python tests/measure_large_forms.py
"""

import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.modules["jax"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

from divergence_tpu_torch import rng  # noqa: E402
from divergence_tpu_torch.core.windows import plan_windows  # noqa: E402
from divergence_tpu_torch.kernels import css as kcss  # noqa: E402
from divergence_tpu_torch.kernels import fet as kfet  # noqa: E402
from divergence_tpu_torch.kernels import perm as kperm  # noqa: E402
from divergence_tpu_torch.kernels._cuda import dtype_suffix, launch, ptr  # noqa: E402
from divergence_tpu_torch.tools.synth import make_panel  # noqa: E402

PANELS = (21, 64, 128, 200, 300)
WIDTHS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
NSNPS = 8_000_000
PERC, NSAMPLES = 0.95, 100


def event_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def power_err(k: torch.Tensor, p: torch.Tensor, n: int) -> float:
    """Largest |k - p| of [chunks, 3, B] power sums against n rms^q, rms^2
    = p[:, 1] / n: each sum's error against its magnitude."""
    rms = (p[:, 1:2] / n).sqrt()
    q = torch.arange(1, 4, device=p.device, dtype=p.dtype)[None, :, None]
    return float(((k - p).abs() / (n * rms ** q)).max())


def panel_windows(m: int, dev, limit: int = 48):
    a, b = (m + 1) // 2, m // 2
    pos, am, bm = make_panel(40_000, 2_000_000, a, b, seed=m)
    plan = plan_windows(pos, 2_000_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    vals = torch.from_numpy(np.concatenate([am, bm], axis=1)).to(dev)
    lo, npos = (torch.from_numpy(x[ids].copy()) for x in (plan.lo, plan.npos))
    _, d, v = kcss.css_phase1(vals, lo, npos, a, b, fast=True)
    return d[v][:limit].float().contiguous(), a, b


def k9_shared(dev) -> None:
    key = rng.fold_in(rng.prng_key(7), 2).to(dev)
    for m in PANELS:
        dist, a, b = panel_windows(m, dev)
        B = dist.shape[0]
        flat = dist.reshape(B, m * m)

        def best(chunk, k0, n_chunks):
            """Power sums of the float64 product rounded once to float32,
            and the largest sum |D_e M_e| of a score."""
            out = torch.empty((n_chunks, 3, B), dtype=torch.float64, device=dev)
            absmax = 0.0
            for i in range(n_chunks):
                M = kperm._shared_coeff(key, k0 + i, m, a, b, chunk).double()
                s = (flat.double() @ M).float().double()
                absmax = max(absmax, float((flat.double().abs() @ M.abs()).max()))
                out[i] = torch.stack([s.sum(-1), (s * s).sum(-1), (s * s * s).sum(-1)])
            return out, absmax

        # per score: chunks of one permutation, s^1 the score itself
        k1 = kperm.null_power_sums(dist, key, a, b, 1, 0, 64, "shared")[:, 0]
        p1 = kperm.null_power_sums_plain(dist, key, a, b, 1, 0, 64, "shared")[:, 0]
        x1, absmax = best(1, 0, 64)
        ulp = float(np.finfo(np.float32).eps) * absmax
        ek = float((k1 - x1[:, 0]).abs().max()) / ulp
        ep = float((p1 - x1[:, 0]).abs().max()) / ulp
        # power sums at the tests' shape: 2 chunks of 512
        k = kperm.null_power_sums(dist, key, a, b, 512, 3, 2, "shared")
        p = kperm.null_power_sums_plain(dist, key, a, b, 512, 3, 2, "shared")
        x = best(512, 3, 2)[0]
        rel = lambda u, v: float(((u - v).abs() / v.abs().clamp(min=1e-300)).max())  # noqa: E731
        print(f"K9 shared m = {m} ({a} + {b}), {B} windows: per score, error over the "
              f"largest sum |D M| ({absmax:.3e}) in float32 ulps: kernel {ek:.2f}, plain "
              f"{ep:.2f}; power sums (2 chunks of 512) relative: kernel-plain "
              f"{rel(k, p):.3e}, kernel-best {rel(k, x):.3e}, plain-best {rel(p, x):.3e}; "
              f"against magnitude: kernel-plain {power_err(k, p, 512):.3e}, kernel-best "
              f"{power_err(k, x, 512):.3e}, plain-best {power_err(p, x, 512):.3e}", flush=True)


def fet_bodies(dev) -> None:
    rs = np.random.default_rng(7)
    logs64 = torch.from_numpy(rs.exponential(size=NSNPS)).to(dev)
    lut = torch.from_numpy(np.sort(rs.exponential(size=4096))).to(dev)
    ranks = torch.from_numpy(rs.integers(0, 4096, size=NSNPS, dtype=np.int32)).to(dev)
    key = (5, 9)
    # a block's opt-in shared memory: the block body's keys and replicates
    # must fit it (a refused launch would leave its error for the next)
    smem = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    cases = (("K2", torch.float32, torch.float32), ("K2", torch.float64, torch.float64),
             ("K2r", torch.int32, torch.float64))
    for P in WIDTHS:
        n = int(0.6 * P)
        lo = torch.arange(0, NSNPS - P, n // 5, dtype=torch.int64)
        npos = torch.from_numpy(rs.integers(n - n // 10, n + n // 10, size=lo.numel()))
        slot = torch.arange(lo.numel(), dtype=torch.int64)
        rows, pmax = kfet._window_rows(lo, npos, slot, NSNPS, dev)
        assert pmax == P, (pmax, P)
        B = lo.numel()
        for name, kdt, vdt in cases:
            kb = torch.empty(0, dtype=kdt).element_size()
            vb = torch.empty(0, dtype=vdt).element_size()
            big = 1 << 20
            # the wide body's slabs of P keys (two a block of its grid)
            slabs = kfet._window_form(big, NSAMPLES, kb, vb, dev)[1] // (big * kb)
            scratch = torch.empty(slabs * P, dtype=kdt, device=dev)
            sfx = dtype_suffix(vdt)
            if name == "K2":
                src = logs64.to(vdt)
                head = (ptr(src), ptr(rows), B)
                stem = "fet_aggregate"
            else:
                head = (ptr(lut), lut.numel(), ptr(ranks), ptr(rows), B)
                stem = "fet_aggregate_ranks"
            args = (*head, ctypes.c_uint32(key[0]), ctypes.c_uint32(key[1]),
                    ctypes.c_double(PERC), NSAMPLES, P)
            outs = {f: torch.empty((2, B), dtype=vdt, device=dev) for f in ("block", "wide")}
            counts = dict(kfet.LAUNCHES)
            ms = {"wide": event_ms(lambda: launch(  # noqa: B023
                counts, f"{stem}_wide", f"{stem}_wide_{sfx}", dev, *args,  # noqa: B023
                kfet.WIDE_BAND_KEYS, ptr(scratch),  # noqa: B023
                ptr(outs["wide"])))}  # noqa: B023
            if kb * P + vb * NSAMPLES > smem:
                print(f"{name} {str(vdt)[6:]} keys {str(kdt)[6:]} P = {P}: {B} windows, "
                      f"wide body {ms['wide']:.3f} ms; the block body does not fit",
                      flush=True)
                continue
            ms["block"] = event_ms(lambda: launch(  # noqa: B023
                counts, stem, f"{stem}_{sfx}", dev, *args, ptr(outs["block"])))  # noqa: B023
            same = torch.equal(outs["block"].view(torch.uint8), outs["wide"].view(torch.uint8))
            print(f"{name} {str(vdt)[6:]} keys {str(kdt)[6:]} P = {P}: {B} windows of "
                  f"~{n} SNPs, block body {ms['block']:.3f} ms, wide body {ms['wide']:.3f} ms "
                  f"(block / wide {ms['block'] / ms['wide']:.2f}); the same bits: {same}",
                  flush=True)


def main() -> None:
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip(), flush=True)
    k9_shared(dev)
    fet_bodies(dev)


if __name__ == "__main__":
    main()
