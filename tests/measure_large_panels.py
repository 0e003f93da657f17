"""The measurements behind two choices of the large-panel path, on the
card, at 70 + 58 and 110 + 90:

* K3's form: the warp form (a warp per window, all its counts in shared
  memory, fewer warps a block as m grows) against the tile form
  (``css_dissim_tiles``) on the 19,997 windows of the 200 k-SNP / 10 Mbp
  workload, each launched directly, both precisions (CUDA events, mean
  of 3), the counts equal;
* the shared stream's range schedule: ``run_css`` (CMDS, fast, 20,000
  permutations) on the 997 windows of the 10 k-SNP / 500 kbp workload
  under coefficient caps (``kernels/perm.py:_RANGE_COEFF_BYTES``) of
  64 MB (the cap before the large panels), 256 MB, 1 GB and 4 GB: warm
  walls (3 after one warm-up) and the ranges (one host sync each), the p
  values equal across caps.

On a machine with a card:

    python tests/measure_large_panels.py"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from divergence_tpu_torch.config import CssConfig  # noqa: E402
from divergence_tpu_torch.core.windows import plan_windows  # noqa: E402
from divergence_tpu_torch.engine import SnpPair, run_css  # noqa: E402
from divergence_tpu_torch.kernels import css as kcss  # noqa: E402
from divergence_tpu_torch.kernels import perm as kperm  # noqa: E402
from divergence_tpu_torch.kernels._cuda import dtype_suffix, launch, ptr  # noqa: E402
from divergence_tpu_torch.tools.synth import make_chromosome  # noqa: E402

CAPS = (64 << 20, 256 << 20, 1 << 30, 4 << 30)


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def k3_forms(a: int, b: int, dev) -> None:
    m = a + b
    pos, am, bm = make_chromosome(200_000, 10_000_000, a, b, 7)
    plan = plan_windows(pos, 10_000_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    vals = torch.from_numpy(np.concatenate([am, bm], axis=1).astype(np.int16)).to(dev)
    lo = torch.from_numpy(plan.lo[ids].copy()).to(dev)
    npos = torch.from_numpy(plan.npos[ids].copy()).to(dev)
    want = kcss.dissimilarity_plain(vals, lo, npos)
    B, N = lo.numel(), vals.shape[0]
    planes = torch.empty((2, (N + 31) // 32 + 1, m), dtype=torch.int32, device=dev)
    for dt in (torch.float32, torch.float64):
        out = {}
        ms = {}
        for form in ("css_dissim", "css_dissim_tiles"):
            o = torch.empty((B, m, m), dtype=dt, device=dev)
            ms[form] = event_ms(lambda: launch(  # noqa: B023
                kcss.LAUNCHES, form, f"{form}_{dtype_suffix(dt)}", dev, ptr(vals), N, ptr(lo),
                ptr(npos), B, m, ptr(planes), ptr(o)), 3)
            out[form] = o
        same = all(torch.equal(o.double(), want) for o in out.values())
        print(f"K3 {a}+{b} {str(dt)[6:]}: {B} windows, warp form {ms['css_dissim']:.3f} ms, "
              f"tile form {ms['css_dissim_tiles']:.3f} ms; counts equal to the plain "
              f"version: {same}", flush=True)


def range_caps(a: int, b: int, dev) -> None:
    pair = SnpPair(*make_chromosome(10_000, 500_000, a, b, 11))
    cfg = CssConfig(precision="fast", mc_runs=20_000)
    saved = kperm._RANGE_COEFF_BYTES
    first = None
    try:
        for cap in CAPS:
            kperm._RANGE_COEFF_BYTES = cap
            _, p = run_css(pair, 500_000, cfg, device=dev)
            first = p if first is None else first
            scans = kperm.LAUNCHES["css_mc_scan"]
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                run_css(pair, 500_000, cfg, device=dev)
                walls.append((time.perf_counter() - t0) * 1e3)
            ranges = (kperm.LAUNCHES["css_mc_scan"] - scans) // 3
            print(f"run_css {a}+{b} fast, coefficient cap {cap >> 20} MB: warm walls "
                  f"{', '.join(f'{w:.1f}' for w in walls)} ms, {ranges} ranges, p equal to "
                  f"the first cap's: {np.array_equal(p, first)}", flush=True)
    finally:
        kperm._RANGE_COEFF_BYTES = saved


def main() -> None:
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip())
    for a, b in ((70, 58), (110, 90)):
        k3_forms(a, b, dev)
        range_caps(a, b, dev)


if __name__ == "__main__":
    main()
