"""K1's LUT build on the card: its kernel-only time at four panels in both
precisions, the wrapper's host time a call, and the LUT builds and sorts
that the main path's entry points launch.

* The build (``fet_lut``) at 11 + 10, 15 + 15, 20 + 20 and 38 + 38 (the
  LUT regime's extent, K1r's panels), fast and exact: the median of 11
  calls, each enqueued behind a busy kernel (``chip_smoke.median_ms(...,
  queued=True)``: the kernel alone); the mean of 20 calls back to back
  (``chip_smoke.cuda_ms``: the wrapper's host time shows there too); the
  host's time a wrapper call (the mean of 200 calls' enqueue, host clock),
  and the LUT's largest error against its plain version.  Beside them the
  same median of a one-element add (the floor of the method).
* The launches of ``fet_lut_build`` and ``fet_lut_rank`` in one
  ``run_fet`` on the bench chromosome (8 M SNPs / 400 Mbp at 11 + 10), one
  ``run-fet`` CLI run and one ``run-all`` on a four-chromosome GTrack pair,
  and one call of the sharded step (float64), each cold (the LUT cache
  cleared, where the tree has one) and then warm, in both precisions but
  the step's.

    python tests/measure_lut_build.py [--root DIR] [--no-counts]

(--root: another tree whose ``divergence_tpu_torch`` to import, e.g. the
parent commit's unpacked by ``git archive`` into a gitignored directory.)"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PANELS = ((11, 10), (15, 15), (20, 20), (38, 38))
BENCH = (8_000_000, 400_000_000, 11, 10, 7)
CHROMS, CHROM_SNPS, CHROM_REGION = 4, 20_000, 1_000_000


def clear_cache(kfet) -> None:
    clear = getattr(kfet, "clear_lut_cache", None)
    if clear is not None:
        clear()


def builds(kfet) -> dict:
    return {k: kfet.LAUNCHES[k] for k in ("fet_lut_build", "fet_lut_rank")}


def counted(kfet, fn) -> dict:
    kfet.reset_launches()
    fn()
    return builds(kfet)


def time_build(torch, cs, fn) -> dict:
    out = {"queued_median_ms": cs.median_ms(torch, fn, 11, queued=True),
           "back_to_back_mean_ms": cs.cuda_ms(torch, fn, 20)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fn()
    out["host_us_a_call"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    return out


def panel_times(torch, cs, kfet, dev) -> None:
    one = torch.zeros(1, device=dev)
    print(f"[floor] one add to a 1-element tensor, queued median of 11: "
          f"{cs.median_ms(torch, lambda: one.add_(1.0), 11, queued=True)} ms", flush=True)
    for a, b in PANELS:
        maxs, nmax = kfet.support_size(a, b), a + b + 2
        for prec, dt in (("fast", torch.float32), ("exact", torch.float64)):
            fn = lambda: kfet.fet_lut(a, b, maxs, nmax, dt, dev)  # noqa: E731, B023
            row = {"G": (a + 1) ** 2 * (b + 1) ** 2, "build": time_build(torch, cs, fn)}
            k = fn()
            row["max_rel_err_plain"] = cs.rel_err(k, kfet.fet_lut_plain(a, b, maxs, nmax, dt, dev))
            print(f"[build {a}+{b} {prec}] {row}", flush=True)


def launch_counts(torch, cs, kfet, dev) -> None:
    import numpy as np

    from divergence_tpu_torch.config import FetConfig
    from divergence_tpu_torch.core.windows import plan_windows
    from divergence_tpu_torch.engine import SnpPair, run_fet
    from divergence_tpu_torch.parallel import make_divergence_step, make_mesh
    from divergence_tpu_torch.tools import cli
    from divergence_tpu_torch.tools.synth import make_chromosome, make_panel

    snps, region, a, b, seed = BENCH
    positions, am, bm = make_chromosome(snps, region, a, b, seed)
    pair = SnpPair(positions, am, bm)
    for prec in ("fast", "exact"):
        cfg = FetConfig(precision=prec)
        run = lambda: run_fet(pair, region, cfg, device=dev, seqid="chrBench")  # noqa: E731, B023
        clear_cache(kfet)
        cold = counted(kfet, run)
        warm = counted(kfet, run)
        print(f"[run_fet bench {prec}] cold {cold} warm {warm}", flush=True)
    del pair

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_lut_", dir=ROOT) as d:
        tmp = Path(d)
        pa, pb, sizes = cs.write_fet_pair(tmp, CHROMS, CHROM_SNPS, CHROM_REGION)
        inputs = ["--pop-a", str(pa), "--pop-b", str(pb), "--chrom-sizes", str(sizes),
                  "--device", str(dev)]
        for prec in ("fast", "exact"):
            run = lambda: cli.main(["run-fet", *inputs, "--precision", prec,  # noqa: E731, B023
                                    "--out", str(tmp / f"fet_{prec}.track")])
            clear_cache(kfet)
            cold = counted(kfet, run)
            warm = counted(kfet, run)
            print(f"[run-fet CLI, {CHROMS} chromosomes, {prec}] cold {cold} warm {warm}",
                  flush=True)
            clear_cache(kfet)
            once = counted(kfet, lambda: cli.main(["run-all", *inputs, "--precision", prec,  # noqa: B023
                                                   "--outdir", str(tmp / f"all_{prec}")]))
            print(f"[run-all, {CHROMS} chromosomes, {prec}] cold {once}", flush=True)

    pos, am, bm = make_panel(CHROM_SNPS, CHROM_REGION, 11, 10, seed=8)
    plan = plan_windows(pos, CHROM_REGION, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    vals = torch.from_numpy(np.concatenate([am, bm], axis=1)).to(dev)
    lo, npos, slot = (torch.from_numpy(x[ids].copy()) for x in (plan.lo, plan.npos, plan.slot))
    av, bv, Bp = cs.gather_windows(torch, vals, lo, npos, 128)
    key = torch.tensor([0, 0], dtype=torch.int64)
    step = make_divergence_step(make_mesh(devices=[dev]), 11, 10)   # K10 in float64
    run = lambda: step(av, bv, npos, slot, key)  # noqa: E731
    clear_cache(kfet)
    cold = counted(kfet, run)
    warm = counted(kfet, run)
    print(f"[step, {len(ids)} windows (+{Bp - len(ids)}), exact] cold {cold} warm {warm}",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--no-counts", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs   # its timers; it imports nothing of JAX

    sys.path.insert(0, str(args.root.resolve()))
    for name in [m for m in sys.modules if m.startswith("divergence_tpu_torch")]:
        del sys.modules[name]
    import torch

    from divergence_tpu_torch.kernels import fet as kfet

    if not torch.cuda.is_available():
        print("measure_lut_build: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"[card] {cs.card_line()} | tree {args.root.resolve()} | package "
          f"{Path(kfet.__file__).resolve()}", flush=True)
    from divergence_tpu_torch.kernels import _build

    entry = ""
    for line in _build.build().log.splitlines():   # the LUT kernels' registers and spills
        entry = line if "Compiling entry" in line else entry
        if "fet_lut" in entry and any(w in line for w in ("Compiling entry", "Used", "spill")):
            print("[ptxas]", line.strip(), flush=True)
    panel_times(torch, cs, kfet, dev)
    if not args.no_counts:
        launch_counts(torch, cs, kfet, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
