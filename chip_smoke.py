#!/usr/bin/env python3
"""Smoke run of ``divergence_tpu_torch`` — the FET scan (``run-fet``) on one
CUDA GPU, at the JAX package's bench scale.

Usage, from the repository root, on a machine with one CUDA GPU::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card (``nvidia-smi`` name and power limit) and the nvcc build of
   ``divergence_tpu_torch/csrc``;
2. every kernel against its plain torch version on the card, at the main
   path's shapes, in both precisions: K1's LUT build at 11+10, K1 per SNP
   at 8 M SNPs (11+10, LUT) and at 1 M SNPs on a 48+48 panel (no LUT), K2
   on the ~800 k windows of the bench chromosome; plus the reference's
   golden tables;
3. the CLI slice: a seeded 500 k-SNP / 25 Mbp GTrack pair (11+10) through
   ``run-fet`` in both precisions;
4. the library: ``run_fet`` on the 8 M-SNP / 400 Mbp bench chromosome in
   both precisions (warm wall time, SNP tests/s), and ``run_fet_multi`` on
   the card against the plain torch path on the CPU on a small genome.

Kernel launch counts are reset before phase 3 and read after phase 4.  The
last three lines are a JSON line of per-kernel results, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.

Tolerances (relative to max(|reference|, 1)): exact (float64) 1e-12, fast
(float32) 1e-5.  K2's stddev must meet them on at least 99.99 % of windows:
a window beyond would be a ceil(n*u) rank flip from a 1-ulp difference in
pow; the count is printed.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# The port must run where JAX is absent: make any import of it fail here.
sys.modules["jax"] = None

ROOT = Path(__file__).resolve().parent
TOL = {"exact": 1e-12, "fast": 1e-5}
STDDEV_BEYOND_SHARE = 1e-4      # at most 0.01 % of windows beyond TOL
GOLDEN_TABLES = [[2, 7, 8, 2], [2, 3, 6, 4], [2, 2, 3, 3], [1, 3, 2, 3]]
GOLDEN_P = [0.0230141, 0.6083916, 1.0, 1.0]   # tests/test_fet_kernel.py

# the bench's FET workload (bench.py: one human-chromosome-1-scale
# chromosome, 11 + 10 stickleback panel)
BENCH_SNPS, BENCH_REGION, BENCH_SEED = 8_000_000, 400_000_000, 7
# the CLI slice: one stickleback chromosome's scale
CLI_SNPS, CLI_REGION = 500_000, 25_000_000
# the large-panel K1 check: no LUT at 48 + 48
BIG_SNPS, BIG_REGION = 1_000_000, 50_000_000
ASIZE, BSIZE = 11, 10
REPLACES = {
    "fet_lut_build": "divergence_tpu/kernels/fet.py:372",
    "fet_snp_logs": "divergence_tpu/kernels/fet.py:318",
    "fet_aggregate": "divergence_tpu/kernels/fet.py:630",
}
SOURCES = {
    "fet_lut_build": "divergence_tpu_torch/csrc/fet_snp.cu",
    "fet_snp_logs": "divergence_tpu_torch/csrc/fet_snp.cu",
    "fet_aggregate": "divergence_tpu_torch/csrc/fet_aggregate.cu",
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def rel_err(got, ref) -> float:
    """max |got - ref| / max(|ref|, 1) over every element."""
    got, ref = got.double(), ref.double()
    if ref.numel() == 0:
        return 0.0
    return float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())


def abs_err(got, ref) -> float:
    if ref.numel() == 0:
        return 0.0
    return float((got.double() - ref.double()).abs().max())


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` warm calls (CUDA events)."""
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


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False,
    )
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def phase_build(kfet_build) -> None:
    info = kfet_build.build()
    say(f"[build] nvcc {info.seconds:.2f} s -> {info.path.name}")
    for line in info.log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            say("[build]", line.strip())


def phase_kernels(torch, kfet, pair, plan_ids, dev, results) -> None:
    """Phase 2: kernel vs plain torch on the card, both precisions."""
    import numpy as np

    from divergence_tpu_torch.engine.fet_engine import chromosome_key
    from divergence_tpu_torch.tools.synth import make_chromosome

    maxs = kfet.support_size(ASIZE, BSIZE)
    nmax = ASIZE + BSIZE + 2
    vals = pair.to_device(dev)
    _, big_a, big_b = make_chromosome(BIG_SNPS, BIG_REGION, 48, 48, 11)
    big_vals = torch.from_numpy(np.concatenate([big_a, big_b], axis=1)).to(dev)
    check(not kfet.lut_active(48, 48), "48+48 panel must take the direct scan")
    big_maxs, big_nmax = kfet.support_size(48, 48), 48 + 48 + 2
    lo, npos, slot = plan_ids
    key = chromosome_key(0, "chrBench")

    for prec in ("fast", "exact"):
        fast = prec == "fast"
        dt = torch.float32 if fast else torch.float64
        tol = TOL[prec]

        # K1: LUT build at 11 + 10
        k = kfet.fet_lut(ASIZE, BSIZE, maxs, nmax, dt, dev)
        p = kfet.fet_lut_plain(ASIZE, BSIZE, maxs, nmax, dt, dev)
        torch.cuda.synchronize()
        err = rel_err(k, p)
        ms = cuda_ms(torch, lambda: kfet.fet_lut(ASIZE, BSIZE, maxs, nmax, dt, dev), 20)
        pms = cuda_ms(torch, lambda: kfet.fet_lut_plain(ASIZE, BSIZE, maxs, nmax, dt, dev), 5)
        say(f"[K1 fet_lut_build {prec}] G={k.numel()} max_rel_err={err:.3e} "
            f"(tol {tol:g}) kernel {ms:.4f} ms plain {pms:.4f} ms")
        check(err <= tol, f"fet_lut_build {prec}: {err} > {tol}")
        results["fet_lut_build"][prec] = (abs_err(k, p), err, ms, pms)

        # golden tables through the LUT (11 + 10) and the direct scan (48 + 48)
        t = torch.tensor(GOLDEN_TABLES, device=dev)
        idx = ((t[:, 0] * (ASIZE + 1) + t[:, 1]) * (BSIZE + 1) + t[:, 2]) * (BSIZE + 1) + t[:, 3]
        p_lut = torch.pow(10.0, -k[idx].double()).cpu()
        rows = torch.zeros((4, 96), dtype=torch.int16)
        for r, (f0, f1, f2, f3) in enumerate(GOLDEN_TABLES):
            rows[r, :f0] = 3
            rows[r, f0:f0 + f1] = -3
            rows[r, 48:48 + f2] = 3
            rows[r, 48 + f2:48 + f2 + f3] = -3
        direct = kfet.fet_snp_logs(rows.to(dev), 48, big_maxs, big_nmax, fast)
        p_dir = torch.pow(10.0, -direct.double()).cpu()
        want = torch.tensor(GOLDEN_P, dtype=torch.float64)
        gerr = max(rel_err(p_lut, want), rel_err(p_dir, want))
        say(f"[golden {prec}] p(LUT)={p_lut.tolist()} p(scan)={p_dir.tolist()} "
            f"max_rel_err={gerr:.2e} (tol 1e-5, the golden values' digits)")
        check(gerr <= 1e-5, f"golden tables {prec}: {gerr}")

        # K1 per SNP: 8 M SNPs (LUT) and 1 M SNPs at 48 + 48 (direct scan)
        ks = kfet.fet_snp_logs(vals, ASIZE, maxs, nmax, fast)
        ps = kfet.fet_snp_logs_plain(vals, ASIZE, maxs, nmax, fast)
        kb = kfet.fet_snp_logs(big_vals, 48, big_maxs, big_nmax, fast)
        pb = kfet.fet_snp_logs_plain(big_vals, 48, big_maxs, big_nmax, fast)
        torch.cuda.synchronize()
        err_s, err_b = rel_err(ks, ps), rel_err(kb, pb)
        ms = cuda_ms(torch, lambda: kfet.fet_snp_logs(vals, ASIZE, maxs, nmax, fast), 10)
        pms = cuda_ms(torch, lambda: kfet.fet_snp_logs_plain(vals, ASIZE, maxs, nmax, fast), 3)
        ms_b = cuda_ms(torch, lambda: kfet.fet_snp_logs(big_vals, 48, big_maxs, big_nmax, fast), 5)
        pms_b = cuda_ms(torch, lambda: kfet.fet_snp_logs_plain(big_vals, 48, big_maxs, big_nmax, fast), 2)
        say(f"[K1 fet_snp_logs {prec}] N={ks.numel()} 11+10 LUT: "
            f"max_rel_err={err_s:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms; "
            f"N={kb.numel()} 48+48 scan: max_rel_err={err_b:.3e} kernel "
            f"{ms_b:.4f} ms plain {pms_b:.4f} ms (tol {tol:g})")
        check(err_s <= tol and err_b <= tol, f"fet_snp_logs {prec}: {err_s}, {err_b}")
        check(bool(torch.isfinite(ks).all()) and bool(torch.isfinite(kb).all()),
              f"fet_snp_logs {prec}: non-finite scores")
        results["fet_snp_logs"][prec] = (
            max(abs_err(ks, ps), abs_err(kb, pb)), max(err_s, err_b), ms, pms
        )

        # K2 on every window of the bench chromosome
        agg = lambda: kfet.fet_aggregate(ks, lo, npos, slot, key, 0.95, 100)  # noqa: E731
        ka = agg()
        pa = kfet.fet_aggregate_plain(ks, lo, npos, slot, key, 0.95, 100)
        torch.cuda.synchronize()
        err_sc = rel_err(ka[0], pa[0])
        sd_rel = ((ka[1].double() - pa[1].double()).abs()
                  / pa[1].double().abs().clamp(min=1.0))
        beyond = int((sd_rel > tol).sum())
        within = sd_rel[sd_rel <= tol]
        err_sd = float(within.max()) if within.numel() else 0.0
        ms = cuda_ms(torch, agg, 10)
        pms = cuda_ms(
            torch, lambda: kfet.fet_aggregate_plain(ks, lo, npos, slot, key, 0.95, 100), 2
        )
        B = lo.numel()
        say(f"[K2 fet_aggregate {prec}] B={B} windows: scores max_rel_err="
            f"{err_sc:.3e} (tol {tol:g}); stddev max_rel_err={err_sd:.3e} on "
            f"{B - beyond} windows, {beyond} beyond tol (allowed "
            f"{int(STDDEV_BEYOND_SHARE * B)}); kernel {ms:.4f} ms plain {pms:.4f} ms")
        check(err_sc <= tol, f"fet_aggregate {prec} scores: {err_sc}")
        check(beyond <= STDDEV_BEYOND_SHARE * B,
              f"fet_aggregate {prec} stddev: {beyond} windows beyond {tol}")
        check(bool(torch.isfinite(ka).all()), f"fet_aggregate {prec}: non-finite")
        results["fet_aggregate"][prec] = (
            max(abs_err(ka[0], pa[0]), float((ka[1].double() - pa[1].double()).abs().max())),
            max(err_sc, float(sd_rel.max())), ms, pms,
        )
        results["fet_aggregate"][prec + "_beyond"] = beyond
        results["fet_aggregate"][prec + "_out"] = ka


def phase_cli(torch, kfet, dev, tmp: Path) -> None:
    """Phase 3: run-fet through the CLI on a 500 k-SNP GTrack pair."""
    import numpy as np

    from divergence_tpu_torch.io import read_score_track
    from divergence_tpu_torch.tools import cli, synth

    t0 = time.perf_counter()
    pos, am, bm = synth.make_panel(CLI_SNPS, CLI_REGION, ASIZE, BSIZE, seed=5)
    a_path, b_path = tmp / "popA.gtrack", tmp / "popB.gtrack"
    synth.write_gtrack(a_path, "chrI", pos, am)
    synth.write_gtrack(b_path, "chrI", pos, bm)
    sizes = tmp / "chrom.sizes"
    sizes.write_text(f"chrI\t{CLI_REGION}\n")
    say(f"[cli] wrote a {CLI_SNPS}-SNP / {CLI_REGION} bp GTrack pair "
        f"({ASIZE}+{BSIZE}) in {time.perf_counter() - t0:.2f} s")
    tracks = {}
    for prec in ("fast", "exact"):
        out = tmp / f"fet_{prec}.track"
        summary = tmp / f"fet_{prec}.json"
        t0 = time.perf_counter()
        cli.main([
            "run-fet", "--pop-a", str(a_path), "--pop-b", str(b_path),
            "--out", str(out), "--chrom-sizes", str(sizes),
            "--precision", prec, "--summary", str(summary), "--device", str(dev),
        ])
        wall = time.perf_counter() - t0
        _, starts, sc, sd = read_score_track(out)
        n_nan = int(np.isnan(sc).sum() + np.isnan(sd).sum())
        timings = json.loads(summary.read_text())["timings_s"]
        say(f"[cli {prec}] {len(starts)} scored windows, {n_nan} NaN, wall "
            f"{wall:.2f} s (run-fet in-process, GTrack parse included; "
            f"engine {timings.get('chrI', 0.0):.3f} s)")
        check(len(starts) > 0 and n_nan == 0, f"cli {prec}: bad track")
        check(bool(np.isfinite(sc).all() and np.isfinite(sd).all()), f"cli {prec}")
        nslots = CLI_REGION // 500
        dense = np.zeros(nslots)
        dense[starts // 500] = sc
        tracks[prec] = dense
    err = float(np.max(np.abs(tracks["fast"] - tracks["exact"])
                       / np.maximum(np.abs(tracks["exact"]), 1.0)))
    say(f"[cli] fast vs exact scores max_rel_err={err:.3e} (tol 1e-5: float32 "
        "rounding of the same statistic)")
    check(err <= 1e-5, f"cli fast vs exact: {err}")
    check(all(v > 0 for v in kfet.LAUNCHES.values()),
          f"cli slice did not launch every kernel: {kfet.LAUNCHES}")
    say(f"[cli] launch counts so far: {kfet.LAUNCHES}")


def phase_library(torch, pair, n_tests, dev, card, k2_out) -> None:
    """Phase 4: run_fet at bench scale; run_fet_multi vs the CPU path."""
    import numpy as np

    from divergence_tpu_torch.config import FetConfig
    from divergence_tpu_torch.engine import SnpPair, run_fet, run_fet_multi
    from divergence_tpu_torch.tools.synth import make_panel

    for prec in ("fast", "exact"):
        cfg = FetConfig(precision=prec)
        run = lambda: run_fet(pair, BENCH_REGION, cfg, device=dev, seqid="chrBench")  # noqa: E731
        scores, stddev = run()        # warm-up
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            scores, stddev = run()
            walls.append(time.perf_counter() - t0)
        nslots = cfg.window.num_slots(BENCH_REGION)
        check(scores.shape == (nslots,) and stddev.shape == (nslots,),
              f"run_fet {prec}: shape {scores.shape}")
        check(bool(np.isfinite(scores).all() and np.isfinite(stddev).all()),
              f"run_fet {prec}: non-finite output")
        scored = int((scores != 0).sum())
        check(scored > 0, f"run_fet {prec}: no scored window")
        # the engine's result is K2's on the same windows and key
        ka = k2_out[prec].double().cpu().numpy()
        slots = k2_out["slots"]
        same = np.array_equal(scores[slots], ka[0]) and np.array_equal(stddev[slots], ka[1])
        check(same, f"run_fet {prec} differs from the K2 launch of phase 2")
        best = min(walls)
        say(f"[library {prec}] run_fet {BENCH_SNPS} SNPs / {BENCH_REGION} bp: "
            f"{nslots} slots, {scored} scored; warm wall min {best:.4f} s "
            f"median {float(np.median(walls)):.4f} s; {n_tests / best:,.0f} "
            f"SNP tests/s ({n_tests} tests) on {card}")

    # the card against the plain torch path on the CPU, small genome
    pairs = {}
    for i, seqid in enumerate(("chrII", "chrIII", "chrIV")):
        pos, am, bm = make_panel(20_000, 1_000_000, ASIZE, BSIZE, seed=20 + i)
        pairs[seqid] = (SnpPair(pos, am, bm), 1_000_000)
    for prec in ("fast", "exact"):
        cfg = FetConfig(precision=prec, seed=3)
        gpu = run_fet_multi(pairs, cfg, device=dev)
        for seqid, (p, regend) in pairs.items():
            cpu = run_fet(p, regend, cfg, device="cpu", seqid=seqid)
            for col, name in ((0, "scores"), (1, "stddev")):
                a, b = gpu[seqid][col], cpu[col]
                err = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))
                check(err <= TOL[prec], f"{seqid} {prec} {name}: {err}")
        say(f"[library {prec}] run_fet_multi on the card == run_fet on the CPU "
            f"(3 x 20000 SNPs) within {TOL[prec]:g}")


def smoke(torch, dev) -> tuple[str, list[dict]]:
    """Every phase on ``dev``; returns (card line, per-kernel results).
    Raises on the first failure."""
    import numpy as np

    from divergence_tpu_torch.core.windows import plan_windows
    from divergence_tpu_torch.engine import SnpPair
    from divergence_tpu_torch.kernels import _build
    from divergence_tpu_torch.kernels import fet as kfet
    from divergence_tpu_torch.tools.synth import make_chromosome

    card = card_line()
    say(f"[card] {card} | torch {torch.__version__} CUDA {torch.version.cuda}")
    phase_build(_build)

    t0 = time.perf_counter()
    positions, amat, bmat = make_chromosome(
        BENCH_SNPS, BENCH_REGION, ASIZE, BSIZE, BENCH_SEED
    )
    pair = SnpPair(positions, amat, bmat)
    plan = plan_windows(positions, BENCH_REGION, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    n_tests = int(plan.npos[ids].sum())
    lo, npos, slot = (
        torch.from_numpy(a[ids].copy()) for a in (plan.lo, plan.npos, plan.slot)
    )
    say(f"[data] bench chromosome {BENCH_SNPS} SNPs / {BENCH_REGION} bp, "
        f"{len(ids)} windows, {n_tests} SNP tests, max window "
        f"{int(plan.npos.max())} SNPs ({time.perf_counter() - t0:.2f} s)")

    results = {name: {} for name in REPLACES}
    phase_kernels(torch, kfet, pair, (lo, npos, slot), dev, results)
    k2_out = {
        "fast": results["fet_aggregate"].pop("fast_out"),
        "exact": results["fet_aggregate"].pop("exact_out"),
        "slots": plan.slot[ids],
    }

    kfet.reset_launches()
    tmp = Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT))
    try:
        phase_cli(torch, kfet, dev, tmp)
        phase_library(torch, pair, n_tests, dev, card, k2_out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(kfet.LAUNCHES)
    say(f"[main path] kernel launches: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"main path did not launch every kernel: {launches}")

    kernels = []
    for name in REPLACES:
        r = results[name]
        f_abs, f_rel, f_ms, f_pms = r["fast"]
        e_abs, e_rel, e_ms, e_pms = r["exact"]
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(f_abs, e_abs),
            "ms": f_ms, "plain_ms": f_pms,
            "ms_exact": e_ms, "plain_ms_exact": e_pms,
            "max_rel_err_fast": f_rel, "max_rel_err_exact": e_rel,
        }
        if name == "fet_aggregate":
            entry["stddev_windows_beyond_tol"] = {
                "fast": r["fast_beyond"], "exact": r["exact_beyond"]
            }
        kernels.append(entry)
    return card, kernels


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import divergence_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the divergence_tpu_torch package is missing "
              f"next to this script ({e})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        card, kernels = smoke(torch, torch.device("cuda", 0))
    except Exception as e:  # report any phase's failure, then exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
