#!/usr/bin/env python3
"""Smoke run of ``divergence_tpu_torch`` — the FET scan (``run-fet``), the
CSS scan (``run-css``), the sharded divergence step and the whole pipeline
(``run-all``) on one CUDA GPU, at the JAX package's bench scale.

Usage, from the repository root, on a machine with one CUDA GPU::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card (``nvidia-smi`` name and power limit) and the nvcc build of
   ``divergence_tpu_torch/csrc``;
2. every FET kernel against its plain torch version on the card, at the
   main path's shapes, in both precisions: K1's LUT build at 11+10, K1 per
   SNP at 8 M SNPs (11+10, LUT) and at 1 M SNPs on a 48+48 panel (no LUT),
   K2 on the ~800 k windows of the bench chromosome; plus the reference's
   golden tables;
3. the FET CLI: a seeded 500 k-SNP / 25 Mbp GTrack pair (11+10) through
   ``run-fet`` in both precisions (exact mode takes the rank path, K1r ->
   K2r);
4. the FET library: ``run_fet`` on the 8 M-SNP / 400 Mbp bench chromosome
   in both precisions (warm wall time, SNP tests/s), and ``run_fet_multi``
   on the card against the plain torch path on the CPU on a small genome;
5. every CSS kernel against its plain torch version on the card:
   ``css_dissim`` on the bench chromosome's ~800 k windows (against the
   per-window counts) and on a 500 k-SNP stickleback panel (against the
   prefix), exact integer equality; ``css_cmds`` on the ~800 k windows'
   counts in both precisions; ``css_mc_coeff`` for the first 16 chunks,
   bit-equal; K7 (``css_mc_coeff``, ``css_mc_shared``, ``css_mc_scan``)
   on the bench's 16x worst case (160 k SNPs, nearly every window to the
   200 k cap) and on the 997 windows of the 10 k workload: host wall
   against the plain loop, the launches alone by CUDA events, the
   permutations its ranges computed against those consumed, and the
   torch.matmul yardstick; ``css_mc_scan`` alone on the 16x case's
   deepest range against its plain version;
6. the CSS CLI: ``run-css`` (default fast) on phase 3's GTrack pair;
7. the CSS library: ``run_css`` on the bench's three CSS workloads (warm
   wall, windows/s, MC permutations/s) and a torch.profiler call of each
   and of the 500 k-SNP CLI panel (device busy share, K7's device time),
   and ``run_css_multi`` on the card against ``run_css`` on the CPU on a
   small genome, both precisions;
8. SMACOF (K6) against its plain torch version on the card, both
   precisions: ``css_smacof`` mode 1 (4 random restarts) and mode 2 (from
   CMDS) on the 19,997 windows of the 200 k-SNP / 10 Mbp workload;
   drosophila mode on a 1 M-SNP / 25 Mbp frequency chromosome through
   ``css_cmds`` + K7 and ``css_smacof`` mode 1 at m = 2; and the kernel
   alone, mode 1 fast, on the ~800 k bench windows;
9. the library and CLI with the new options: ``run_css`` with
   ``mds=SMACOF`` and ``mds=CMDS_SMACOF`` on the 200 k-SNP workload and
   with ``drosophila=True`` on the frequency chromosome (warm wall,
   windows/s, MC permutations/s), ``run_css_multi`` on the card against
   ``run_css`` on the CPU (exact, mds 1 and drosophila, 3 x 5,000 SNPs),
   and ``run-css --mds smacof`` / ``run-css --drosophila`` on small files;
10. K7's coefficients under threefry draws (bit-equal, tied draws
   counted), K8 ``css_mc_window`` in its three forms (float32 mix, float32
   threefry, the float64 native form) on the 997 windows of the 10 k-SNP
   workload to the 200 k cap against its plain versions, K8 alone on the
   16x worst case with K7 beside it, K9 ``css_mc_power`` in both streams on
   the 19,997 windows of the 200 k-SNP workload against its plain version
   (and approx p against the plain approx; two calls bit-equal), K9 alone
   on the ~800 k bench windows;
11. the library and CLI with the phase-2 options: ``run_css`` on the 200 k
   workload with approx mode (both streams), the window stream (mix, and
   threefry fast), the shared stream with threefry (fast) and the native
   evaluator, in both precisions; ``run_css_multi`` on the card against
   ``run_css`` on the CPU, exact, each option, with the MC cut to
   ``MULTI_MC_RUNS`` permutations (the window stream's plain loop on the
   host CPU stays within seconds); ``run-css --p-mode approx``,
   ``--mc-stream window --rng threefry`` and ``--perm-backend native`` on
   phase 9's small files;
12. K10 ``fet_window`` (both precisions) and K11 ``css_perm_chunk`` (both
   draw streams) against their plain versions on the 19,997 windows of the
   200 k-SNP workload, K11 again on a 200 k-SNP stickleback-shaped panel
   (whose null is hit) and against K8's first chunk there, and K10 on the
   ~800 k bench windows gathered at P = 128, bit-equal to phase 2's K1 ->
   K2;
13. the sharded step (``make_divergence_step(11, 10)`` at its defaults) on
   those ~800 k windows: warm wall and a torch.profiler call, four shares
   of the card against one (bit-equal), the all-plain step on 20,000 of
   them; ``bench-scaling`` at its defaults; ``run-fet`` and ``run-css``
   with ``--shard`` and with ``--num-hosts 2`` + ``merge-tracks`` on phase
   9's small files, byte-equal to the unsharded tracks;
14. K1r (``fet_lut_rank``, ``fet_snp_ranks``) and K2r
   (``fet_aggregate_ranks``) on the bench FET workload in both precisions:
   the LUT sort against its plain version, exactly, at 11+10 and at 38+38
   (the largest symmetric panel with a LUT, 2.3 M entries); the ranks of 8 M
   SNPs; K2r on the ~800 k windows against its plain version and equal to
   phase 2's K1 -> K2 on every window, timed beside K2; ``run_fet`` exact
   by the old route (K1 -> K2) and the rank route, warm walls in turns;
15. ``run-all`` on phase 3's 500 k-SNP pair at the CLI default (fast) and
   at ``--precision exact`` (tracks byte-equal to phases 3 and 6's staged
   runs; walls and the stage split of ``*_summary.json``), on phase 9's
   small files against the staged subcommands (byte-equal), and with
   ``--num-hosts 2`` (no regions; merged shards = the one-host tracks).

Kernel launch counts are reset before phase 3 and read after phase 4 (the
FET path), reset before phase 6 and read after phase 7 (the CMDS CSS
path), reset before phase 9 and read after it (the SMACOF and drosophila
CSS path), reset before phase 11 and read after it (K8, K9 and K7 under
threefry), reset before phase 13 and read after it (the sharded step:
K10, K3, K5, K11), and reset before phase 15 and read after it (run-all:
K1, K2, K1r, K2r, K3, K5, K7).  The last three lines are a JSON line of per-kernel
results (with each kernel's ``bound_ms``: the larger of its bytes over
3.35 TB/s and its operations over 67 TFLOP/s float32 / 34 TFLOP/s
float64, from this run's inputs; and ``library_ms``, one PyTorch call
computing the same product where one exists), the card's name and power
limit, and ``{"ok": true, "device": {...}}``.

Tolerances (relative to max(|reference|, 1)): FET exact (float64) 1e-12,
fast (float32) 1e-5; K2's stddev must meet them on at least 99.99 % of
windows (a ceil(n*u) rank flip from a 1-ulp pow difference; the count is
printed).  CSS counts and the MC coefficients: exactly equal.  CMDS
scores: exact 1e-9, fast rtol 2e-3 atol 1e-4 (the JAX package's
fast-vs-exact band), on windows whose eigengap (l2 - l3) / max(|l1|, 1)
exceeds 1e-6 (below it the 2-D embedding is the eigensolver's choice; the
excluded windows are counted and may be at most 1 %).  MC: pvals, nscores
and hits identical on at least 99.9 % of windows (a float32 near tie can
flip between summation orders; the count is printed), each differing
window of K7 shown to be a near tie (TIE_RTOL); K7's stop scan equal to
its plain version on every window.  SMACOF: exact 1e-9
on windows whose chosen restart and transform count agree with the plain
version's (a 1e-12 summation-order difference can flip a stop decision
or the best of two near-equal restarts), the rest counted and at most
0.1 %; fast within SMACOF_FAST_BAND, the JAX package's own float32 vs
float64 band measured on the CPU (tests/test_torch_smacof.py), max and
90th percentile.  Drosophila (m = 2) CMDS as the CMDS tolerances, with no
window excluded (there is no third eigenvalue).  K8: (p, n, hits)
identical on at least 99.9 % of windows, each differing window shown to
be a near tie (TIE_RTOL float32, TIE_RTOL_F64 float64).  K9: power sums
within POWER_RTOL, approx nscores identical on 99.9 % of windows and
|log10 p| within LOG10_P_BAND where they agree (tests/test_torch_approx.py,
measured on the CPU).  K10: as K2, and bit-equal to K1 -> K2 on the bench
windows.  K1r: the sorted LUT and its ranks equal to the plain version's,
bit for bit; the 8 M SNPs' ranks those of the kernel's own LUT, their
scores within the FET tolerances of the plain version's.  K2r: as K2, and
equal to K1 -> K2 on every bench window (-0.0 == 0.0).  K11: (hits,
reached, pos) identical on every window.  The step:
per-window outputs bit-equal across 1 and 4 shares; against its all-plain
version FET exact 1e-12, CSS 1e-9 on the eigengap windows, hits equal on
99.9 % of windows.
"""

from __future__ import annotations

import contextlib
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
# CSS: the bench's 16x worst case (bench.py:425) and its three CSS
# workloads (bench.py:357-358, :425, :475-476) with the precisions run
WORST_CSS, WORST_SEED = (160_000, 8_000_000), 11
CSS_WORKLOADS = [
    (10_000, 500_000, 11, ("fast", "exact")),
    (160_000, 8_000_000, 11, ("fast",)),
    (200_000, 10_000_000, 7, ("fast",)),
]
TOL_CSS = 1e-9                   # CMDS scores, exact
FAST_RTOL, FAST_ATOL = 2e-3, 1e-4   # CMDS scores, fast
GAP_BOUND = 1e-6                 # eigengap below which a window is excluded
MC_DIFFER_SHARE = 1e-3           # MC windows allowed to differ (near ties)
# SMACOF: the 200 k-SNP / 10 Mbp workload, a Drosophila-arm-scale
# frequency chromosome (2L is ~23.5 Mbp), the CPU comparison genome
SMACOF_WORKLOAD = CSS_WORKLOADS[2]
DROS_SNPS, DROS_REGION, DROS_SEED = 1_000_000, 25_000_000, 13
MULTI_SNPS, MULTI_REGION = 5_000, 250_000
SMALL_SNPS, SMALL_REGION = 20_000, 1_000_000   # phase 9's CLI files
SMACOF_DIFFER_SHARE = 1e-3       # exact: windows whose restart or count differ
# fast: mds -> (max, 90th percentile) of |f32 - f64| / max(|f64|, 1), the
# JAX package's own band measured on the CPU (tests/test_torch_smacof.py)
SMACOF_FAST_BAND = {1: (5.5e-2, 7e-4), 2: (1.53e-1, 7e-4)}
# the window stream (K8) and approx mode (K9): the 997 windows of the 10 k
# workload to the 200 k cap, the 16x worst case, and the 19,997 windows of
# the 200 k workload at approx mode's chunk (max(mc_chunk, 512)) and two
# chunks; the card-vs-CPU genome's MC cut to 2,000 permutations (the
# window stream's plain loop on the host CPU stays within seconds)
WINDOW_WORKLOAD = CSS_WORKLOADS[0]
MC_RUNS = 200_000                # the MC cap of phases 10-11 (CssConfig's default)
POWER_WORKLOAD = CSS_WORKLOADS[2]
APPROX_CHUNK, APPROX_CHUNKS = 512, 2
MULTI_MC_RUNS = 2_000
TIE_RTOL = 1e-5                  # float32 near tie (tests/test_torch_mc.py)
TIE_RTOL_F64 = 1e-12             # float64 near tie (the native form)
# approx mode (tests/test_torch_approx.py, measured on the CPU): power sums
# relative to the plain version, and |log10 p| where nscores agree
POWER_RTOL, LOG10_P_BAND, NSCORES_SAME_SHARE = 1e-6, 2e-5, 0.999   # m <= 21
# the card's published peaks (NVIDIA's H100 SXM data sheet, dense, at
# 700 W; float32 and float64 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "f64": 34e12}
# the sharded step (phases 12-13): the bench chromosome's windows gathered
# at P = 128 and padded to a multiple of the 4-share check's mesh; the step
# against its all-plain version on the first STEP_PLAIN_WINDOWS of them
STEP_P, STEP_SHARES, STEP_PLAIN_WINDOWS = 128, 4, 20_000
STEP_WORKLOAD = CSS_WORKLOADS[2]   # K10 / K11 against their plain versions
# K11 again where the null is hit (STEP_WORKLOAD's windows are all
# divergent: no permutation reaches their scores): a stickleback-shaped
# panel of the same size, which K11 and K8's first chunk also meet on
HIT_PANEL = (200_000, 10_000_000, 7)
PERM_CHUNK = 128                   # make_divergence_step's mc_chunk default
REPLACES = {
    "fet_lut_build": "divergence_tpu/kernels/fet.py:372",
    "fet_snp_logs": "divergence_tpu/kernels/fet.py:318",
    "fet_aggregate": "divergence_tpu/kernels/fet.py:630",
    "css_dissim": "divergence_tpu/kernels/css.py:55",
    "css_cmds": "divergence_tpu/kernels/css.py:478",
    "css_smacof": "divergence_tpu/kernels/css.py:225",
    "css_mc_coeff": "divergence_tpu/kernels/perm.py:249",
    "css_mc_shared": "divergence_tpu/kernels/perm.py:281",
    "css_mc_scan": "divergence_tpu/kernels/perm.py:362",
    "css_mc_window": "divergence_tpu/kernels/perm.py:164",
    "css_mc_power": "divergence_tpu/kernels/perm.py:599",
    "fet_window": "divergence_tpu/kernels/fet.py:668",
    "css_perm_chunk": "divergence_tpu/kernels/perm.py:396",
    "fet_lut_rank": "divergence_tpu/kernels/fet.py:454",
    "fet_snp_ranks": "divergence_tpu/kernels/fet.py:454",
    "fet_aggregate_ranks": "divergence_tpu/kernels/fet.py:495",
}
SOURCES = {
    "fet_lut_build": "divergence_tpu_torch/csrc/fet_snp.cu",
    "fet_snp_logs": "divergence_tpu_torch/csrc/fet_snp.cu",
    "fet_aggregate": "divergence_tpu_torch/csrc/fet_aggregate.cu",
    "css_dissim": "divergence_tpu_torch/csrc/css_dissim.cu",
    "css_cmds": "divergence_tpu_torch/csrc/css_cmds.cu",
    "css_smacof": "divergence_tpu_torch/csrc/css_smacof.cu",
    "css_mc_coeff": "divergence_tpu_torch/csrc/css_mc.cu",
    "css_mc_shared": "divergence_tpu_torch/csrc/css_mc.cu",
    "css_mc_scan": "divergence_tpu_torch/csrc/css_mc.cu",
    "css_mc_window": "divergence_tpu_torch/csrc/css_mc_window.cu",
    "css_mc_power": "divergence_tpu_torch/csrc/css_mc_power.cu",
    "fet_window": "divergence_tpu_torch/csrc/fet_window.cu",
    "css_perm_chunk": "divergence_tpu_torch/csrc/css_perm_chunk.cu",
    "fet_lut_rank": "divergence_tpu_torch/csrc/fet_rank.cu",
    "fet_snp_ranks": "divergence_tpu_torch/csrc/fet_rank.cu",
    "fet_aggregate_ranks": "divergence_tpu_torch/csrc/fet_aggregate_ranks.cu",
}
# K1r's LUT sort also at the largest symmetric panel where the LUT is on
# (39^4 = 2,313,441 entries; 39 + 39 fails lut_active's 1e8 bound)
RANK_BIG_PANEL = 38
# the FET kernels of run-fet / run_fet: K1 -> K2 in fast mode, K1's LUT
# build -> K1r -> K2r in exact mode (the LUT regime)
FET_PATH = ("fet_lut_build", "fet_snp_logs", "fet_aggregate", "fet_lut_rank",
            "fet_snp_ranks", "fet_aggregate_ranks")
CSS_CMDS_PATH = ("css_dissim", "css_cmds", "css_mc_coeff", "css_mc_shared", "css_mc_scan")


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


def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take for a
    kernel's work, the larger of ``nbytes`` (each input read once, each
    output written once) over the memory rate and the operations over the
    peak rate of their type (``ops``: {"f32": n, "f64": n}; integer
    operations are counted at the float32 rate, an underestimate of their
    time).  A multiply-add is two operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[t] for t, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        if fast:   # a table's support scan: ~4 operations per support point
            results["fet_lut_build"]["bound"] = bound(
                k.numel() * k.element_size(), {"f32": 4 * k.numel() * maxs})

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
        if fast:   # 8 M SNPs: the codes in, the scores out; two compares a code
            results["fet_snp_logs"]["bound"] = bound(
                vals.numel() * 2 + ks.numel() * 4, {"f32": 2 * vals.numel()})

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
        if fast:   # logs and descriptors in, 2 values out; at least one
            # threefry draw (~60 integer operations) per bootstrap sample
            results["fet_aggregate"]["bound"] = bound(
                ks.numel() * 4 + B * 3 * 8 + B * 2 * 4, {"f32": B * 100 * 60})


def phase_cli(torch, kfet, dev, tmp: Path) -> tuple[Path, Path, Path]:
    """Phase 3: run-fet through the CLI on a 500 k-SNP GTrack pair.
    Returns the pair's files and chrom.sizes (phase 6 reuses them)."""
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
    check(all(kfet.LAUNCHES[k] > 0 for k in FET_PATH), f"cli slice did not launch every kernel: "
          f"{kfet.LAUNCHES}")
    say(f"[cli] launch counts so far: {kfet.LAUNCHES}")
    return a_path, b_path, sizes


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


def gap_ok(torch, kcss, dis) -> "torch.Tensor":
    """Windows whose CMDS embedding the eigensolver does not choose:
    (l2 - l3) / max(|l1|, 1) > GAP_BOUND, from float64 eigenvalues of the
    double-centred matrix (computed in window batches)."""
    out = []
    step = kcss._CMDS_BATCH          # the batch cuSOLVER's eigh accepts
    for s in range(0, dis.shape[0], step):
        filled, _ = kcss.fill_averages(dis[s:s + step].double())
        ev = torch.linalg.eigvalsh(kcss.double_centre(filled)).flip(-1)
        out.append((ev[:, 1] - ev[:, 2]) / ev[:, 0].abs().clamp(min=1.0) > GAP_BOUND)
    return torch.cat(out)


def windows_of(torch, positions, region):
    """(lo, npos, slot) host tensors of the valid windows at 2500 / 500."""
    import numpy as np

    from divergence_tpu_torch.core.windows import plan_windows

    plan = plan_windows(positions, region, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    return tuple(torch.from_numpy(a[ids].copy()) for a in (plan.lo, plan.npos, plan.slot))


def phase_css_kernels(torch, pair, plan_ids, dev, results) -> None:
    """Phase 5: the CSS kernels against their plain torch versions on the
    card, both precisions (the MC is float32 in both)."""
    import numpy as np

    from divergence_tpu_torch import rng
    from divergence_tpu_torch.engine import SnpPair
    from divergence_tpu_torch.kernels import css as kcss
    from divergence_tpu_torch.kernels import perm as kperm
    from divergence_tpu_torch.tools.synth import make_chromosome, make_panel

    vals = pair.to_device(dev)
    lo, npos, _ = plan_ids
    npos_d = npos.to(dev)
    pos, am, bm = make_panel(CLI_SNPS, CLI_REGION, ASIZE, BSIZE, seed=5)
    panel = SnpPair(pos, am, bm)
    p_vals = panel.to_device(dev)
    p_lo, p_npos, _ = windows_of(torch, pos, CLI_REGION)
    check((p_vals.shape[0] + 1) * (ASIZE + BSIZE) ** 2 <= kcss.PREFIX_MAX_ELEMS,
          "the stickleback panel must take the prefix twin")
    check((vals.shape[0] + 1) * (ASIZE + BSIZE) ** 2 > kcss.PREFIX_MAX_ELEMS,
          "the bench chromosome must take the counts twin")

    # K3/K4: exact integer counts
    plain64 = kcss.dissimilarity_plain(vals, lo, npos)
    p_plain = kcss.dissimilarity_plain(p_vals, p_lo, p_npos)
    for prec in ("fast", "exact"):
        dt = torch.float32 if prec == "fast" else torch.float64
        k = kcss.css_dissim(vals, lo, npos, dt)
        kp = kcss.css_dissim(p_vals, p_lo, p_npos, dt)
        torch.cuda.synchronize()
        diff = max(abs_err(k, plain64), abs_err(kp, p_plain))
        ms = cuda_ms(torch, lambda: kcss.css_dissim(vals, lo, npos, dt), 5)
        pms = cuda_ms(torch, lambda: kcss.dissimilarity_plain(vals, lo, npos).to(dt), 1)
        ms_p = cuda_ms(torch, lambda: kcss.css_dissim(p_vals, p_lo, p_npos, dt), 5)
        pms_p = cuda_ms(torch, lambda: kcss.dissimilarity_plain(p_vals, p_lo, p_npos).to(dt), 1)
        say(f"[K3 css_dissim {prec}] bench B={lo.numel()} windows vs the counts "
            f"twin, panel B={p_lo.numel()} vs the prefix twin: max_abs_diff={diff} "
            f"(exact counts); kernel {ms:.4f} ms plain {pms:.4f} ms; panel kernel "
            f"{ms_p:.4f} ms plain {pms_p:.4f} ms")
        check(diff == 0.0, f"css_dissim {prec}: counts differ by {diff}")
        results["css_dissim"][prec] = (diff, diff, ms, pms)
        if prec == "fast":   # codes in once, m x m counts out; the pair
            # popcounts (2 per pair and 32-SNP word) are integer operations
            m = ASIZE + BSIZE
            words = int(((npos + 31) // 32).sum())
            results["css_dissim"]["bound"] = bound(
                vals.numel() * 2 + lo.numel() * (16 + m * m * 4),
                {"f32": 4 * words * m * (m - 1) // 2})
        del kp
    del p_plain, p_vals

    # K5: CMDS on the bench windows' counts
    ok = gap_ok(torch, kcss, plain64)
    excluded = int((~ok).sum())
    for prec in ("fast", "exact"):
        dt = torch.float32 if prec == "fast" else torch.float64
        dis = plain64.to(dt)
        ks, kd, kv = kcss.css_cmds(dis, npos_d, ASIZE, BSIZE)
        ps, pd, pv = kcss.css_cmds_plain(dis, npos_d, ASIZE, BSIZE)
        torch.cuda.synchronize()
        check(torch.equal(kv, pv), f"css_cmds {prec}: valid flags differ")
        check(torch.equal(ks.isnan(), ps.isnan()), f"css_cmds {prec}: NaN patterns differ")
        sel = ok & ~ps.isnan()
        got, want = ks.double()[sel], ps.double()[sel]
        err = rel_err(got, want)
        if prec == "exact":
            bad = int((((got - want).abs() / want.abs().clamp(min=1.0)) > TOL_CSS).sum())
            tol_txt = f"tol {TOL_CSS:g}"
        else:
            bad = int(((got - want).abs() > FAST_ATOL + FAST_RTOL * want.abs()).sum())
            tol_txt = f"rtol {FAST_RTOL:g} atol {FAST_ATOL:g}"
        ms = cuda_ms(torch, lambda: kcss.css_cmds(dis, npos_d, ASIZE, BSIZE), 3)
        pms = cuda_ms(torch, lambda: kcss.css_cmds_plain(dis, npos_d, ASIZE, BSIZE), 1)
        say(f"[K5 css_cmds {prec}] B={dis.shape[0]} windows, {excluded} excluded "
            f"(eigengap <= {GAP_BOUND:g}; allowed {int(0.01 * dis.shape[0])}), "
            f"{int(kv.sum())} valid, {int(ks.isnan().sum())} NaN in both: scores "
            f"max_rel_err={err:.3e}, {bad} beyond {tol_txt}; kernel {ms:.4f} ms "
            f"plain {pms:.4f} ms")
        check(excluded <= 0.01 * dis.shape[0], f"css_cmds: {excluded} degenerate windows")
        check(bad == 0, f"css_cmds {prec}: {bad} windows beyond tolerance")
        results["css_cmds"][prec] = (abs_err(got, want), err, ms, pms)
        results["css_cmds"][prec + "_excluded"] = excluded
        if prec == "fast":   # D in, distances out; an eigensolver needs at
            # least the (4/3) m^3 of a tridiagonal reduction
            m, B = ASIZE + BSIZE, dis.shape[0]
            results["css_cmds"]["bound"] = bound(
                B * (2 * m * m * 4 + 8 + 5), {"f32": B * 4 * m**3 // 3})
        del ks, kd, kv, ps, pd, pv, dis
    del plain64
    torch.cuda.empty_cache()

    # K7 part 1: the coefficient matrix of the first 16 chunks, bit-equal
    key = rng.fold_in(rng.prng_key(0), 2)
    m = ASIZE + BSIZE
    coeff = lambda: kperm.shared_coeff(key, 0, 16, m, ASIZE, BSIZE, 256, dev)  # noqa: E731
    coeff_plain = lambda: kperm.shared_coeff_plain(key, 0, 16, m, ASIZE, BSIZE, 256, dev)  # noqa: E731
    k, p = coeff(), coeff_plain()
    torch.cuda.synchronize()
    same = torch.equal(k.view(torch.int32), p.view(torch.int32))
    ms = cuda_ms(torch, coeff, 20)
    pms = cuda_ms(torch, coeff_plain, 3)
    say(f"[K7 css_mc_coeff] M [{m * m}, {16 * 256}] of chunks 0-15: bit-equal={same}; "
        f"kernel {ms:.4f} ms plain {pms:.4f} ms")
    check(same, "css_mc_coeff: M differs from _shared_coeff")
    results["css_mc_coeff"]["fast"] = (abs_err(k, p), rel_err(k, p), ms, pms)
    # M out; per column m draws (two mix32, ~12 integer operations each)
    # and m^2 rank compares
    results["css_mc_coeff"]["bound"] = bound(k.numel() * 4, {"f32": 4096 * (m * m + 12 * m)})

    # K7 part 2: the 16x worst case, every window to the 200 k cap, and the
    # 997 windows of the 10 k workload
    wpos, wam, wbm = make_chromosome(*WORST_CSS, ASIZE, BSIZE, WORST_SEED)
    wpair = SnpPair(wpos, wam, wbm)
    w_lo, w_npos, _ = windows_of(torch, wpos, WORST_CSS[1])
    s, d, v = kcss.css_phase1(wpair.to_device(dev), w_lo, w_npos, ASIZE, BSIZE, fast=True)
    dist, scores = d[v].float().contiguous(), s[v].double().cpu().numpy()
    del s, d, v
    r7 = results["css_mc_shared"]
    r7["16x"] = k7_case(torch, kperm, dist, scores, key, "16x worst case")
    r7["fast"] = r7["16x"]["fast"]
    r7["differ"] = r7["16x"]["differ"]
    r7["bound"] = r7["16x"]["bound"]
    r7["library_ms"] = r7["16x"]["library_ms"]
    d10, s10, _, _ = mc_windows(torch, WINDOW_WORKLOAD, dev)
    r7["10k"] = k7_case(torch, kperm, d10, s10, key, "10 k workload")
    del d10

    # K7's stop scan alone on the deepest range of the 16x case: the
    # windows still running there, every one entering with no hits
    k_big, nk_big, _ = max(r7["16x"]["ranges"], key=lambda r: r[1])
    nsc_final = r7["16x"]["nsc"]
    B = dist.shape[0]
    active = torch.nonzero(nsc_final > k_big * 256)[:, 0].contiguous()
    flat = dist.reshape(B, m * m)
    obs = torch.as_tensor(scores).to(dev).float()
    M = kperm.coeff_range(key, k_big, nk_big, m, ASIZE, BSIZE, 256, dev)
    words = kperm.mc_hit_words(flat, obs, active, M, k_big, nk_big, 256, MC_RUNS)
    del M
    fresh = lambda: (torch.zeros(B, dtype=torch.int32, device=dev),  # noqa: E731
                     torch.full((B,), k_big * 256, dtype=torch.int32, device=dev),
                     torch.zeros(B, dtype=torch.uint8, device=dev))
    got, want = fresh(), fresh()
    kperm.mc_scan(words, active, k_big, 256, MC_RUNS, 10, *got)
    kperm.mc_scan_plain(words, active, k_big, 256, MC_RUNS, 10, *want)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    ms = cuda_ms(torch, lambda: kperm.mc_scan(words, active, k_big, 256, MC_RUNS, 10,
                                                *fresh()), 5)
    pms = cuda_ms(torch, lambda: kperm.mc_scan_plain(words, active, k_big, 256, MC_RUNS, 10,
                                                       *fresh()), 1)
    # words read up to each window's stop, the state read and written once
    read = ((got[1][active].long() + 255) // 256 - k_big).clamp(0, nk_big)
    n_words = int(read.sum()) * (256 // 32)
    say(f"[K7 css_mc_scan] {active.numel()} windows x chunks {k_big}-{k_big + nk_big - 1} "
        f"of the 16x case: equal to the plain scan={same}, {int(got[2].sum())} stopped; "
        f"kernel {ms:.4f} ms plain {pms:.4f} ms")
    check(same, "css_mc_scan: (hits, n, done) differ from the plain scan")
    results["css_mc_scan"]["fast"] = (0.0, 0.0, ms, pms)
    results["css_mc_scan"]["bound"] = bound(
        4 * n_words + active.numel() * (8 + 2 * 9), {"f32": 4 * n_words})
    del words, dist


@contextlib.contextmanager
def timed_launches(torch, kperm, names):
    """A context in which every launch of the kernels ``names`` of
    ``kperm`` runs between two CUDA events; it yields {name: [(start,
    end), ...]} (read the times after a synchronise)."""
    spans = {n: [] for n in names}
    orig = kperm.launch

    def timed(counts, kernel, symbol, device, *args):
        if kernel not in spans:
            return orig(counts, kernel, symbol, device, *args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        orig(counts, kernel, symbol, device, *args)
        end.record()
        spans[kernel].append((start, end))

    kperm.launch = timed
    try:
        yield spans
    finally:
        kperm.launch = orig


def explain_shared_differences(torch, kperm, dist, scores, key, got, n, h, chunk) -> int:
    """Windows whose (nscores, hits) differ between K7 and the plain loop;
    each must hold a permutation, among those either consumed, whose
    float64 score lies within TIE_RTOL of the float32 observed score: a
    near tie.  Returns their count."""
    import numpy as np

    m = ASIZE + BSIZE
    bad = np.nonzero((got.nscores != n) | (got.hits != h))[0]
    for w in bad:
        nn = int(max(got.nscores[w], n[w]))
        M = kperm.shared_coeff(key, 0, -(-nn // chunk), m, ASIZE, BSIZE, chunk, dist.device)
        s64 = dist[w].reshape(-1).double() @ M.double()
        obs = float(np.float32(scores[w]))
        gap = float((s64[:nn] - obs).abs().min()) / max(abs(obs), 1.0)
        say(f"[K7] window {w}: (n, hits) kernel ({got.nscores[w]}, {got.hits[w]}) plain "
            f"({n[w]}, {h[w]}); nearest permuted score {gap:.2e} from the observed")
        check(gap <= TIE_RTOL, f"css_mc_shared: window {w} differs without a near tie ({gap})")
    return len(bad)


def k7_case(torch, kperm, dist, scores, key, label) -> dict:
    """K7 on a workload's windows (dist [B, m, m] float32 on the card) to
    the MC_RUNS cap at chunk 256: one call's host wall against the plain
    chunk loop's, each differing window shown to be a near tie; then one
    call of the range loop with the css_mc_shared and css_mc_scan launches
    between CUDA events, its ranges and the permutations it computed
    against those consumed; the bound and the torch.matmul yardstick."""
    import numpy as np

    m = ASIZE + BSIZE
    B = dist.shape[0]
    kern = lambda: kperm.significance(dist, scores, ASIZE, BSIZE, 10, MC_RUNS, key)  # noqa: E731
    plain = lambda: kperm.mc_significance(dist, scores, key, ASIZE, BSIZE, 256, MC_RUNS, 10)  # noqa: E731
    kern()                                   # warm-up
    got, ms = host_ms(torch, kern)
    (pv, n, h), pms = host_ms(torch, plain)
    nd = explain_shared_differences(torch, kperm, dist, scores, key, got, n, h, 256)
    check(nd <= MC_DIFFER_SHARE * B, f"css_mc_shared {label}: {nd} windows differ")
    perms = int(n.sum())

    flat = dist.reshape(B, m * m)
    obs = torch.as_tensor(scores).to(dist.device).float()
    ranges = []
    names = ("css_mc_coeff", "css_mc_shared", "css_mc_scan")
    with timed_launches(torch, kperm, names) as spans:
        (nsc, hits), ms_loop = host_ms(torch, lambda: kperm.mc_shared(
            flat, obs, key, ASIZE, BSIZE, 256, MC_RUNS, 10, ranges=ranges))
    kms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    check(np.array_equal(nsc.cpu().numpy(), got.nscores), f"K7 {label}: rerun differs")
    computed = sum(a * (min(MC_RUNS, (k + nk) * 256) - k * 256) for k, nk, a in ranges)
    # a multiply-add per D entry and permutation consumed; D and the
    # deepest range's M in, 3 values per window out
    ncols = -(-int(n.max()) // 256) * 256
    bnd = bound(B * (m * m * 4 + 4 + 12) + m * m * ncols * 4, {"f32": 2 * m * m * perms})
    # the library yardstick: the product alone, torch.matmul(D, M) over
    # the columns the deepest window consumed (float32, TF32 off)
    M = kperm.shared_coeff(key, 0, ncols // 256, m, ASIZE, BSIZE, 256, dist.device)
    lib = cuda_ms(torch, lambda: flat @ M, 2)
    del M
    say(f"[K7 css_mc_shared {label}] {B} windows, {perms} permutations consumed, "
        f"{int((n == MC_RUNS).sum())} to the {MC_RUNS} cap: {nd} windows differ (allowed "
        f"{int(MC_DIFFER_SHARE * B)}: float32 near ties); kernel {ms:.1f} ms plain {pms:.1f} "
        f"ms (host wall, one call each; {perms / ms * 1e3:,.0f} vs {perms / pms * 1e3:,.0f} "
        f"perms/s); launches alone (CUDA events): css_mc_shared {kms['css_mc_shared']:.2f} "
        f"ms, css_mc_scan {kms['css_mc_scan']:.3f} ms, css_mc_coeff "
        f"{kms['css_mc_coeff']:.3f} ms in a {ms_loop:.1f} ms call; {len(ranges)} ranges "
        f"(first chunk, chunks, windows) {ranges}; {computed} permutations computed for "
        f"{perms} consumed ({computed / max(perms, 1):.4f}x); bound {bnd[0]:.2f} ms "
        f"({bnd[1]}); yardstick torch.matmul [{B}, {m * m}] @ [{m * m}, {ncols}] {lib:.2f} ms")
    return {
        "fast": (float(np.abs(got.pvals - pv).max()) if B else 0.0, float(nd), ms, pms),
        "differ": nd, "bound": bnd, "library_ms": lib, "ranges": ranges, "nsc": nsc,
        "kernel_ms": kms["css_mc_shared"], "scan_ms": kms["css_mc_scan"],
        "coeff_ms": kms["css_mc_coeff"], "perms_computed": computed,
        "perms_consumed": perms,
    }


def phase_css_cli(torch, dev, tmp: Path, files) -> None:
    """Phase 6: run-css through the CLI (default fast) on phase 3's pair."""
    import numpy as np

    from divergence_tpu_torch.io import read_score_track
    from divergence_tpu_torch.tools import cli

    a_path, b_path, sizes = files
    out, summary = tmp / "css_fast.track", tmp / "css_fast.json"
    t0 = time.perf_counter()
    cli.main([
        "run-css", "--pop-a", str(a_path), "--pop-b", str(b_path),
        "--out", str(out), "--chrom-sizes", str(sizes), "--summary", str(summary),
        "--device", str(dev),
    ])
    wall = time.perf_counter() - t0
    seqids, starts, sc, pv = read_score_track(out)
    counters = json.loads(summary.read_text())
    timings, counters = counters["timings_s"], counters["counters"]
    nslots = CLI_REGION // 500
    say(f"[css cli fast] {len(starts)} scored windows of {nslots} slots, "
        f"{int(np.isnan(sc).sum())} NaN scores, p in [{pv.min():.3g}, {pv.max():.3g}], "
        f"{counters['mc_permutations']} MC permutations; wall {wall:.2f} s "
        f"(GTrack parse included; engine {timings.get('chrI', 0.0):.3f} s)")
    check(len(starts) == counters["windows_scored"] > 0, "css cli: rows != scored windows")
    check(bool(((starts // 500) < nslots).all()) and len(set(starts.tolist())) == len(starts),
          "css cli: rows outside the slots")
    check(not np.isnan(sc).any() and not np.isnan(pv).any(), "css cli: NaN in the track")
    check(bool(((pv > 0) & (pv <= 1)).all()), "css cli: p outside (0, 1]")


def warm_runs(run, reps: int = 3):
    """A warm-up call of ``run(summary)``, then ``reps`` timed calls, each
    with a fresh RunSummary: (the last output, its summary, host walls s)."""
    from divergence_tpu_torch.utils.summary import RunSummary

    run(RunSummary())
    walls = []
    for _ in range(reps):
        summary = RunSummary()
        t0 = time.perf_counter()
        out = run(summary)
        walls.append(time.perf_counter() - t0)
    return out, summary, walls


def profile_css(torch, run, label) -> None:
    """One profiled call of ``run()`` (a run_css): wall, device time and
    busy share, and K7's device time (css_mc_coeff, css_mc_shared_tile,
    css_mc_scan) and share of the wall."""
    wall, dev_ms, rows = device_profile(torch, run)
    check(dev_ms > 0, f"run_css {label}: the profiler saw no device time")
    k7 = {k: sum(ms for ms, name in rows if k in name)
          for k in ("css_mc_coeff", "css_mc_shared_tile", "css_mc_scan")}
    say(f"[css profile] run_css {label}: wall {wall:.1f} ms, device {dev_ms:.1f} ms "
        f"({100 * dev_ms / wall:.1f} % busy); K7 {sum(k7.values()):.2f} ms "
        f"({100 * sum(k7.values()) / wall:.1f} % of the wall: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in k7.items()) + "); most device time: "
        + "; ".join(f"{name[:50]} {ms:.2f} ms" for ms, name in rows[:4]))


def phase_css_library(torch, dev, card) -> None:
    """Phase 7: run_css on the bench's three CSS workloads and the 500 k
    CLI panel (warm walls, one profiled call each); run_css_multi on the
    card against run_css on the CPU."""
    import numpy as np

    from divergence_tpu_torch.config import CssConfig
    from divergence_tpu_torch.engine import SnpPair, run_css, run_css_multi
    from divergence_tpu_torch.tools.synth import make_chromosome, make_panel

    pos, am, bm = make_panel(CLI_SNPS, CLI_REGION, ASIZE, BSIZE, seed=5)
    panel = SnpPair(pos, am, bm)
    profile_css(torch, lambda: run_css(panel, CLI_REGION, CssConfig(precision="fast"),
                                       device=dev), f"{CLI_SNPS} SNP panel fast")
    del panel
    for npos_, region, seed, precs in CSS_WORKLOADS:
        pos, am, bm = make_chromosome(npos_, region, ASIZE, BSIZE, seed)
        pair = SnpPair(pos, am, bm)
        for prec in precs:
            cfg = CssConfig(precision=prec)
            (scores, pvals), summary, walls = warm_runs(
                lambda sm: run_css(pair, region, cfg, device=dev, summary=sm))
            c = summary.counters
            check(scores.shape == (region // 500,) and pvals.shape == scores.shape,
                  f"run_css {npos_} {prec}: shape")
            check(not np.isnan(scores).any() and not np.isnan(pvals).any(),
                  f"run_css {npos_} {prec}: NaN")
            scored = scores != 0
            check(c["windows_scored"] == int(scored.sum()) > 0, f"run_css {npos_}: scored")
            check(bool(((pvals[scored] > 0) & (pvals[scored] <= 1)).all()), "run_css p range")
            best, med = min(walls), float(np.median(walls))
            t = summary.timings_s
            say(f"[css library {prec}] run_css {npos_} SNPs / {region} bp seed {seed}: "
                f"{c['windows_scored']} windows scored, {c['mc_permutations']} MC "
                f"permutations; warm wall min {best:.4f} s median {med:.4f} s; "
                f"{c['windows_scored'] / best:,.0f} windows/s, "
                f"{c['mc_permutations'] / best:,.0f} perms/s (stages: dispatch "
                f"{t.get('css_dispatch', 0):.4f} s, phase-1 sync "
                f"{t.get('css_phase1_sync', 0):.4f} s, MC {t.get('css_mc', 0):.4f} s) "
                f"on {card}")
            if prec == precs[0]:
                profile_css(torch, lambda: run_css(pair, region, cfg, device=dev),
                            f"{npos_} SNPs {prec}")

    pairs = {}
    for i, seqid in enumerate(("chrII", "chrIII", "chrIV")):
        pos, am, bm = make_panel(20_000, 1_000_000, ASIZE, BSIZE, seed=20 + i)
        pairs[seqid] = (SnpPair(pos, am, bm), 1_000_000)
    for prec in ("fast", "exact"):
        cfg = CssConfig(precision=prec, seed=3, mc_runs=20_000)
        gpu = run_css_multi(pairs, cfg, device=dev)
        n_scored = n_pdiff = 0
        worst = 0.0
        for seqid, (p, regend) in pairs.items():
            cpu = run_css(p, regend, cfg, device="cpu", seqid=seqid)
            g, c = gpu[seqid], cpu
            check(np.array_equal(g[0] != 0, c[0] != 0), f"{seqid} {prec}: scored windows differ")
            ok = c[0] != 0
            n_scored += int(ok.sum())
            n_pdiff += int((g[1] != c[1]).sum())
            if prec == "exact":
                err = np.abs(g[0] - c[0]) / np.maximum(np.abs(c[0]), 1.0)
                worst = max(worst, float(err.max()))
            else:
                check(np.allclose(g[0], c[0], rtol=FAST_RTOL, atol=FAST_ATOL),
                      f"{seqid} fast scores")
                worst = max(worst, float(np.max(np.abs(g[0] - c[0]))))
        say(f"[css library {prec}] run_css_multi on the card vs run_css on the CPU "
            f"(3 x 20000 SNPs, {n_scored} windows): scores max_err={worst:.3e}, "
            f"p differs on {n_pdiff} windows (float32 near ties)")
        if prec == "exact":
            check(worst <= 1e-9 or n_scored == 0, f"run_css_multi exact: {worst}")
        check(n_pdiff <= 0.01 * max(n_scored, 1), f"run_css_multi {prec}: {n_pdiff} p differ")


def event_ms(torch, fn):
    """(fn(), device ms of that one call), by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def smacof_check(torch, kcss, dis, npos, asize, bsize, mds, key, slots, prec, label):
    """css_smacof against css_smacof_plain on the card at one precision.
    Returns ((max_abs_err, max_rel_err, kernel ms, plain ms), windows whose
    chosen restart or transform count differ, Guttman transforms of the
    chosen restarts summed over the windows)."""
    dt = torch.float32 if prec == "fast" else torch.float64
    d = dis.to(dt).contiguous()
    kern = lambda: kcss.css_smacof(d, npos, asize, bsize, mds, key, slots)  # noqa: E731
    ks, kd, kv, kr, kn = kern()
    (ps, pd, pv, pr, pn), pms = event_ms(
        torch, lambda: kcss.css_smacof_plain(d, npos, asize, bsize, mds, key, slots)
    )
    torch.cuda.synchronize()
    check(torch.equal(kv, pv), f"{label} {prec}: valid flags differ")
    check(torch.equal(ks.isnan(), ps.isnan()), f"{label} {prec}: NaN patterns differ")
    B = d.shape[0]
    sel = pv & ~ps.isnan()
    agree = ((kr == pr) & (kn == pn))[sel]
    got, want = ks.double()[sel], ps.double()[sel]
    rel = (got - want).abs() / want.abs().clamp(min=1.0)
    differ = int((~agree).sum())
    if prec == "exact":
        err = float(rel[agree].max()) if bool(agree.any()) else 0.0
        tol_txt = (f"max_rel_err={err:.3e} on the {int(agree.sum())} windows whose restart "
                   f"and transform count agree (tol {TOL_CSS:g}), {differ} differ "
                   f"(allowed {int(SMACOF_DIFFER_SHARE * B)})")
        check(err <= TOL_CSS, f"{label} {prec}: {err} > {TOL_CSS}")
        check(differ <= SMACOF_DIFFER_SHARE * B, f"{label} {prec}: {differ} windows differ")
    else:
        top, q90 = SMACOF_FAST_BAND[mds]
        err = float(rel.max()) if rel.numel() else 0.0
        q = float(torch.quantile(rel, 0.9)) if rel.numel() else 0.0
        tol_txt = (f"max_rel_err={err:.3e} (band {top:g}), 90th percentile {q:.3e} "
                   f"(band {q90:g}); {differ} windows stop differently")
        check(err <= top and q <= q90, f"{label} {prec}: {err}, q90 {q} beyond the band")
    ms = cuda_ms(torch, kern, 2)
    steps = kn[kv].double()
    say(f"[K6 {label} {prec}] B={B} windows, {int(kv.sum())} valid, "
        f"{int(ks.isnan().sum())} NaN in both, mean {float(steps.mean()):.1f} / max "
        f"{int(kn.max())} Guttman transforms on the chosen restart: {tol_txt}; "
        f"kernel {ms:.3f} ms plain {pms:.3f} ms")
    return (abs_err(got, want), err, ms, pms), differ, int(kn.sum())


def phase_smacof_kernels(torch, pair, plan_ids, dev, results) -> None:
    """Phase 8: K6 against its plain torch version on the card; drosophila
    shapes through K5, K6 and K7 at m = 2; K6 alone on the bench windows."""
    import numpy as np

    from divergence_tpu_torch import rng
    from divergence_tpu_torch.engine import SnpPair
    from divergence_tpu_torch.kernels import css as kcss
    from divergence_tpu_torch.kernels import perm as kperm
    from divergence_tpu_torch.tools.synth import make_chromosome, make_freq_chromosome

    key = rng.fold_in(rng.prng_key(0), rng.chrom_hash("_"))   # run_css's default
    npos_, region, seed, _ = SMACOF_WORKLOAD
    pos, am, bm = make_chromosome(npos_, region, ASIZE, BSIZE, seed)
    lo, npos, slot = windows_of(torch, pos, region)
    dis = kcss.dissimilarity_plain(SnpPair(pos, am, bm).to_device(dev), lo, npos)
    npos_d, slot_d = npos.to(dev), slot.to(dev)
    r = results["css_smacof"]
    for mds in (1, 2):
        for prec in ("fast", "exact"):
            out, differ, steps = smacof_check(
                torch, kcss, dis, npos_d, ASIZE, BSIZE, mds, key, slot_d, prec,
                f"css_smacof mds={mds} {npos_} SNPs")
            tag = prec if mds == 1 else f"mds2_{prec}"
            r[tag] = out
            r.setdefault("differ", {})[f"mds{mds}_{prec}"] = differ
            if tag == "fast":   # D in, distances out; a transform is at
                # least 3 m^2 flops and 2 m^2 square roots and divisions,
                # counted on the chosen restarts only
                m = ASIZE + BSIZE
                r["bound"] = bound(dis.shape[0] * (2 * m * m * 4 + 9),
                                   {"f32": 5 * m * m * steps})
    del dis
    torch.cuda.empty_cache()

    # drosophila: K5, K7 and K6 at m = 2 on a frequency chromosome
    fpos, fa, fb = make_freq_chromosome(DROS_SNPS, DROS_REGION, DROS_SEED)
    f_lo, f_npos, f_slot = windows_of(torch, fpos, DROS_REGION)
    fvals = SnpPair(fpos, fa, fb).to_device(dev, compact=False)
    fdis = kcss.dissimilarity_freq_windows(fvals[:, 0], fvals[:, 1], f_lo, f_npos)
    f_npos_d, f_slot_d = f_npos.to(dev), f_slot.to(dev)
    mc_key = rng.fold_in(rng.prng_key(0), 2)
    for prec in ("fast", "exact"):
        dt = torch.float32 if prec == "fast" else torch.float64
        d = fdis.to(dt)
        ks, kd, kv = kcss.css_cmds(d, f_npos_d, 1, 1)
        ps, pd, pv = kcss.css_cmds_plain(d, f_npos_d, 1, 1)
        torch.cuda.synchronize()
        check(torch.equal(kv, pv), f"drosophila css_cmds {prec}: valid flags differ")
        check(not bool(ks.isnan().any() or ps.isnan().any()),
              f"drosophila css_cmds {prec}: NaN (the m = 2 dust clamp)")
        got, want = ks.double()[pv], ps.double()[pv]
        err = rel_err(got, want)
        if prec == "exact":
            bad = int((((got - want).abs() / want.abs().clamp(min=1.0)) > TOL_CSS).sum())
        else:
            bad = int(((got - want).abs() > FAST_ATOL + FAST_RTOL * want.abs()).sum())
        ms = cuda_ms(torch, lambda: kcss.css_cmds(d, f_npos_d, 1, 1), 3)
        pms = cuda_ms(torch, lambda: kcss.css_cmds_plain(d, f_npos_d, 1, 1), 1)
        sc = ks[kv].double().cpu().numpy()
        mc = kperm.significance(kd[kv], sc, 1, 1, 10, 200_000, mc_key)
        pv_, n_, h_ = kperm.mc_significance(kd[kv], sc, mc_key, 1, 1, 256, 200_000, 10)
        same = (np.array_equal(mc.pvals, pv_) and np.array_equal(mc.nscores, n_)
                and np.array_equal(mc.hits, h_))
        say(f"[K5+K7 drosophila {prec}] B={d.shape[0]} windows (m = 2), {int(kv.sum())} "
            f"valid, 0 NaN: css_cmds max_rel_err={err:.3e}, {bad} beyond tolerance, "
            f"kernel {ms:.4f} ms plain {pms:.4f} ms; MC p == 1 on "
            f"{int((mc.pvals == 1.0).sum())} of {len(sc)}, identical to the plain loop: {same}")
        check(bad == 0, f"drosophila css_cmds {prec}: {bad} windows beyond tolerance")
        check(bool((mc.pvals == 1.0).all()) and same, f"drosophila MC {prec}")
        r[f"drosophila_cmds_{prec}"] = (abs_err(got, want), err, ms, pms)
        out, differ, _ = smacof_check(torch, kcss, fdis, f_npos_d, 1, 1, 1, key, f_slot_d,
                                      prec, f"css_smacof mds=1 drosophila {DROS_SNPS} SNPs")
        r[f"drosophila_{prec}"] = out
        r["differ"][f"drosophila_{prec}"] = differ
    del fdis, fvals

    # the kernel alone, mode 1 fast, on the ~800 k bench windows
    lo8, npos8, slot8 = plan_ids
    d8 = kcss.css_dissim(pair.to_device(dev), lo8, npos8, torch.float32)
    npos8_d, slot8_d = npos8.to(dev), slot8.to(dev)
    (s8, _, v8, _, n8), ms = event_ms(
        torch, lambda: kcss.css_smacof(d8, npos8_d, ASIZE, BSIZE, 1, key, slot8_d)
    )
    check(bool(torch.isfinite(s8[v8]).all()) and int(v8.sum()) > 0, "css_smacof bench: non-finite")
    say(f"[K6 css_smacof mds=1 fast bench] B={d8.shape[0]} windows, {int(v8.sum())} valid, "
        f"mean {float(n8[v8].double().mean()):.1f} transforms: kernel {ms:.1f} ms "
        f"({d8.shape[0] / ms * 1e3:,.0f} windows/s, one call); plain version not run "
        "at this size")
    r["bench_fast_ms"] = ms
    del d8, s8, v8, n8
    torch.cuda.empty_cache()


def phase_smacof_library(torch, dev, card, tmp: Path) -> None:
    """Phase 9: run_css with the SMACOF modes and drosophila mode; the card
    against the CPU; the CLI with --mds smacof and --drosophila."""
    import numpy as np

    from divergence_tpu_torch.config import CssConfig, MdsAlgorithm
    from divergence_tpu_torch.engine import SnpPair, run_css, run_css_multi
    from divergence_tpu_torch.io import read_score_track
    from divergence_tpu_torch.tools import cli, synth

    npos_, region, seed, _ = SMACOF_WORKLOAD
    pos, am, bm = synth.make_chromosome(npos_, region, ASIZE, BSIZE, seed)
    fpos, fa, fb = synth.make_freq_chromosome(DROS_SNPS, DROS_REGION, DROS_SEED)
    runs = [(SnpPair(pos, am, bm), region, f"{npos_} SNPs / {region} bp", {"mds": m})
            for m in (MdsAlgorithm.SMACOF, MdsAlgorithm.CMDS_SMACOF)]
    runs.append((SnpPair(fpos, fa, fb), DROS_REGION,
                 f"drosophila {DROS_SNPS} SNPs / {DROS_REGION} bp", {"drosophila": True}))
    for pair, reg, what, kw in runs:
        for prec in ("fast", "exact"):
            cfg = CssConfig(precision=prec, **kw)
            (scores, pvals), summary, walls = warm_runs(
                lambda sm: run_css(pair, reg, cfg, device=dev, summary=sm))
            c, t = summary.counters, summary.timings_s
            scored = scores != 0
            check(scores.shape == (reg // 500,) and not np.isnan(scores).any()
                  and not np.isnan(pvals).any(), f"run_css {what} {prec}: shape or NaN")
            check(c["windows_scored"] == int(scored.sum()) > 0, f"run_css {what}: scored")
            check(bool(((pvals[scored] > 0) & (pvals[scored] <= 1)).all()), "run_css p range")
            if kw.get("drosophila"):
                check(bool((pvals[scored] == 1.0).all()), f"drosophila {prec}: p != 1")
            best, med = min(walls), float(np.median(walls))
            say(f"[smacof library {prec}] run_css {what} {kw}: {c['windows_scored']} windows "
                f"scored, {c['mc_permutations']} MC permutations; warm wall min {best:.4f} s "
                f"median {med:.4f} s; {c['windows_scored'] / best:,.0f} windows/s, "
                f"{c['mc_permutations'] / best:,.0f} perms/s (stages: dispatch "
                f"{t.get('css_dispatch', 0):.4f} s, phase-1 sync "
                f"{t.get('css_phase1_sync', 0):.4f} s, MC {t.get('css_mc', 0):.4f} s) on {card}")

    # the card against the CPU, exact
    for kw in ({"mds": MdsAlgorithm.SMACOF}, {"drosophila": True}):
        pairs = {}
        for i, seqid in enumerate(("chrII", "chrIII", "chrIV")):
            if kw.get("drosophila"):
                p, a, b = synth.make_freq_chromosome(MULTI_SNPS, MULTI_REGION, 30 + i)
            else:
                p, a, b = synth.make_panel(MULTI_SNPS, MULTI_REGION, ASIZE, BSIZE, seed=30 + i)
            pairs[seqid] = (SnpPair(p, a, b), MULTI_REGION)
        cfg = CssConfig(precision="exact", seed=3, mc_runs=20_000, **kw)
        t0 = time.perf_counter()
        gpu = run_css_multi(pairs, cfg, device=dev)
        t_gpu = time.perf_counter() - t0
        n_scored = n_beyond = n_pdiff = 0
        worst = 0.0
        t0 = time.perf_counter()
        for seqid, (p, regend) in pairs.items():
            g, c = gpu[seqid], run_css(p, regend, cfg, device="cpu", seqid=seqid)
            check(np.array_equal(g[0] != 0, c[0] != 0), f"{seqid} {kw}: scored windows differ")
            err = np.abs(g[0] - c[0]) / np.maximum(np.abs(c[0]), 1.0)
            n_scored += int((c[0] != 0).sum())
            n_beyond += int((err > TOL_CSS).sum())
            n_pdiff += int((g[1] != c[1]).sum())
            worst = max(worst, float(err.max()))
        t_cpu = time.perf_counter() - t0
        say(f"[smacof library exact] run_css_multi {kw} on the card vs run_css on the CPU "
            f"(3 x {MULTI_SNPS} SNPs, {n_scored} windows): {n_beyond} windows beyond "
            f"{TOL_CSS:g} (allowed {int(SMACOF_DIFFER_SHARE * n_scored)}: a flipped stop "
            f"or restart), max_rel_err {worst:.3e}; p differs on {n_pdiff} "
            f"windows; card {t_gpu:.2f} s, CPU {t_cpu:.2f} s")
        check(n_scored > 0 and n_beyond <= SMACOF_DIFFER_SHARE * n_scored,
              f"run_css_multi {kw}: {n_beyond} windows beyond {TOL_CSS}")
        check(n_pdiff <= 0.01 * n_scored, f"run_css_multi {kw}: {n_pdiff} p differ")

    # the CLI on small files
    spos, sam, sbm = synth.make_panel(SMALL_SNPS, SMALL_REGION, ASIZE, BSIZE, seed=40)
    fpos, fa, fb = synth.make_freq_chromosome(SMALL_SNPS, SMALL_REGION, 41)
    files = {}
    for name, p, mat in (("popA", spos, sam), ("popB", spos, sbm), ("freqA", fpos, fa),
                         ("freqB", fpos, fb)):
        files[name] = tmp / f"small_{name}.gtrack"
        synth.write_gtrack(files[name], "chrS", p, mat)
    for flags, a, b in ((["--mds", "smacof"], "popA", "popB"),
                        (["--drosophila"], "freqA", "freqB")):
        out, summary = tmp / "small_css.track", tmp / "small_css.json"
        t0 = time.perf_counter()
        cli.main(["run-css", "--pop-a", str(files[a]), "--pop-b", str(files[b]),
                  "--out", str(out), "--summary", str(summary), "--device", str(dev), *flags])
        wall = time.perf_counter() - t0
        _, starts, sc, pv = read_score_track(out)
        counters = json.loads(summary.read_text())["counters"]
        say(f"[smacof cli] run-css {' '.join(flags)}: {len(starts)} rows, p in "
            f"[{pv.min():.3g}, {pv.max():.3g}], wall {wall:.2f} s")
        check(len(starts) == counters["windows_scored"] > 0, f"cli {flags}: rows")
        check(not np.isnan(sc).any() and bool(((pv > 0) & (pv <= 1)).all()), f"cli {flags}")
        if "--drosophila" in flags:
            check(bool((pv == 1.0).all()), "cli --drosophila: p != 1")


def host_ms(torch, fn):
    """(fn(), host wall ms of that one call, synchronised on both ends)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def device_profile(torch, fn) -> tuple[float, float, list]:
    """(wall ms, device ms, [(device ms, name)] of every device event, most
    first) of one call under torch.profiler: the device's busy time is the
    sum of the device events' self time (kernels and copies; overlap is not
    removed)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    return wall, sum(ms for ms, _ in rows), rows


def mc_windows(torch, workload, dev):
    """(dist [B, m, m] float32 on the card, float64 observed scores,
    chromosome hashes, slots) of a CSS workload's valid windows: phase 1
    in fast mode, as the engine gives them to phase 2."""
    import numpy as np

    from divergence_tpu_torch import rng
    from divergence_tpu_torch.engine import SnpPair
    from divergence_tpu_torch.kernels import css as kcss
    from divergence_tpu_torch.tools.synth import make_chromosome

    npos_, region, seed = workload[:3]
    pos, am, bm = make_chromosome(npos_, region, ASIZE, BSIZE, seed)
    lo, npos, slot = windows_of(torch, pos, region)
    s, d, v = kcss.css_phase1(SnpPair(pos, am, bm).to_device(dev), lo, npos, ASIZE, BSIZE,
                              fast=True)
    keep = v.cpu().numpy()
    slots = slot.numpy()[keep]
    chroms = np.full(len(slots), rng.chrom_hash("_"), dtype=np.int64)
    return d[v].float().contiguous(), s[v].double().cpu().numpy(), chroms, slots


def window_ops(form: str, m: int, asize: int) -> dict:
    """Operations of one window-stream permutation, by type: m draws (two
    mix32, ~12 integer operations, or a threefry-2x32, ~70), m^2 rank
    compares, and the score: a*b + m - 2 float32 products and sums, or in
    the float64 form about C(g, 2) + g + m float64 sums over the rank order
    (g the smaller group)."""
    bsize = m - asize
    draws = 70 * m if form == "threefry" else 12 * m
    if form == "native":
        g = min(asize, bsize)
        return {"f32": draws + m * m, "f64": g * (g - 1) // 2 + g + m + 6}
    return {"f32": draws + m * m + 2 * (asize * bsize + m - 2)}


def explain_differences(torch, kperm, rng, dist, scores, wkeys, got, n, h, chunk,
                        bitgen, native) -> int:
    """Windows whose (nscores, hits) differ between a kernel and its plain
    version; each must hold a permutation, among those either consumed,
    whose score lies within TIE_RTOL (float32 forms, rescored in float64)
    or TIE_RTOL_F64 (the float64 form, rescored in its own order) of the
    observed score: a near tie.  Returns their count."""
    import numpy as np

    m = ASIZE + BSIZE
    bad = np.nonzero((got.nscores != n) | (got.hits != h))[0]
    for w in bad:
        nn = int(max(got.nscores[w], n[w]))
        r = torch.cat([kperm._ranks(rng.fold_in(wkeys[w:w + 1], k), chunk, m, bitgen)
                       for k in range(-(-nn // chunk))], dim=-1)
        D = dist[w:w + 1].double()
        obs = float(np.float32(scores[w]))
        if native:
            s64 = kperm._native_scores(D, kperm._row_totals(D), r, ASIZE, BSIZE)[0]
        else:
            s64 = (D[..., None] * kperm._rank_coeff(r, ASIZE, BSIZE).double()).sum(dim=(1, 2))[0]
        gap = float((s64[:nn] - obs).abs().min()) / max(abs(obs), 1.0)
        say(f"[K8] window {w}: (n, hits) kernel ({got.nscores[w]}, {got.hits[w]}) plain "
            f"({n[w]}, {h[w]}); nearest permuted score {gap:.2e} from the observed")
        check(gap <= (TIE_RTOL_F64 if native else TIE_RTOL),
              f"css_mc_window: window {w} differs without a near tie ({gap})")
    return len(bad)


def phase_window_kernels(torch, pair, plan_ids, dev, results) -> None:
    """Phase 10: K7 under threefry draws, K8 in its three forms and K9 in
    both streams against their plain versions on the card; K8 alone on the
    16x worst case and K9 alone on the ~800 k bench windows."""
    import numpy as np

    from divergence_tpu_torch import rng
    from divergence_tpu_torch.kernels import css as kcss
    from divergence_tpu_torch.kernels import perm as kperm

    m = ASIZE + BSIZE
    key = rng.fold_in(rng.prng_key(0), 2).to(dev)

    # K7 under threefry: M of the first 16 chunks, bit-equal
    coeff = lambda: kperm.shared_coeff(key, 0, 16, m, ASIZE, BSIZE, 256, dev, "threefry")  # noqa: E731
    coeff_plain = lambda: kperm.shared_coeff_plain(  # noqa: E731
        key, 0, 16, m, ASIZE, BSIZE, 256, dev, "threefry")
    k, p = coeff(), coeff_plain()
    torch.cuda.synchronize()
    same = torch.equal(k.view(torch.int32), p.view(torch.int32))
    u = kperm._draws(torch.stack([rng.fold_in(key, c) for c in range(16)]), 256, m,
                     "threefry").sort(dim=-1).values
    ties = int((u.diff(dim=-1) == 0).any(dim=-1).sum())
    ms = cuda_ms(torch, coeff, 20)
    pms = cuda_ms(torch, coeff_plain, 3)
    say(f"[K7 css_mc_coeff threefry] M [{m * m}, {16 * 256}] of chunks 0-15: bit-equal="
        f"{same}; {ties} of 4096 permutations hold tied float32 draws; kernel {ms:.4f} ms "
        f"plain {pms:.4f} ms")
    check(same, "css_mc_coeff threefry: M differs from _shared_coeff")
    results["css_mc_coeff"]["threefry"] = (abs_err(k, p), rel_err(k, p), ms, pms)
    del k, p, u

    # K8 on the 997 windows of the 10 k workload to the MC_RUNS cap
    dist, scores, chroms, slots = mc_windows(torch, WINDOW_WORKLOAD, dev)
    B = dist.shape[0]
    wkeys = rng.window_keys(key, chroms, slots)
    r = results["css_mc_window"]
    r["differ"] = {}
    for form, bitgen, backend in (("mix", "mix", "xla"), ("threefry", "threefry", "xla"),
                                  ("native", "mix", "native")):
        kern = lambda: kperm.significance(  # noqa: E731
            dist, scores, ASIZE, BSIZE, 10, MC_RUNS, key, chroms=chroms, slots=slots,
            backend=backend, bitgen=bitgen, stream="window")
        if backend == "native":
            plain = lambda: kperm.mc_native_plain(  # noqa: E731
                dist, scores, wkeys, ASIZE, BSIZE, 256, MC_RUNS, 10)
        else:
            plain = lambda: kperm.mc_significance(  # noqa: E731
                dist, scores, wkeys, ASIZE, BSIZE, 256, MC_RUNS, 10, stream="window",
                bitgen=bitgen)
        kern()                                   # warm-up
        got, ms = host_ms(torch, kern)
        (pv, n, h), pms = host_ms(torch, plain)
        nd = explain_differences(torch, kperm, rng, dist, scores, wkeys, got, n, h, 256,
                                 bitgen, backend == "native")
        perms = int(n.sum())
        say(f"[K8 css_mc_window {form}] {B} windows, {perms} permutations, "
            f"{int((n == MC_RUNS).sum())} to the {MC_RUNS} cap: {nd} windows differ (allowed "
            f"{int(MC_DIFFER_SHARE * B)}: near ties); kernel {ms:.1f} ms plain {pms:.1f} ms "
            f"(host wall, one call each; {perms / ms * 1e3:,.0f} vs "
            f"{perms / pms * 1e3:,.0f} perms/s)")
        check(nd <= MC_DIFFER_SHARE * B, f"css_mc_window {form}: {nd} windows differ")
        check(bool(((got.hits == 10) | (got.nscores == MC_RUNS)).all()),
              f"css_mc_window {form}: a window stopped outside the rule")
        ops = {t: v * perms for t, v in window_ops(form, m, ASIZE).items()}
        r[form] = (float(np.abs(got.pvals - pv).max()), float(nd), ms, pms)
        r[f"bound_{form}"] = bound(B * (m * m * 4 + 4 + 16 + 8), ops)
        r["differ"][form] = nd
    r["fast"], r["bound"] = r["mix"], r["bound_mix"]
    del dist, wkeys

    # K8 alone (mix) on the 16x worst case, K7 beside it on the same windows
    wdist, wscores, wchroms, wslots = mc_windows(torch, (*WORST_CSS, WORST_SEED), dev)
    kern = lambda: kperm.significance(  # noqa: E731
        wdist, wscores, ASIZE, BSIZE, 10, MC_RUNS, key, chroms=wchroms, slots=wslots,
        stream="window")
    k7 = lambda: kperm.significance(wdist, wscores, ASIZE, BSIZE, 10, MC_RUNS, key)  # noqa: E731
    got, ms = host_ms(torch, kern)
    k7()
    got7, ms7 = host_ms(torch, k7)
    perms, perms7 = int(got.nscores.sum()), int(got7.nscores.sum())
    say(f"[K8 css_mc_window mix, 16x worst case] {wdist.shape[0]} windows, {perms} "
        f"permutations: kernel {ms:.1f} ms ({perms / ms * 1e3:,.0f} perms/s; host wall, "
        f"one call); K7 css_mc_shared on the same windows {ms7:.1f} ms for {perms7} "
        f"permutations ({perms7 / ms7 * 1e3:,.0f} perms/s); plain version not run at this "
        "size")
    check(bool(((got.hits == 10) | (got.nscores == MC_RUNS)).all()), "css_mc_window 16x")
    r["worst_ms"], r["worst_k7_ms"] = ms, ms7
    del wdist
    torch.cuda.empty_cache()

    # K9 on the 19,997 windows of the 200 k workload, both streams
    pdist, pscores, pchroms, pslots = mc_windows(torch, POWER_WORKLOAD, dev)
    PB = pdist.shape[0]
    pwkeys = rng.window_keys(key, pchroms, pslots)
    nperm = PB * APPROX_CHUNK * APPROX_CHUNKS
    r9 = results["css_mc_power"]
    r9["differ"] = {}
    for stream in ("shared", "window"):
        keys = key if stream == "shared" else pwkeys
        args = (pdist, keys, ASIZE, BSIZE, APPROX_CHUNK, 0, APPROX_CHUNKS, stream)
        kern = lambda: kperm.null_power_sums(*args)  # noqa: E731
        plain = lambda: kperm.null_power_sums_plain(*args)  # noqa: E731
        kp, pp = kern(), plain()
        torch.cuda.synchronize()
        prel = float(((kp - pp).abs() / pp.abs().clamp(min=1e-300)).max())
        repeat = torch.equal(kp.view(torch.int64), kern().view(torch.int64))
        check(repeat, f"css_mc_power {stream}: two calls differ")
        ms = cuda_ms(torch, kern, 3)
        pms = cuda_ms(torch, plain, 1)
        akw = dict(chunk=APPROX_CHUNK, chroms=pchroms, slots=pslots, stream=stream)
        ap = kperm.approx_significance(pdist, pscores, ASIZE, BSIZE, key, **akw)
        aq = kperm.approx_significance_plain(pdist, pscores, ASIZE, BSIZE, key, **akw)
        same = ap.nscores == aq.nscores
        dl = np.abs(np.log10(ap.pvals[same]) - np.log10(aq.pvals[same]))
        nd = int((~same).sum())
        say(f"[K9 css_mc_power {stream}] {PB} windows x {APPROX_CHUNKS} chunks of "
            f"{APPROX_CHUNK}: power sums max_rel_err={prel:.3e} (band {POWER_RTOL:g}); "
            f"approx: nscores differ on {nd} windows (allowed "
            f"{int((1 - NSCORES_SAME_SHARE) * PB)}), max |dlog10 p|={dl.max():.3e} "
            f"(band {LOG10_P_BAND:g}), {int((ap.nscores > 1024).sum())} windows escalated; "
            f"two calls bit-equal={repeat}; kernel {ms:.3f} ms plain {pms:.3f} ms")
        check(prel <= POWER_RTOL, f"css_mc_power {stream}: power sums {prel}")
        check(same.mean() >= NSCORES_SAME_SHARE, f"css_mc_power {stream}: {nd} nscores differ")
        check(float(dl.max()) <= LOG10_P_BAND, f"css_mc_power {stream}: p {dl.max()}")
        r9[stream] = (abs_err(kp, pp), prel, ms, pms)
        r9["differ"][stream] = nd
        out_bytes = APPROX_CHUNKS * 3 * PB * 8
        if stream == "shared":
            # the launches alone: css_mc_coeff's M and the product with its
            # power epilogue and tile sum (the wrapper syncs on the key)
            with timed_launches(torch, kperm, ("css_mc_coeff", "css_mc_power")) as spans:
                for _ in range(3):
                    kern()
            torch.cuda.synchronize()
            kms = {k: sum(a.elapsed_time(b) for a, b in v) / 3 for k, v in spans.items()}
            r9["kernel_ms"], r9["coeff_ms"] = kms["css_mc_power"], kms["css_mc_coeff"]
            say(f"[K9 css_mc_power shared] launches alone (CUDA events, mean of 3 calls): "
                f"css_mc_power {kms['css_mc_power']:.3f} ms, css_mc_coeff "
                f"{kms['css_mc_coeff']:.4f} ms")
            M = kperm.shared_coeff(key, 0, APPROX_CHUNKS, m, ASIZE, BSIZE, APPROX_CHUNK, dev)
            r9["bound_shared"] = bound(PB * m * m * 4 + M.numel() * 4 + out_bytes,
                                       {"f32": 2 * m * m * nperm, "f64": 5 * nperm})
            flat = pdist.reshape(PB, m * m)
            r9["library_ms"] = cuda_ms(torch, lambda: flat @ M, 3)
            say(f"[K9] library yardstick torch.matmul [{PB}, {m * m}] @ [{m * m}, "
                f"{M.shape[1]}]: {r9['library_ms']:.3f} ms")
            del M
        else:
            ops = {t: v * nperm for t, v in window_ops("mix", m, ASIZE).items()}
            ops["f64"] = 5 * nperm
            r9["bound_window"] = bound(PB * (m * m * 4 + 16) + out_bytes, ops)
        del kp, pp
    r9["fast"], r9["bound"] = r9["shared"], r9["bound_shared"]
    del pdist, pwkeys

    # K9 alone on the ~800 k bench windows' CMDS distances
    lo8, npos8, slot8 = plan_ids
    npos8_d = npos8.to(dev)
    d8 = kcss.css_cmds(kcss.css_dissim(pair.to_device(dev), lo8, npos8, torch.float32),
                       npos8_d, ASIZE, BSIZE)[1]
    wk8 = rng.window_keys(key, np.zeros(len(slot8), np.int64), slot8.numpy())
    r9["bench_ms"] = {}
    for stream in ("shared", "window"):
        keys = key if stream == "shared" else wk8
        _, ms = event_ms(torch, lambda: kperm.null_power_sums(
            d8, keys, ASIZE, BSIZE, APPROX_CHUNK, 0, APPROX_CHUNKS, stream))
        r9["bench_ms"][stream] = ms
        say(f"[K9 css_mc_power {stream}, bench] {d8.shape[0]} windows x {APPROX_CHUNKS} "
            f"chunks of {APPROX_CHUNK}: kernel {ms:.1f} ms "
            f"({d8.shape[0] * APPROX_CHUNK * APPROX_CHUNKS / ms * 1e3:,.0f} permutations/s, "
            "one call)")
    del d8, wk8
    torch.cuda.empty_cache()


PHASE11_OPTIONS = [
    ({"p_mode": "approx"}, ("fast", "exact")),
    ({"p_mode": "approx", "mc_stream": "window"}, ("fast", "exact")),
    ({"mc_stream": "window"}, ("fast", "exact")),
    ({"mc_stream": "window", "rng": "threefry"}, ("fast",)),
    ({"rng": "threefry"}, ("fast",)),
    ({"perm_backend": "native"}, ("fast", "exact")),
]


def phase_window_library(torch, dev, card, tmp: Path) -> None:
    """Phase 11: run_css with every phase-2 option on the 200 k-SNP
    workload; run_css_multi on the card against run_css on the CPU; the CLI
    with the new flags on phase 9's small files."""
    import numpy as np

    from divergence_tpu_torch.config import CssConfig
    from divergence_tpu_torch.engine import SnpPair, run_css, run_css_multi
    from divergence_tpu_torch.io import read_score_track
    from divergence_tpu_torch.tools import cli, synth

    npos_, region, seed, _ = POWER_WORKLOAD
    pos, am, bm = synth.make_chromosome(npos_, region, ASIZE, BSIZE, seed)
    pair = SnpPair(pos, am, bm)
    for kw, precs in PHASE11_OPTIONS:
        for prec in precs:
            cfg = CssConfig(precision=prec, mc_runs=MC_RUNS, **kw)
            (scores, pvals), summary, walls = warm_runs(
                lambda sm: run_css(pair, region, cfg, device=dev, summary=sm))
            c, t = summary.counters, summary.timings_s
            scored = scores != 0
            check(scores.shape == (region // 500,) and not np.isnan(scores).any()
                  and not np.isnan(pvals).any(), f"run_css {kw} {prec}: shape or NaN")
            check(c["windows_scored"] == int(scored.sum()) > 0, f"run_css {kw}: scored")
            check(bool(((pvals[scored] > 0) & (pvals[scored] <= 1)).all()), "run_css p range")
            best, med = min(walls), float(np.median(walls))
            say(f"[window library {prec}] run_css {npos_} SNPs / {region} bp {kw}: "
                f"{c['windows_scored']} windows scored, {c['mc_permutations']} MC "
                f"permutations; warm wall min {best:.4f} s median {med:.4f} s; "
                f"{c['windows_scored'] / best:,.0f} windows/s, "
                f"{c['mc_permutations'] / best:,.0f} perms/s (stages: dispatch "
                f"{t.get('css_dispatch', 0):.4f} s, phase-1 sync "
                f"{t.get('css_phase1_sync', 0):.4f} s, phase 2 {t.get('css_mc', 0):.4f} s) "
                f"on {card}")
            if prec == "fast":
                wall, dev_ms, top = device_profile(
                    torch, lambda: run_css(pair, region, cfg, device=dev))
                check(dev_ms > 0, f"run_css {kw}: the profiler saw no device time")
                say(f"[window library fast] profiled run_css {kw}: wall {wall:.1f} ms, device "
                    f"{dev_ms:.1f} ms ({100 * dev_ms / wall:.1f} % busy); most device time: "
                    + "; ".join(f"{name[:60]} {ms:.2f} ms" for ms, name in top[:3]))

    # the card against the CPU, exact, the MC cut to MULTI_MC_RUNS
    pairs = {}
    for i, seqid in enumerate(("chrII", "chrIII", "chrIV")):
        p, a, b = synth.make_panel(MULTI_SNPS, MULTI_REGION, ASIZE, BSIZE, seed=30 + i)
        pairs[seqid] = (SnpPair(p, a, b), MULTI_REGION)
    for kw, _ in PHASE11_OPTIONS:
        cfg = CssConfig(precision="exact", seed=3, mc_runs=MULTI_MC_RUNS, **kw)
        t0 = time.perf_counter()
        gpu = run_css_multi(pairs, cfg, device=dev)
        t_gpu = time.perf_counter() - t0
        n_scored = n_beyond = n_pdiff = 0
        worst = 0.0
        t0 = time.perf_counter()
        for seqid, (p, regend) in pairs.items():
            g, c = gpu[seqid], run_css(p, regend, cfg, device="cpu", seqid=seqid)
            check(np.array_equal(g[0] != 0, c[0] != 0), f"{seqid} {kw}: scored windows differ")
            ok = c[0] != 0
            err = np.abs(g[0] - c[0]) / np.maximum(np.abs(c[0]), 1.0)
            n_scored += int(ok.sum())
            n_beyond += int((err > TOL_CSS).sum())
            worst = max(worst, float(err.max()))
            if kw.get("p_mode") == "approx":
                dl = np.abs(np.log10(g[1][ok]) - np.log10(c[1][ok]))
                n_pdiff += int((dl > LOG10_P_BAND).sum())
            else:
                n_pdiff += int((g[1] != c[1]).sum())
        t_cpu = time.perf_counter() - t0
        rule = f"|dlog10 p| > {LOG10_P_BAND:g}" if kw.get("p_mode") == "approx" else "p differs"
        say(f"[window library exact] run_css_multi {kw} on the card vs run_css on the CPU "
            f"(3 x {MULTI_SNPS} SNPs, {n_scored} windows, mc_runs {MULTI_MC_RUNS}): "
            f"scores max_rel_err {worst:.3e}, {n_beyond} beyond {TOL_CSS:g}; {rule} on "
            f"{n_pdiff} windows; card {t_gpu:.2f} s, CPU {t_cpu:.2f} s")
        check(n_scored > 0 and n_beyond == 0, f"run_css_multi {kw}: {n_beyond} windows beyond")
        check(n_pdiff <= 0.01 * n_scored, f"run_css_multi {kw}: {n_pdiff} p differ")

    # the CLI with the new flags on phase 9's small files
    a_path, b_path = tmp / "small_popA.gtrack", tmp / "small_popB.gtrack"
    check(a_path.exists() and b_path.exists(), "phase 9's small GTrack files are missing")
    for flags in (["--p-mode", "approx"], ["--mc-stream", "window", "--rng", "threefry"],
                  ["--perm-backend", "native"]):
        out, summary = tmp / "small_window.track", tmp / "small_window.json"
        t0 = time.perf_counter()
        cli.main(["run-css", "--pop-a", str(a_path), "--pop-b", str(b_path), "--out", str(out),
                  "--summary", str(summary), "--device", str(dev), *flags])
        wall = time.perf_counter() - t0
        _, starts, sc, pv = read_score_track(out)
        counters = json.loads(summary.read_text())["counters"]
        say(f"[window cli] run-css {' '.join(flags)}: {len(starts)} rows, p in "
            f"[{pv.min():.3g}, {pv.max():.3g}], {counters['mc_permutations']} permutations, "
            f"wall {wall:.2f} s")
        check(len(starts) == counters["windows_scored"] > 0, f"cli {flags}: rows")
        check(not np.isnan(sc).any() and bool(((pv > 0) & (pv <= 1)).all()), f"cli {flags}")


def gather_windows(torch, vals, lo, npos, P: int, pad_to: int = 1):
    """[B', P, a] and [B', P, b] int16 codes on ``vals``' device of the
    windows (lo, npos) — rows past a window's npos repeat its first row —
    and host (npos, slot-padding) counts: B' = B rounded up to a multiple
    of ``pad_to``, the extra windows empty (npos 0)."""
    from divergence_tpu_torch.parallel import pad_to_multiple

    dev = vals.device
    B = lo.numel()
    Bp = pad_to_multiple(B, pad_to)
    offs = torch.arange(P, device=dev)[None, :]
    lo_d, npos_d = lo.to(dev), npos.to(dev)
    idx = torch.where(offs < npos_d[:, None], lo_d[:, None] + offs, lo_d[:, None])
    g = vals[idx]                                          # [B, P, a+b]
    del idx
    av = torch.zeros((Bp, P, ASIZE), dtype=torch.int16, device=dev)
    bv = torch.zeros((Bp, P, BSIZE), dtype=torch.int16, device=dev)
    av[:B] = g[..., :ASIZE]
    bv[:B] = g[..., ASIZE:]
    del g
    return av, bv, Bp


def phase_step_kernels(torch, pair, plan, ids, dev, results, k2_bench) -> dict:
    """Phase 12: K10 and K11 against their plain versions on the 19,997
    windows of the 200 k workload (K10 both precisions, K11 both draw
    streams; K11 also on a 200 k-SNP stickleback-shaped panel, where the
    null is hit), K11 against K8's first chunk on that panel, and K10 on
    the ~800 k bench windows bit-equal to phase 2's K1 -> K2.  Returns the
    bench windows, gathered for phase 13."""
    import numpy as np

    from divergence_tpu_torch import rng
    from divergence_tpu_torch.engine import SnpPair
    from divergence_tpu_torch.engine.fet_engine import chromosome_key
    from divergence_tpu_torch.kernels import css as kcss
    from divergence_tpu_torch.kernels import fet as kfet
    from divergence_tpu_torch.kernels import perm as kperm
    from divergence_tpu_torch.tools.synth import make_chromosome, make_panel

    maxs, nmax = kfet.support_size(ASIZE, BSIZE), ASIZE + BSIZE + 2
    m = ASIZE + BSIZE
    r10, r11 = results["fet_window"], results["css_perm_chunk"]

    # K10 against its plain version on the 200 k workload's windows
    npos_, region, seed = STEP_WORKLOAD[:3]
    pos, am, bm = make_chromosome(npos_, region, ASIZE, BSIZE, seed)
    lo, npos, slot = windows_of(torch, pos, region)
    P = kfet._window_pad(int(npos.max()))
    av, bv, B = gather_windows(torch, SnpPair(pos, am, bm).to_device(dev), lo, npos, P)
    n_tests = int(npos.sum())
    key = rng.fold_in(rng.prng_key(0), 0)
    r10["differ"] = {}
    for prec in ("fast", "exact"):
        fast = prec == "fast"
        tol = TOL[prec]
        kern = lambda: kfet.fet_window_batch(  # noqa: E731
            av, bv, npos, 0.95, key, 100, maxs, nmax, fast, slot)
        plain = lambda: kfet.fet_window_batch_plain(  # noqa: E731
            av, bv, npos, 0.95, key, 100, maxs, nmax, fast, slot)
        (ks, kd), (ps, pd) = kern(), plain()
        torch.cuda.synchronize()
        err_sc = rel_err(ks, ps)
        sd_rel = (kd.double() - pd.double()).abs() / pd.double().abs().clamp(min=1.0)
        beyond = int((sd_rel > tol).sum())
        ms = cuda_ms(torch, kern, 10)
        pms = cuda_ms(torch, plain, 2)
        say(f"[K10 fet_window {prec}] {B} windows (P={P}, {n_tests} SNP tests): scores "
            f"max_rel_err={err_sc:.3e} (tol {tol:g}); stddev {beyond} windows beyond tol "
            f"(allowed {int(STDDEV_BEYOND_SHARE * B) + 1}); kernel {ms:.4f} ms plain "
            f"{pms:.4f} ms")
        check(err_sc <= tol, f"fet_window {prec} scores: {err_sc}")
        check(beyond <= STDDEV_BEYOND_SHARE * B + 1, f"fet_window {prec} stddev: {beyond}")
        check(bool(torch.isfinite(ks).all() and torch.isfinite(kd).all()),
              f"fet_window {prec}: non-finite")
        r10[prec] = (max(abs_err(ks, ps), abs_err(kd, pd)), max(err_sc, float(sd_rel.max())),
                     ms, pms)
        r10["differ"][prec] = beyond
        if fast:   # the windows' codes in, 2 values out; two compares a code and
            # at least one threefry draw (~60 integer operations) per sample
            r10["bound"] = bound(n_tests * m * 2 + B * 16 + B * 2 * 4,
                                 {"f32": 2 * m * n_tests + B * 100 * 60})

    # K11 against its plain version on the windows' exact CSS distances (as
    # the step gives them), timed on the workload's; then on the panel's
    mc_key = rng.fold_in(rng.prng_key(0), 2).to(dev)
    r11["differ"] = {}
    hpos, ham, hbm = make_panel(*HIT_PANEL[:2], ASIZE, BSIZE, seed=HIT_PANEL[2])
    hlo, hnpos, hslot = windows_of(torch, hpos, HIT_PANEL[1])
    hav, hbv, HB = gather_windows(torch, SnpPair(hpos, ham, hbm).to_device(dev), hlo, hnpos,
                                  kfet._window_pad(int(hnpos.max())))
    for label, (wa, wb, wn, ws) in (("workload", (av, bv, npos, slot)),
                                    ("panel", (hav, hbv, hnpos, hslot))):
        css_s, dist, _ = kcss.css_window_batch(
            wa, wb, wn, rng.fold_in(rng.prng_key(0), 1), ASIZE, BSIZE, slot=ws)
        wkeys = rng.fold_in(rng.fold_in(mc_key, 0), ws.to(dev))
        WB = wn.numel()
        ones = torch.ones(WB, dtype=torch.int32, device=dev)
        perms = WB * PERM_CHUNK
        for bitgen in ("mix", "threefry"):
            kern = lambda: kperm.permutation_chunk(  # noqa: E731
                dist, css_s, ones, PERM_CHUNK, wkeys, ASIZE, BSIZE, PERM_CHUNK, bitgen)
            plain = lambda: kperm.permutation_chunk_plain(  # noqa: E731
                dist, css_s, ones, PERM_CHUNK, wkeys, ASIZE, BSIZE, PERM_CHUNK, bitgen)
            k, q = kern(), plain()
            torch.cuda.synchronize()
            differ = (k[0] != q[0]) | (k[1] != q[1]) | (k[2] != q[2])
            nd = int(differ.sum())
            timing = ""
            if label == "workload":
                ms = cuda_ms(torch, kern, 10)
                pms = cuda_ms(torch, plain, 1)
                timing = (f"; kernel {ms:.4f} ms plain {pms:.4f} ms "
                          f"({perms / ms * 1e3:,.0f} permutations/s)")
                r11[bitgen] = (float((k[0] - q[0]).abs().max()), 0.0, ms, pms)
                ops = {t: v * perms for t, v in window_ops(bitgen, m, ASIZE).items()}
                r11[f"bound_{bitgen}"] = bound(WB * (m * m * 4 + 4 + 4 + 16) + WB * 9, ops)
            say(f"[K11 css_perm_chunk {bitgen}, {label}] {WB} windows x {PERM_CHUNK} "
                f"permutations ({int(k[0].sum())} hits, {int(k[1].sum())} windows reach "
                f"need = 1): {nd} windows differ from the plain version (allowed 0){timing}")
            check(nd == 0, f"css_perm_chunk {bitgen} ({label}): {nd} windows differ")
            r11["differ"][f"{bitgen}_{label}"] = nd
    r11["fast"], r11["bound"] = r11["mix"], r11["bound_mix"]
    check(int(k[0].sum()) > 0, "css_perm_chunk: the panel's null is never hit")

    # K11 against K8's first chunk on the panel: keys fold_in(wkey, 0), need =
    # threshold
    B = HB
    chunk8 = 256
    nsc8, hits8 = kperm.mc_window(dist, css_s.float(), wkeys, ASIZE, BSIZE, chunk8, chunk8, 10)
    h11, reached, pos11 = kperm.permutation_chunk(
        dist, css_s, torch.full((B,), 10, dtype=torch.int32, device=dev), chunk8,
        rng.fold_in(wkeys, 0), ASIZE, BSIZE, chunk8)
    stopped = hits8 == 10
    same = (torch.equal(reached, stopped)
            and torch.equal((pos11 + 1)[stopped], nsc8[stopped])
            and torch.equal(h11[~stopped], hits8[~stopped]))
    say(f"[K11 vs K8] first chunk of {chunk8}, threshold 10: K8 stops {int(stopped.sum())} "
        f"of {B} windows inside it; K11 reaches the threshold on the same windows at the "
        f"same permutation and counts the others' hits alike: {same}")
    check(same, "css_perm_chunk disagrees with css_mc_window's first chunk")
    check(int(stopped.sum()) > 0, "css_mc_window stops no panel window in its first chunk")
    r11["k8_stopped"] = int(stopped.sum())
    del av, bv, hav, hbv, dist, css_s, wkeys
    torch.cuda.empty_cache()

    # K10 on the ~800 k bench windows: phase 2's K1 -> K2 bit for bit
    lo8, npos8, slot8 = (torch.from_numpy(a[ids].copy()) for a in (plan.lo, plan.npos, plan.slot))
    bav, bbv, Bp = gather_windows(torch, pair.to_device(dev), lo8, npos8, STEP_P, STEP_SHARES)
    B8 = lo8.numel()
    ckey = chromosome_key(0, "chrBench")
    r10["bench_ms"], r10["bit_equal"] = {}, True
    for prec in ("fast", "exact"):
        fast = prec == "fast"
        (s, d), ms = event_ms(torch, lambda: kfet.fet_window_batch(
            bav[:B8], bbv[:B8], npos8, 0.95, ckey, 100, maxs, nmax, fast, slot8))
        eq = torch.equal(s, k2_bench[prec][0]) and torch.equal(d, k2_bench[prec][1])
        say(f"[K10 fet_window {prec}, bench] {B8} windows at P={STEP_P}: bit-equal to phase "
            f"2's K1 -> K2: {eq}; kernel {ms:.3f} ms (one call)")
        check(eq, f"fet_window {prec} differs from K1 -> K2 on the bench windows")
        r10["bench_ms"][prec] = ms
    pad = Bp - B8
    return {
        "av": bav, "bv": bbv, "B": B8,
        "npos": torch.cat([npos8, torch.zeros(pad, dtype=torch.int64)]),
        "slot": torch.cat([slot8, torch.zeros(pad, dtype=torch.int64)]),
    }


def phase_step_library(torch, gathered, dev, card, tmp: Path, results) -> None:
    """Phase 13: the sharded step at full width on the ~800 k bench windows
    (warm min of 3, profiled), over 4 shares of the card against 1 (bit-
    equal), against its all-plain version on 20,000 windows; bench-scaling
    at its defaults; run-fet and run-css with --shard and with
    --num-hosts 2 + merge-tracks on phase 9's small files, byte-equal to
    the unsharded tracks."""
    import numpy as np

    from divergence_tpu_torch import rng
    from divergence_tpu_torch.kernels import css as kcss
    from divergence_tpu_torch.parallel import make_divergence_step, make_mesh
    from divergence_tpu_torch.tools import cli
    from divergence_tpu_torch.tools.bench_scaling import run_scaling_bench

    av, bv, npos, slot, B = (gathered[k] for k in ("av", "bv", "npos", "slot", "B"))
    Bp = av.shape[0]
    key = rng.prng_key(0)
    names = ("fet_scores", "fet_stddev", "css_scores", "css_valid", "mc_hits")
    one = make_divergence_step(make_mesh(devices=[dev]), ASIZE, BSIZE)
    four = make_divergence_step(make_mesh(devices=[dev] * STEP_SHARES), ASIZE, BSIZE)

    def step_walls(step, reps=3):
        step(av, bv, npos, slot, key)                       # warm
        walls = []
        for _ in range(reps):
            out, ms = host_ms(torch, lambda: step(av, bv, npos, slot, key))
            walls.append(ms)
        return out, walls

    out1, walls1 = step_walls(one)
    n_eval = float(out1["windows_evaluated"])
    n_valid = int(out1["css_valid"].sum())
    check(all(out1[k].shape == (Bp,) for k in names), "step: output shapes")
    check(n_eval == B, f"step: windows_evaluated {n_eval} != {B}")
    check(bool(torch.isfinite(out1["fet_scores"]).all() and torch.isfinite(out1["fet_stddev"]).all()
               and torch.isfinite(out1["css_scores"]).all()), "step: non-finite outputs")
    check(bool(((out1["mc_hits"] >= 0) & (out1["mc_hits"] <= PERM_CHUNK)).all()), "step: hits")
    check(np.isfinite(float(out1["score_sum"])) and n_valid > 0.9 * B, "step: score_sum / valid")
    wall, dev_ms, top = device_profile(torch, lambda: one(av, bv, npos, slot, key))
    check(dev_ms > 0, "step: the profiler saw no device time")
    say(f"[step] make_divergence_step(11, 10) defaults on {B} bench windows (+{Bp - B} empty, "
        f"P={STEP_P}), 1 device: warm wall min {min(walls1):.1f} ms median "
        f"{float(np.median(walls1)):.1f} ms ({B / min(walls1) * 1e3:,.0f} windows/s); "
        f"{n_valid} CSS-valid windows, score_sum {float(out1['score_sum']):.6f}, "
        f"{int(out1['mc_hits'].sum())} MC hits; profiled wall {wall:.1f} ms, device "
        f"{dev_ms:.1f} ms ({100 * dev_ms / wall:.1f} % busy); most device time: "
        + "; ".join(f"{name[:50]} {ms:.2f} ms" for ms, name in top[:3]) + f" on {card}")

    out4, walls4 = step_walls(four)
    same = {k: torch.equal(out1[k], out4[k]) for k in names}
    s1, s4 = float(out1["score_sum"]), float(out4["score_sum"])
    say(f"[step] {STEP_SHARES} shares of the card: warm wall min {min(walls4):.1f} ms; "
        f"per-window outputs bit-equal to 1 share: {same}; score_sum rel diff "
        f"{abs(s1 - s4) / abs(s1):.2e} (tol 1e-9)")
    check(all(same.values()), f"step over {STEP_SHARES} shares differs: {same}")
    check(abs(s1 - s4) <= 1e-9 * abs(s1), "step over shares: score_sum")
    check(float(out4["windows_evaluated"]) == n_eval, "step over shares: windows_evaluated")
    del out4

    # the step against its all-plain version on the first windows
    n = STEP_PLAIN_WINDOWS
    args = (av[:n], bv[:n], npos[:n], slot[:n], key)
    outk = one(*args)
    plain = make_divergence_step(make_mesh(devices=[dev]), ASIZE, BSIZE, plain=True)
    outp, pms = host_ms(torch, lambda: plain(*args))
    _, kms = host_ms(torch, lambda: one(*args))
    err_f = rel_err(outk["fet_scores"], outp["fet_scores"])
    sd_rel = ((outk["fet_stddev"] - outp["fet_stddev"]).abs()
              / outp["fet_stddev"].abs().clamp(min=1.0))
    sd_beyond = int((sd_rel > TOL["exact"]).sum())
    joint = torch.cat([av[:n], bv[:n]], dim=-1).reshape(n * STEP_P, ASIZE + BSIZE)
    dis = kcss.css_dissim(joint, torch.arange(n) * STEP_P, npos[:n], torch.float64)
    ok = gap_ok(torch, kcss, dis)
    dcss = (outk["css_scores"] - outp["css_scores"]).abs()
    err_c = float((dcss / outp["css_scores"].abs().clamp(min=1.0))[ok].max())
    hits_differ = int((outk["mc_hits"] != outp["mc_hits"]).sum())
    dsum = abs(float(outk["score_sum"]) - float(outp["score_sum"]))
    allowed_sum = 1e-9 * abs(float(outp["score_sum"])) + float(dcss[~ok].sum())
    say(f"[step vs plain] {n} windows: fet max_rel_err {err_f:.3e}, stddev {sd_beyond} beyond "
        f"{TOL['exact']:g}; css max_rel_err {err_c:.3e} on {int(ok.sum())} windows (eigengap "
        f"> {GAP_BOUND:g}); valid equal {torch.equal(outk['css_valid'], outp['css_valid'])}; "
        f"mc_hits differ on {hits_differ} (allowed {int(MC_DIFFER_SHARE * n) + 1}); "
        f"score_sum diff {dsum:.3e} (allowed {allowed_sum:.3e}); step {kms:.1f} ms, plain "
        f"step {pms:.1f} ms (host wall, one call)")
    check(err_f <= TOL["exact"] and sd_beyond <= STDDEV_BEYOND_SHARE * n + 1, "step vs plain: fet")
    check(err_c <= TOL_CSS and ok.float().mean() >= 0.99, "step vs plain: css")
    check(torch.equal(outk["css_valid"], outp["css_valid"]), "step vs plain: valid")
    check(hits_differ <= MC_DIFFER_SHARE * n + 1, f"step vs plain: {hits_differ} hits differ")
    check(float(outk["windows_evaluated"]) == float(outp["windows_evaluated"]) and
          dsum <= allowed_sum, "step vs plain: summaries")
    results["step"] = {"wall_ms": min(walls1), "wall_4_ms": min(walls4), "busy": dev_ms / wall,
                       "plain_ms": pms, "kernel_ms_20k": kms}
    del outk, outp, joint, dis

    # bench-scaling at its defaults over the card's devices
    t0 = time.perf_counter()
    report = run_scaling_bench()
    say(f"[bench-scaling] {json.dumps(report)} ({time.perf_counter() - t0:.1f} s)")
    check(report["backend"] == "cuda" and all(
        np.isfinite(r["efficiency"]) and r["windows_per_s"] > 0
        for series in ("weak_scaling", "strong_scaling") for r in report[series]),
        "bench-scaling report")

    # the CLI: --shard, and two hosts merged, byte-equal to the plain run
    a_path, b_path = tmp / "small_popA.gtrack", tmp / "small_popB.gtrack"
    check(a_path.exists() and b_path.exists(), "phase 9's small GTrack files are missing")
    for sub in ("run-fet", "run-css"):
        base = [sub, "--pop-a", str(a_path), "--pop-b", str(b_path), "--device", str(dev)]
        ref, shard = tmp / "step_ref.track", tmp / "step_shard.track"
        walls = {}
        for name, out, extra in (("plain", ref, []), ("shard", shard, ["--shard"])):
            t0 = time.perf_counter()
            cli.main(base + ["--out", str(out), *extra])
            walls[name] = time.perf_counter() - t0
        shards = [tmp / f"step_h{h}.track" for h in (0, 1)]
        t0 = time.perf_counter()
        for h, out in enumerate(shards):
            cli.main(base + ["--out", str(out), "--num-hosts", "2", "--host-id", str(h)])
        walls["2 hosts"] = time.perf_counter() - t0
        merged = tmp / "step_merged.track"
        cli.main(["merge-tracks", "--inputs", *map(str, shards), "--out", str(merged)])
        rows = [len(p.read_text().splitlines()) - 1 for p in shards]
        eq_shard = shard.read_bytes() == ref.read_bytes()
        eq_merge = merged.read_bytes() == ref.read_bytes()
        say(f"[step cli] {sub}: --shard byte-equal {eq_shard}; --num-hosts 2 shards of "
            f"{rows} rows merged byte-equal {eq_merge}; walls "
            + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))
        check(eq_shard and eq_merge and min(rows) > 0, f"{sub}: sharded or merged track differs")


def float_bits(torch, t):
    """A float tensor's bits, for equality that tells -0.0 from +0.0."""
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def phase_rank_kernels(torch, pair, plan_ids, dev, results, k2_bench, card) -> None:
    """Phase 14: K1r and K2r on the bench FET workload, both precisions:
    ``fet_lut_rank`` against its plain version on K1's LUT, exactly, at
    11 + 10 and at RANK_BIG_PANEL; ``fet_snp_ranks`` on the 8 M SNPs (the
    ranks of the kernel's own LUT exactly, the scores against the plain
    version's); ``fet_aggregate_ranks`` on the ~800 k windows against its
    plain version and equal to phase 2's K1 -> K2 on every window (-0.0 ==
    0.0), timed beside K2; ``run_fet`` exact by the old route (K1 -> K2) and
    the rank route, warm walls in turns, equal outputs."""
    import numpy as np

    from divergence_tpu_torch.config import FetConfig
    from divergence_tpu_torch.engine import fet_engine, run_fet
    from divergence_tpu_torch.engine.fet_engine import chromosome_key
    from divergence_tpu_torch.kernels import fet as kfet

    maxs, nmax = kfet.support_size(ASIZE, BSIZE), ASIZE + BSIZE + 2
    vals = pair.to_device(dev)
    lo, npos, slot = plan_ids
    B, N = lo.numel(), vals.shape[0]
    key = chromosome_key(0, "chrBench")
    idx = kfet._lut_index(kfet.count_tables(vals[:, :ASIZE], vals[:, ASIZE:]), ASIZE, BSIZE)
    rl, rs, ra = (results[k] for k in ("fet_lut_rank", "fet_snp_ranks", "fet_aggregate_ranks"))
    big = RANK_BIG_PANEL
    check(kfet.lut_active(big, big) and not kfet.lut_active(big + 1, big + 1),
          f"{big} + {big} must be the largest symmetric panel with a LUT")
    for prec in ("fast", "exact"):
        fast = prec == "fast"
        dt = torch.float32 if fast else torch.float64
        tol = TOL[prec]

        # K1r's LUT sort: one counting pass at 11 + 10, runs + merges at 38 + 38
        for a, b in ((ASIZE, BSIZE), (big, big)):
            label = f"{a}+{b}"
            lut = kfet.fet_lut(a, b, kfet.support_size(a, b), a + b + 2, dt, dev)
            (ks, kr), (ps, pr) = kfet.fet_lut_rank(lut), kfet.fet_lut_rank_plain(lut)
            torch.cuda.synchronize()
            eq = torch.equal(kr, pr) and torch.equal(float_bits(torch, ks), float_bits(torch, ps))
            ms = cuda_ms(torch, lambda: kfet.fet_lut_rank(lut), 20)
            pms = cuda_ms(torch, lambda: kfet.fet_lut_rank_plain(lut), 5)
            G = lut.numel()
            say(f"[K1r fet_lut_rank {prec}, {label}] G={G}: sorted LUT and ranks equal to the "
                f"plain version's: {eq}; kernel {ms:.4f} ms plain {pms:.4f} ms")
            check(eq, f"fet_lut_rank {prec} {label} differs from its plain version")
            if a == ASIZE:
                rl[prec] = (0.0, 0.0, ms, pms)
                if fast:   # G values in, G values and ranks out; a comparison
                    # sort's G log2 G compares of (value, index)
                    rl["bound"] = bound(G * 4 * 3, {"f32": 2 * G * int(np.ceil(np.log2(G)))})
            else:
                rl[f"big_{prec}"] = (G, ms, pms)
        del lut, ks, kr, ps, pr

        # K1r per SNP: the 8 M SNPs (K1's LUT build, the sort, the lookup)
        ls, r = kfet.fet_snp_ranks(vals, ASIZE, maxs, nmax, fast)
        pls, prr = kfet.fet_snp_ranks_plain(vals, ASIZE, maxs, nmax, fast)
        _, own = kfet.fet_lut_rank_plain(kfet.fet_lut(ASIZE, BSIZE, maxs, nmax, dt, dev))
        torch.cuda.synchronize()
        same = torch.equal(r, own[idx])
        got, want = ls[r.long()], pls[prr.long()]
        err = rel_err(got, want)
        ms = cuda_ms(torch, lambda: kfet.fet_snp_ranks(vals, ASIZE, maxs, nmax, fast), 10)
        pms = cuda_ms(torch, lambda: kfet.fet_snp_ranks_plain(vals, ASIZE, maxs, nmax, fast), 3)
        say(f"[K1r fet_snp_ranks {prec}] N={N}: ranks of the kernel's LUT exact: {same}; scores "
            f"lut_sorted[ranks] max_rel_err={err:.3e} (tol {tol:g}) against the plain "
            f"version's; kernel {ms:.4f} ms plain {pms:.4f} ms (LUT build, sort and lookup)")
        check(same and err <= tol, f"fet_snp_ranks {prec}: ranks {same}, scores {err}")
        rs[prec] = (abs_err(got, want), err, ms, pms)
        if fast:   # the codes in, the ranks out; two compares a code
            rs["bound"] = bound(vals.numel() * 2 + N * 4, {"f32": 2 * vals.numel()})
        del got, want, pls, prr, own

        # K2r on every window of the bench chromosome
        agg = lambda: kfet.fet_aggregate_ranks(ls, r, lo, npos, slot, key, 0.95, 100)  # noqa: E731
        plain = lambda: kfet.fet_aggregate_ranks_plain(  # noqa: E731
            ls, r, lo, npos, slot, key, 0.95, 100)
        ka, pa = agg(), plain()
        torch.cuda.synchronize()
        err_sc = rel_err(ka[0], pa[0])
        sd_rel = (ka[1].double() - pa[1].double()).abs() / pa[1].double().abs().clamp(min=1.0)
        beyond = int((sd_rel > tol).sum())
        equal_k2 = torch.equal(ka, k2_bench[prec])
        ms = cuda_ms(torch, agg, 10)
        pms = cuda_ms(torch, plain, 2)
        k2_ms = results["fet_aggregate"][prec][2]
        say(f"[K2r fet_aggregate_ranks {prec}] B={B} windows: scores max_rel_err={err_sc:.3e} "
            f"(tol {tol:g}); stddev {beyond} windows beyond tol (allowed "
            f"{int(STDDEV_BEYOND_SHARE * B)}); equal to phase 2's K1 -> K2 on every window: "
            f"{equal_k2}; kernel {ms:.4f} ms plain {pms:.4f} ms; K2 in phase 2 {k2_ms:.4f} ms "
            f"(fast {results['fet_aggregate']['fast'][2]:.4f}, exact "
            f"{results['fet_aggregate']['exact'][2]:.4f})")
        check(err_sc <= tol and beyond <= STDDEV_BEYOND_SHARE * B,
              f"fet_aggregate_ranks {prec}: {err_sc}, {beyond} stddev beyond")
        check(equal_k2, f"fet_aggregate_ranks {prec} differs from K1 -> K2 on the bench windows")
        check(bool(torch.isfinite(ka).all()), f"fet_aggregate_ranks {prec}: non-finite")
        ra[prec] = (max(abs_err(ka[0], pa[0]), abs_err(ka[1], pa[1])),
                    max(err_sc, float(sd_rel.max())), ms, pms)
        ra[prec + "_beyond"] = beyond
        if fast:   # ranks, LUT and descriptors in, 2 values out; at least one
            # threefry draw (~60 integer operations) per bootstrap sample
            ra["bound"] = bound(N * 4 + ls.numel() * 4 + B * 3 * 8 + B * 2 * 4,
                                {"f32": B * 100 * 60})
        del ls, r, ka, pa
    ra["equal_k1_k2_800k"] = True

    # run_fet exact by the old route (K1 -> K2) and the rank route, in turns
    cfg = FetConfig(precision="exact")
    ranked = fet_engine.use_ranks
    walls, outs = {"K1 -> K2": [], "K1r -> K2r": []}, {}
    try:
        for route in ("K1 -> K2", "K1r -> K2r", "K1r -> K2r", "K1 -> K2"):
            fet_engine.use_ranks = ranked if route == "K1r -> K2r" else (lambda cfg, pair: False)
            run_fet(pair, BENCH_REGION, cfg, device=dev, seqid="chrBench")    # warm
            for _ in range(3):
                t0 = time.perf_counter()
                outs[route] = run_fet(pair, BENCH_REGION, cfg, device=dev, seqid="chrBench")
                walls[route].append(time.perf_counter() - t0)
    finally:
        fet_engine.use_ranks = ranked
    same = all(np.array_equal(a, b) for a, b in zip(outs["K1 -> K2"], outs["K1r -> K2r"]))
    say(f"[run_fet exact, bench] warm wall min / median: K1 -> K2 "
        f"{min(walls['K1 -> K2']):.4f} / {float(np.median(walls['K1 -> K2'])):.4f} s, "
        f"K1r -> K2r {min(walls['K1r -> K2r']):.4f} / "
        f"{float(np.median(walls['K1r -> K2r'])):.4f} s (turns old, new, new, old; 3 calls "
        f"each); outputs equal: {same}; on {card}")
    check(same, "run_fet exact: the rank route's output differs from K1 -> K2")
    ra["run_fet_exact_s"] = {k: min(v) for k, v in walls.items()}


def phase_run_all(torch, dev, tmp: Path, files) -> dict:
    """Phase 15: run-all on the card: phase 3's 500 k-SNP pair at the CLI
    default (fast) and at --precision exact, each track byte-equal to the
    staged run of phases 3 and 6; phase 9's 20,000-SNP files through
    run-all and through the staged subcommands, byte-equal (the report but
    for its run-summary timings); --num-hosts 2 writes no regions and its
    merged shards are the one-host tracks.  Returns the walls."""
    import os

    import numpy as np

    from divergence_tpu_torch.io import read_score_track
    from divergence_tpu_torch.tools import cli

    a_path, b_path, sizes = files
    walls = {}
    for prec in ("fast", "exact"):
        out = tmp / f"all_{prec}"
        t0 = time.perf_counter()
        cli.main(["run-all", "--pop-a", str(a_path), "--pop-b", str(b_path), "--outdir", str(out),
                  "--chrom-sizes", str(sizes), "--precision", prec, "--device", str(dev)])
        walls[prec] = time.perf_counter() - t0
        split = {name: json.loads((out / f"{name}_summary.json").read_text())["timings_s"]
                 for name in ("fet", "css")}
        _, fstarts, fsc, fsd = read_score_track(out / "fet.track")
        _, cstarts, csc, cp = read_score_track(out / "css.track")
        regions = {f: len([ln for ln in (out / f).read_text().splitlines()
                           if ln and not ln.startswith("#")])
                   for f in ("fet_regions.gtrack", "css_regions.gtrack")}
        same_fet = (out / "fet.track").read_bytes() == (tmp / f"fet_{prec}.track").read_bytes()
        same_css = prec != "fast" or (
            (out / "css.track").read_bytes() == (tmp / "css_fast.track").read_bytes())
        html = (out / "report.html").read_text()
        say(f"[run-all {prec}] {CLI_SNPS} SNPs: wall {walls[prec]:.2f} s (GTrack parse once); "
            f"stage split fet {split['fet']}, css {split['css']}; {len(fstarts)} FET and "
            f"{len(cstarts)} CSS rows, regions {regions}; fet.track byte-equal to phase 3's "
            f"run-fet: {same_fet}" + ("; css.track byte-equal to phase 6's run-css: "
                                      f"{same_css}" if prec == "fast" else ""))
        check(len(fstarts) > 0 and len(cstarts) > 0, f"run-all {prec}: empty track")
        check(bool(np.isfinite(fsc).all() and np.isfinite(fsd).all() and np.isfinite(csc).all()),
              f"run-all {prec}: non-finite values")
        check(bool(((cp > 0) & (cp <= 1)).all()), f"run-all {prec}: p outside (0, 1]")
        check(same_fet and same_css, f"run-all {prec}: a track differs from the staged run")
        check("FET score track" in html and "CSS regions" in html, f"run-all {prec}: report")

    # phase 9's small files: run-all against the staged subcommands
    small_a, small_b = tmp / "small_popA.gtrack", tmp / "small_popB.gtrack"
    check(small_a.exists() and small_b.exists(), "phase 9's small GTrack files are missing")
    inputs = ["--pop-a", str(small_a), "--pop-b", str(small_b), "--device", str(dev)]
    cwd = os.getcwd()
    try:
        for d in ("all", "staged"):
            (tmp / "pipe" / d / "out").mkdir(parents=True)
        os.chdir(tmp / "pipe" / "all")
        t0 = time.perf_counter()
        cli.main(["run-all", *inputs, "--outdir", "out"])
        walls["small run-all"] = time.perf_counter() - t0
        os.chdir(tmp / "pipe" / "staged")
        t0 = time.perf_counter()
        cli.main(["run-fet", *inputs, "--out", "out/fet.track", "--summary",
                  "out/fet_summary.json"])
        cli.main(["run-css", *inputs, "--out", "out/css.track"])
        cli.main(["filter-fet", "--scores", "out/fet.track", "--out", "out/fet_regions.gtrack"])
        cli.main(["call-css-regions", "--scores", "out/css.track", "--out",
                  "out/css_regions.gtrack"])
        cli.main(["report", "--fet-track", "out/fet.track", "--css-track", "out/css.track",
                  "--fet-regions", "out/fet_regions.gtrack", "--css-regions",
                  "out/css_regions.gtrack", "--run-summary", "out/fet_summary.json",
                  "--out", "out/report.html"])
        walls["small staged"] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    a, b = tmp / "pipe" / "all" / "out", tmp / "pipe" / "staged" / "out"
    names = ("fet.track", "css.track", "fet_regions.gtrack", "css_regions.gtrack")
    same = {f: (a / f).read_bytes() == (b / f).read_bytes() for f in names}

    def without_summary(path):
        head, _, rest = path.read_text().partition("<h2>Run summary</h2>")
        return head + rest.partition("</pre>")[2]

    same["report.html"] = without_summary(a / "report.html") == without_summary(b / "report.html")
    say(f"[run-all small] {SMALL_SNPS} SNPs: byte-equal to the staged subcommands {same}; "
        f"walls run-all {walls['small run-all']:.2f} s, staged {walls['small staged']:.2f} s")
    check(all(same.values()), f"run-all differs from the staged subcommands: {same}")

    # two hosts: shards only, merged = the one-host tracks
    hosts = [tmp / "pipe" / f"host{h}" for h in (0, 1)]
    t0 = time.perf_counter()
    for h, d in enumerate(hosts):
        cli.main(["run-all", *inputs, "--outdir", str(d), "--num-hosts", "2", "--host-id", str(h)])
    walls["small 2 hosts"] = time.perf_counter() - t0
    no_regions = not any((d / f).exists() for d in hosts
                         for f in ("fet_regions.gtrack", "css_regions.gtrack", "report.html"))
    merged = {}
    for f in ("fet.track", "css.track"):
        cli.main(["merge-tracks", "--inputs", *(str(d / f) for d in hosts), "--out",
                  str(tmp / "pipe" / f"merged_{f}")])
        merged[f] = (tmp / "pipe" / f"merged_{f}").read_bytes() == (a / f).read_bytes()
    say(f"[run-all --num-hosts 2] no region files or report: {no_regions}; merged shards "
        f"byte-equal to the one-host tracks {merged}; both hosts {walls['small 2 hosts']:.2f} s")
    check(no_regions and all(merged.values()), "run-all --num-hosts 2")
    return walls


def smoke(torch, dev) -> tuple[str, list[dict]]:
    """Every phase on ``dev``; returns (card line, per-kernel results).
    Raises on the first failure."""
    import numpy as np

    from divergence_tpu_torch.core.windows import plan_windows
    from divergence_tpu_torch.engine import SnpPair
    from divergence_tpu_torch.kernels import _build
    from divergence_tpu_torch.kernels import css as kcss
    from divergence_tpu_torch.kernels import fet as kfet
    from divergence_tpu_torch.kernels import perm as kperm
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

    def timed_phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        say(f"[phase {name}] {time.perf_counter() - t:.1f} s")
        return out

    results = {name: {} for name in REPLACES}
    timed_phase("2", phase_kernels, torch, kfet, pair, (lo, npos, slot), dev, results)
    k2_out = {
        "fast": results["fet_aggregate"].pop("fast_out"),
        "exact": results["fet_aggregate"].pop("exact_out"),
        "slots": plan.slot[ids],
    }

    kfet.reset_launches()
    tmp = Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT))
    try:
        files = timed_phase("3", phase_cli, torch, kfet, dev, tmp)
        timed_phase("4", phase_library, torch, pair, n_tests, dev, card, k2_out)
        launches = {k: kfet.LAUNCHES[k] for k in FET_PATH}
        say(f"[FET main path] kernel launches: {launches}")
        check(all(v > 0 for v in launches.values()),
              f"the FET path did not launch every kernel: {launches}")
        k2_bench = {prec: k2_out[prec] for prec in ("fast", "exact")}
        del k2_out
        timed_phase("5", phase_css_kernels, torch, pair, (lo, npos, slot), dev, results)
        torch.cuda.empty_cache()

        kcss.reset_launches()
        kperm.reset_launches()
        timed_phase("6", phase_css_cli, torch, dev, tmp, files)
        timed_phase("7", phase_css_library, torch, dev, card)
        css_launches = {**kcss.LAUNCHES, **kperm.LAUNCHES}
        say(f"[CSS main path, CMDS] kernel launches: {css_launches}")
        check(all(css_launches[k] > 0 for k in CSS_CMDS_PATH),
              f"the CMDS CSS path did not launch every kernel: {css_launches}")
        launches.update({k: css_launches[k] for k in CSS_CMDS_PATH})
        timed_phase("8", phase_smacof_kernels, torch, pair, (lo, npos, slot), dev, results)

        kcss.reset_launches()
        kperm.reset_launches()
        timed_phase("9", phase_smacof_library, torch, dev, card, tmp)
        smacof_launches = {**kcss.LAUNCHES, **kperm.LAUNCHES}
        say(f"[CSS main path, SMACOF + drosophila] kernel launches: {smacof_launches}")
        smacof_path = ("css_dissim", "css_cmds", "css_smacof", "css_mc_coeff", "css_mc_shared",
                       "css_mc_scan")
        check(all(smacof_launches[k] > 0 for k in smacof_path),
              f"the SMACOF / drosophila CSS path did not launch every kernel: {smacof_launches}")
        launches["css_smacof"] = smacof_launches["css_smacof"]
        timed_phase("10", phase_window_kernels, torch, pair, (lo, npos, slot), dev, results)

        kcss.reset_launches()
        kperm.reset_launches()
        timed_phase("11", phase_window_library, torch, dev, card, tmp)
        window_launches = {**kperm.LAUNCHES}
        coeff_by_bitgen = dict(kperm.COEFF_LAUNCHES)
        say(f"[CSS main path, phase-2 options] kernel launches: {window_launches}; "
            f"css_mc_coeff by draw stream: {coeff_by_bitgen}")
        check(window_launches["css_mc_window"] > 0 and window_launches["css_mc_power"] > 0
              and coeff_by_bitgen["threefry"] > 0,
              f"the phase-2 options did not launch K8, K9 and threefry K7: "
              f"{window_launches}, {coeff_by_bitgen}")
        launches["css_mc_window"] = window_launches["css_mc_window"]
        launches["css_mc_power"] = window_launches["css_mc_power"]

        gathered = timed_phase("12", phase_step_kernels, torch, pair, plan, ids, dev,
                               results, k2_bench)
        for mod in (kfet, kcss, kperm):
            mod.reset_launches()
        timed_phase("13", phase_step_library, torch, gathered, dev, card, tmp, results)
        step_launches = {**kfet.LAUNCHES, **kcss.LAUNCHES, **kperm.LAUNCHES}
        say(f"[sharded step main path] kernel launches: {step_launches}")
        step_path = ("fet_window", "fet_lut_build", "css_dissim", "css_cmds",
                     "css_perm_chunk")
        check(all(step_launches[k] > 0 for k in step_path),
              f"the sharded step did not launch every kernel: {step_launches}")
        launches["fet_window"] = step_launches["fet_window"]
        launches["css_perm_chunk"] = step_launches["css_perm_chunk"]
        del gathered
        torch.cuda.empty_cache()
        timed_phase("14", phase_rank_kernels, torch, pair, (lo, npos, slot), dev, results,
                    k2_bench, card)
        del k2_bench

        # this slice's main path: run-all at the CLI default and exact
        for mod in (kfet, kcss, kperm):
            mod.reset_launches()
        pipeline_walls = timed_phase("15", phase_run_all, torch, dev, tmp, files)
        all_launches = {**kfet.LAUNCHES, **kcss.LAUNCHES, **kperm.LAUNCHES}
        say(f"[run-all main path] kernel launches: {all_launches}")
        check(all(all_launches[k] > 0 for k in FET_PATH + CSS_CMDS_PATH),
              f"run-all did not launch every kernel of its path: {all_launches}")
        for k in ("fet_lut_rank", "fet_snp_ranks", "fet_aggregate_ranks"):
            launches[k] = all_launches[k]
        results["run_all_walls_s"] = pipeline_walls
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    for name in REPLACES:
        r = results[name]
        f_abs, f_rel, f_ms, f_pms = r["fast"]
        b_ms, b_by = r["bound"]
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": f_abs, "ms": f_ms, "plain_ms": f_pms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": r.get("library_ms"),
            # windows (elements, for the per-SNP and M kernels) differing from
            # the plain version; the checks hold the rest to 0
            "windows_differ": r.get("differ", 0),
        }
        if "exact" in r:
            e_abs, e_rel, e_ms, e_pms = r["exact"]
            entry.update({
                "max_abs_err": max(f_abs, e_abs),
                "ms_exact": e_ms, "plain_ms_exact": e_pms,
                "max_rel_err_fast": f_rel, "max_rel_err_exact": e_rel,
            })
        if name == "fet_aggregate":
            entry["stddev_windows_beyond_tol"] = {
                "fast": r["fast_beyond"], "exact": r["exact_beyond"]
            }
            entry["windows_differ"] = entry["stddev_windows_beyond_tol"]
        if name == "css_cmds":
            entry["windows_excluded_eigengap"] = r["exact_excluded"]
        if name == "css_mc_coeff":
            entry["ms_threefry"], entry["plain_ms_threefry"] = r["threefry"][2], r["threefry"][3]
        if name == "css_mc_shared":
            # ms / plain_ms: the whole MC (coefficients, product, scan and
            # the range syncs) on the 16x worst case, host wall; then the
            # product's launches alone and the 10 k workload
            for tag in ("16x", "10k"):
                c = r[tag]
                entry.update({
                    f"kernel_ms_{tag}": c["kernel_ms"], f"scan_ms_{tag}": c["scan_ms"],
                    f"coeff_ms_{tag}": c["coeff_ms"],
                    f"perms_computed_{tag}": c["perms_computed"],
                    f"perms_consumed_{tag}": c["perms_consumed"],
                    f"ranges_{tag}": len(c["ranges"]),
                })
            c = r["10k"]
            entry.update({"ms_10k": c["fast"][2], "plain_ms_10k": c["fast"][3],
                          "bound_ms_10k": c["bound"][0], "library_ms_10k": c["library_ms"],
                          "windows_differ_10k": c["differ"]})
        if name == "css_smacof":
            # ms / plain_ms: mode 1 at 19,997 windows; then mode 2, the
            # drosophila chromosome (m = 2) and the ~800 k bench windows
            for tag in ("mds2_fast", "mds2_exact", "drosophila_fast", "drosophila_exact"):
                entry[f"ms_{tag}"], entry[f"plain_ms_{tag}"] = r[tag][2], r[tag][3]
                entry["max_abs_err"] = max(entry["max_abs_err"], r[tag][0])
            entry["ms_bench_800k_fast"] = r["bench_fast_ms"]
        if name == "css_mc_window":
            # ms / plain_ms: float32 mix on the 997 windows of the 10 k
            # workload to the 200 k cap; then threefry, the float64 form and
            # the 16x worst case (K7 on the same windows beside it)
            for form in ("threefry", "native"):
                entry[f"ms_{form}"], entry[f"plain_ms_{form}"] = r[form][2], r[form][3]
                entry[f"bound_ms_{form}"], entry[f"bound_by_{form}"] = r[f"bound_{form}"]
                entry["max_abs_err"] = max(entry["max_abs_err"], r[form][0])
            entry["ms_worst_case_16x"] = r["worst_ms"]
            entry["k7_ms_worst_case_16x"] = r["worst_k7_ms"]
        if name == "fet_window":
            # ms / plain_ms: 19,997 windows of the 200 k workload; then the
            # ~800 k bench windows, bit-equal to phase 2's K1 -> K2
            entry["ms_bench_800k"] = r["bench_ms"]
            entry["bit_equal_k1_k2_800k"] = r["bit_equal"]
        if name == "css_perm_chunk":
            # ms / plain_ms: mix draws; then threefry, on the same windows
            entry["ms_threefry"], entry["plain_ms_threefry"] = r["threefry"][2], r["threefry"][3]
            entry["bound_ms_threefry"], entry["bound_by_threefry"] = r["bound_threefry"]
            entry["k8_first_chunk_windows_stopped"] = r["k8_stopped"]
        if name in FET_PATH + CSS_CMDS_PATH:
            entry["launches_run_all"] = all_launches[name]
        if name == "fet_lut_rank":
            # ms / plain_ms: 11 + 10 (one counting pass); then the largest
            # symmetric panel with a LUT (runs and merge passes)
            for prec in ("fast", "exact"):
                G, ms, pms = r[f"big_{prec}"]
                entry[f"ms_{RANK_BIG_PANEL}_{RANK_BIG_PANEL}_{prec}"] = ms
                entry[f"plain_ms_{RANK_BIG_PANEL}_{RANK_BIG_PANEL}_{prec}"] = pms
            entry["entries_big"] = r["big_fast"][0]
        if name == "fet_snp_ranks":
            entry["ms_includes"] = "K1's LUT build, the LUT sort and the per-SNP lookup"
        if name == "fet_aggregate_ranks":
            entry["stddev_windows_beyond_tol"] = {
                "fast": r["fast_beyond"], "exact": r["exact_beyond"]
            }
            entry["windows_differ"] = entry["stddev_windows_beyond_tol"]
            entry["equal_k1_k2_800k"] = r["equal_k1_k2_800k"]
            entry["run_fet_exact_wall_s"] = r["run_fet_exact_s"]
            entry["run_all_walls_s"] = results["run_all_walls_s"]
        if name == "css_mc_power":
            # ms / plain_ms: the shared stream on 19,997 windows x 1,024
            # permutations (the wrapper: coefficients, product, tile sum);
            # then its launches alone, the window stream and the ~800 k
            # bench windows
            entry["kernel_ms"], entry["coeff_ms"] = r["kernel_ms"], r["coeff_ms"]
            entry["ms_window"], entry["plain_ms_window"] = r["window"][2], r["window"][3]
            entry["bound_ms_window"], entry["bound_by_window"] = r["bound_window"]
            entry["max_rel_err_power_sums"] = max(f_rel, r["window"][1])
            entry["max_abs_err"] = max(f_abs, r["window"][0])
            entry["ms_bench_800k"] = r["bench_ms"]
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
