#!/usr/bin/env python3
"""Smoke run of ``divergence_tpu_torch`` — the FET scan (``run-fet``), the
CSS scan (``run-css``), the sharded divergence step, the whole pipeline
(``run-all``), and the ingestion path (``convert-vcf``, the native GTrack
parse) with ``doctor`` and ``bench-mc`` on one CUDA GPU, at the JAX
package's bench scale.

Usage, from the repository root, on a machine with one CUDA GPU::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card (``nvidia-smi`` name and power limit) and the nvcc build of
   ``divergence_tpu_torch/csrc``, with the registers, stack and spills of
   K11's buckets and K6's two forms, and beside it the g++ build of the
   native host library (``divergence_tpu_torch/native``);
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
   per-window counts), on a 500 k-SNP stickleback panel (against the
   prefix) and on windows of 0 to 4,096 SNPs starting at lo % 32 in {0, 1,
   31}, exact integer equality; ``css_cmds`` on the ~800 k windows'
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
   alone, mode 1 fast, on the ~800 k bench windows; K6's bound counts the
   transforms of every restart (the kernel's ``transforms`` output);
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
   (and approx p against the plain approx; two calls bit-equal; the median
   of 5 calls), the window stream bit-equal to its sum order mirrored in
   torch (``window_power_order``) and its launches alone (the kernels
   line's ``css_mc_power_window`` row, with its own launch count), K9
   alone on the ~800 k bench windows;
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
   200 k-SNP workload, K10's block and wide bodies on synthetic windows at
   P = 256 and 4,096, K3's gather form ``css_dissim_gathered`` on those windows, K11
   again on a 200 k-SNP stickleback-shaped panel (whose null is hit) and
   against K8's first chunk there, K10 on the ~800 k bench windows gathered
   at P = 128, against its plain version and bit-equal to phase 2's K1 ->
   K2, K3's gather form there against its plain twin with the
   ``torch.bmm`` yardstick, and K11 at the step's size (those windows x 128
   permutations, both draw streams) against its plain version on every
   window, timed alone;
13. the sharded step (``make_divergence_step(11, 10)`` at its defaults) on
   those ~800 k windows: warm wall and a torch.profiler call (K5's, K11's,
   K10's and K3's time by CUDA events around their launches, and no
   concatenation of the codes on the card), four shares
   of the card against one (bit-equal), the all-plain step on 20,000 of
   them; ``bench-scaling`` at its defaults; ``run-fet`` and ``run-css``
   with ``--shard`` and with ``--num-hosts 2`` + ``merge-tracks`` on phase
   9's small files, byte-equal to the unsharded tracks, and ``run-fet``
   fast with ``--num-hosts 2`` + ``merge-tracks`` on a 40 + 40 panel (off
   the LUT), byte-equal to the one-host track;
14. K1r (``fet_lut_rank``, ``fet_snp_ranks``) and K2r
   (``fet_aggregate_ranks``) on the bench FET workload in both precisions:
   the LUT sort against its plain version, exactly, at 11+10, 15+15, 20+20
   and 38+38 (the largest symmetric panel with a LUT, 2.3 M entries),
   timed beside ``torch.sort(lut + 0.0, stable=True)`` alone; the ranks of 8 M SNPs; K2r on the ~800 k windows
   against its plain version and equal to
   phase 2's K1 -> K2 on every window, timed beside K2; ``run_fet`` exact
   by the old route (K1 -> K2) and the rank route, warm walls in turns;
15. ``run-all`` on phase 3's 500 k-SNP pair at the CLI default (fast) and
   at ``--precision exact`` (tracks byte-equal to phases 3 and 6's staged
   runs; walls and the stage split of ``*_summary.json``), on phase 9's
   small files against the staged subcommands (byte-equal), and with
   ``--num-hosts 2`` (no regions; merged shards = the one-host tracks);
16. the large panels (70 + 58 and 110 + 90, BASELINE.md's envelope):
   (a) the large-panel kernels against their plain versions, both
   precisions — K3's tile form (``css_dissim_tiles``) and K7's
   coefficients (``css_mc_coeff_block``, 16 chunks, both draw streams)
   on the 19,997 windows of the 200 k-SNP workload (K3 beside one
   ``torch.bmm`` of the windows' one-hots), K5's block form
   (``css_cmds_block``) timed on them and, beside its plain version, on
   the first LARGE_PLAIN_WINDOWS (cuSOLVER's ``torch.linalg.eigh``, timed
   on the same centred matrices, is the plain version's solver), K6's
   block form (``css_smacof_block``, modes 1 and 2) on the 997 windows of
   the 10 k workload (its exact plain version on the first
   LARGE_SMACOF_PLAIN), K5's and K6's times printed beside their times
   before the Householder step's and the fused pass's redesign
   (OLD_BLOCK_MS); K3, K5 and K7 at 150 + 150 on 300 windows (the
   device-memory slabs); K7's coefficients bit-equal at COEFF_CASES
   (m = 65, 300, 909; one chunk and 16, ragged and whole); every kernel
   on both sides of each shared-memory switch the main path crosses up
   to m = 300; (b) their main path: ``run_css`` at its
   defaults with 20,000 permutations in both precisions at both sizes
   (warm wall, windows/s, MC permutations/s, the MC's ranges), with
   ``rng="threefry"``, and with
   ``mds=SMACOF`` / ``CMDS_SMACOF`` at 70 + 58, ``run_css`` on the card
   against the CPU at 70 + 58, and ``run-css`` and ``run-all`` on a
   20 k-SNP / 1 Mbp GTrack pair at 110 + 90, both precisions, run-all's
   tracks equal to run-css's and to the library's;
17. the MC past m = 64 and FET windows of any width: (a) K8's large-panel
   form (``css_mc_window_block``) in float32 mix, threefry and the float64
   native form on the 997-window envelope cell at 70 + 58 and 110 + 90 to
   20,000 permutations (the range loop's launches by CUDA events) and at
   150 + 150 on 300 windows, held to the plain loop on a depth cut; (b)
   K11's (``css_perm_chunk_block``) and K9's (``css_mc_power_window_block``
   and the shared stream) on the 19,997 windows of the 200 k-SNP workload
   against their plain versions, then the sharded step at both sizes
   against plain=True; (c) run_css at 110 + 90 with the window stream,
   threefry, native and approx mode (warm walls, the card against the
   CPU), ``run-css --mc-stream window`` on phase 16's GTrack pair; (d) the
   bench FET workload at 250 kb, 1 Mb and 2 Mb windows: K1 -> K2 and K1r ->
   K2r (``fet_aggregate_wide``, ``fet_aggregate_ranks_wide`` past what a
   block's shared memory holds) against their plain versions and K2r = K2
   bit for bit, K10 at P = 8,192 and 65,536 (``fet_window_wide``) equal to
   K1 -> K2, each wide row's bound beside its reckoning before the wide
   body stopped sorting (old_reckoning), the wide body's edge cases (a
   tie-heavy cell, every band in device scratch, 37 samples, perc 0.5 and
   0.999, windows of 1 to 40 SNPs; K2r = K2 byte for byte), ``run_fet``
   at each width, and the step on 1 Mb windows;
   (e) K8's large-panel body (mix, fast) over m = 65, 96, 128, 174, 200
   and 300 and both sides of its shared / split switch on the envelope
   cell's windows at a split of 11 : 9, to a depth cut, in the form the
   kernel library picks there, its time per permutation against m^2 and
   a*b.  Each line of (a) and (b) prints ns a permutation, the ratio to
   the bound and the time of the body before the sort and the nonzero
   walk for the same cell (OLD_BODY_MS);
18. the ingestion path and the remaining tools: (a) a VCF of phase 3's
   500 k-SNP chromosome (21 sample columns, ``tools/synth.py:write_vcf``);
   (b) ``convert-vcf`` per population (the native converter, timed),
   byte-equal to the Python ``_convert_stream`` on its first 20,000 SNPs,
   then ``run-fet`` on the converted pair, its score lines byte-equal to
   phase 3's; (c) ``read_gtrack_points`` on phase 3's files by the native
   parser (each, both at once) and by the Python reader on one, s per
   10 M rows, the native path asserted taken; (d) phase 15's ``run-all``
   walls and stage split beside those the Python parse gave; (e) ``doctor`` in
   a subprocess (the card, ``nvcc``, the built kernel library, the native
   parser); (f) ``bench-mc`` at its defaults with ``inloop``,
   ``inloop_threefry``, ``inloop_shared``, ``native`` and ``xla``, then
   on a 64-window cut, checksums equal to the plain versions'; (g)
   ``convert-snp-table`` on a small table.

Kernel launch counts are reset before phase 3 and read after phase 4 (the
FET path), reset before phase 6 and read after phase 7 (the CMDS CSS
path), reset before phase 9 and read after it (the SMACOF and drosophila
CSS path), reset before phase 11 and read after it (K8, K9 and K7 under
threefry), reset before phase 13 and read after it (the sharded step:
K10, K3's gather form, K5, K11), reset before phase 15 and read after it
(run-all: K1, K2, K1r, K2r, K3, K5, K7), reset before phase 16b and
read after it (the large-panel kernels, K7's product and scan), and
reset before phase 17's main path (17b's step, 17c, 17d's run_fet and
step) and read after it (the large-panel MC and wide FET kernels), and
reset before phase 18's ``run-fet`` on the converted pair and read after
its ``bench-mc`` at the defaults (K1, K2, K7, K8, K11).  The
last three lines are a JSON line of per-kernel results (with each
kernel's ``bound_ms``: the larger of its bytes over 3.35 TB/s and its
operations over 67 TFLOP/s float32 / 34 TFLOP/s float64, from this run's
inputs — K2's, K2r's and K10's count the threefry hashes and pows these
windows' bootstraps need; and ``library_ms``, one PyTorch call computing
the same product where one exists), the card's name and power limit, and
``{"ok": true, "device": {...}}``.

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
measured on the CPU); past m = 64 (phase 17) the window stream within
1e-12 and the shared stream within large_power_band(m) of the plain
version's sums, each sum's error against its magnitude (power_err).  K10: as K2 (its block body too), and bit-equal to K1 -> K2 on the
bench windows.  K1r: the sorted LUT and its ranks equal to the plain version's,
bit for bit; the 8 M SNPs' ranks those of the kernel's own LUT, their
scores within the FET tolerances of the plain version's.  K2r: as K2, and
equal to K1 -> K2 on every bench window (-0.0 == 0.0).  K11: (hits,
reached, pos) identical on every window.  The step:
per-window outputs bit-equal across 1 and 4 shares; against its all-plain
version FET exact 1e-12, CSS 1e-9 on the eigengap windows, hits equal on
99.9 % of windows.  The large panels (phase 16): as above; K6's fast
band at m = 128 and 200 is the JAX package's own float32-vs-float64 band
measured at that m in that mode (LARGE_SMACOF_BAND), SMACOF_FAST_BAND
at the switch points, where none was measured; run_css on the card against the CPU:
scores at the CSS tolerances, p equal on 99.9 % of windows, each
differing window a near tie; run-all's tracks equal to the library's
bit for bit.
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
OFF_LUT_PANEL = (40, 40)         # phase 13's slot-range merge off the LUT
# phase 18: the Python converter's share of the byte check, bench-mc's
# variants and its cut against the plain versions, and run-all's walls
# with the Python GTrack reader (this script on an H100 80GB HBM3 at 700 W,
# before the native parser)
INGEST_PY_SNPS = 20_000
INGEST_MC_BACKENDS = ("inloop", "inloop_threefry", "inloop_shared", "native", "xla")
INGEST_MC_CUT = 64
RUN_ALL_PYTHON_PARSE_S = {"fast": 18.9, "exact": 19.8}
# the FET fast path of run-fet and bench-mc's kernels (K7, K8, K11)
INGEST_PATH = ("fet_lut_build", "fet_snp_logs", "fet_aggregate", "css_mc_coeff",
               "css_mc_shared", "css_mc_scan", "css_mc_window", "css_perm_chunk")
# convert-snp-table's rows on phase 18's table (tests/test_cli.py)
SNP_TABLE_ROWS = ["chrI\t100\t3\tfish0", "chrI\t100\t0\tfish1", "chrI\t100\t-3\tfish2",
                  "chrI\t200\t3\tfish0", "chrI\t200\t-10000\tfish1", "chrI\t200\t0\tfish2"]
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
# phase 11's card-vs-CPU comparison: three chromosomes at MULTI_SNPS's
# density on 100 kbp each (591 windows; 1,491 on MULTI_REGION took ~45 s of
# host time, the window stream's plain MC on the CPU)
WINDOW_MULTI_SNPS, WINDOW_MULTI_REGION = 2_000, 100_000
TIE_RTOL = 1e-5                  # float32 near tie (tests/test_torch_mc.py)
TIE_RTOL_F64 = 1e-12             # float64 near tie (the native form)
# approx mode (tests/test_torch_approx.py, measured on the CPU): power sums
# relative to the plain version, and |log10 p| where nscores agree
POWER_RTOL, LOG10_P_BAND, NSCORES_SAME_SHARE = 1e-6, 2e-5, 0.999   # m <= 21
# the card's published peaks (NVIDIA's H100 SXM data sheet, dense, at
# 700 W; float32 and float64 outside the tensor cores, a multiply-add two
# operations), and the instruction rates of operations that are not
# multiply-adds at the clock those peaks imply: per SM and clock, 128
# float32 lanes, 64 int32 and 64 float64 lanes (NVIDIA's Hopper
# whitepaper), so half the float32 peak, a quarter, and half the float64
# peak
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "f64": 34e12, "f32_op": 33.5e12, "i32": 16.75e12,
                  "f64_op": 17e12}
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
# phase 16, the large panels (BASELINE.md's envelope cells,
# baseline/exp_large_panel.py): 70 + 58 and 110 + 90 on the 200 k-SNP /
# 10 Mbp chromosome (K3, K5, K7's coefficients: 19,997 windows; K5's plain
# version, cuSOLVER's eigh at ~1.7 ms a matrix, on the first
# LARGE_PLAIN_WINDOWS) and the 10 k-SNP / 500 kbp one (K6 and run_css: 997
# windows, LARGE_MC_RUNS permutations); the device-memory paths at 150 +
# 150 on LARGE_DEVICE_WINDOWS windows; each kernel's shared-memory
# switches up to m = 300 on a small chromosome; run_css on the card against the CPU on a
# stickleback-shaped panel; the CLI on a 20 k-SNP / 1 Mbp GTrack pair
LARGE_PANELS = ((70, 58), (110, 90))
LARGE_KERNEL_WORKLOAD = (200_000, 10_000_000, 7)
LARGE_CSS_WORKLOAD = (10_000, 500_000, 11)
LARGE_SWITCH_WORKLOAD = (2_000, 100_000, 3)
LARGE_MC_RUNS = 20_000
# K5's plain version (cuSOLVER's eigh, ~1.7-4 ms a matrix) and its
# torch.linalg.eigh yardstick on the first LARGE_PLAIN_WINDOWS of the 19,997
# windows, K6's exact plain version on the first LARGE_SMACOF_PLAIN of the
# 997 (~1.5-5 ms a window over its restarts; its checks are per window;
# fast mode's band is a percentile over the cell, so it runs on all 997);
# the kernels on all
LARGE_PLAIN_WINDOWS, LARGE_SMACOF_PLAIN = 256, 128
# K5 and K6 large before the redesign of K5's Householder step and K6's
# fused pass (ms, PERF.md's kernel table: an H100 80GB HBM3 at 700 W,
# phase 16a of that tree), printed beside this run's and kept out of the
# kernels line: K5 on the 19,997 windows, K6 on the 997 of the envelope
# cell
OLD_BLOCK_MS = {("K5", "fast", 128): 67.6, ("K5", "exact", 128): 91.3,
                ("K5", "fast", 200): 144.9, ("K5", "exact", 200): 337.9,
                ("K6", 1, "fast", 128): 54.6, ("K6", 1, "exact", 128): 131.0,
                ("K6", 1, "fast", 200): 204.1, ("K6", 1, "exact", 200): 542.1,
                ("K6", 2, "fast", 128): 15.6, ("K6", 2, "exact", 128): 42.2,
                ("K6", 2, "fast", 200): 55.4, ("K6", 2, "exact", 200): 153.3}
LARGE_DEVICE_PANEL, LARGE_DEVICE_WINDOWS = (150, 150), 300
# K7's coefficients against their plain version past the timed cells
# (phase 16a): (m, chunks, chunk), ragged chunks of 100 and whole ones of
# 256, one chunk and a range of 16; at m = 909 M [826,281, 2,048] is 6.8 GB
COEFF_CASES = [(65, 1, 100), (65, 16, 256), (300, 1, 100), (300, 16, 256), (909, 1, 256),
               (909, 16, 100)]
LARGE_CPU_PANEL = (3_000, 150_000)
LARGE_CLI = (20_000, 1_000_000, 9)
# windows of phase 16's switch sweep for K3, K5 and K6 (cut from 64, 32
# and 16 to make room for phase 17: the gpu tests hold every switch on
# more windows)
SWITCH_WINDOWS = (16, 8, 4)
# (mode, m) -> the JAX package's own float32-vs-float64 maximum and 90th
# percentile of the SMACOF score at that panel size, rounded up in the
# second digit (tests/measure_smacof_band.py 128:300:256 200:200:256 and
# --mds 2 128:300 200:200, on the CPU: mode 1 3.157e-4 / 1.540e-5 and
# 1.039e-4 / 2.962e-7, mode 2 2.265e-3 / 1.141e-4 and 2.568e-3 /
# 6.127e-5); K6's fast mode is held to these at those m
LARGE_SMACOF_BAND = {(1, 128): (3.2e-4, 1.6e-5), (1, 200): (1.1e-4, 3.0e-7),
                     (2, 128): (2.3e-3, 1.2e-4), (2, 200): (2.6e-3, 6.2e-5)}
# phase 17, the MC past m = 64 and wide FET windows: K8's large-panel
# form on the envelope cell (LARGE_CSS_WORKLOAD) to LARGE_MC_RUNS, held to
# the plain loop on its first LARGE_MC_PLAIN windows to a shorter cap
# (the plain score is m^2 torch launches a chunk), and at 150 + 150 on
# LARGE_DEVICE_WINDOWS windows (LARGE_MC_PLAIN_300); K11 and K9's window
# stream on the 19,997 windows of LARGE_KERNEL_WORKLOAD, their plain
# versions on the first LARGE_CHUNK_PLAIN / LARGE_POWER_PLAIN of them;
# the step against plain=True on LARGE_STEP_PLAIN windows; run_css with
# the MC options card vs CPU on WINDOW_CPU_PANEL (the window stream's
# plain loop on the host); the bench FET workload at WIDE_FET's widths,
# each plain FET call ~2 / 8 / 17 s there (its Renyi steps grow with P),
# so each is made once: K2 in both precisions at 250 kb, exact at 1 Mb
# (fast there too before the wide body's edge cases were added) and fast
# at 2 Mb; K2r's plain version timed at 250 kb and 2 Mb (K2r = K2 bit
# for bit at every width); K10 at 250 kb in both precisions and, exact, at
# 2 Mb (every one of these on the wide body, past P = 256)
FORMS_17 = [("mix", "mix", "xla"), ("threefry", "threefry", "xla"),
            ("native", "mix", "native")]
LARGE_MC_PLAIN, LARGE_MC_PLAIN_300 = (16, 2_048), (8, 1_024)
LARGE_STEP_PLAIN, LARGE_CHUNK_PLAIN, LARGE_POWER_PLAIN = 512, 256, 64
# The times of phase 17's cells on the large-panel body before it ranked
# by a sort and walked only the nonzero terms (m^2 rank compares, every
# column scored; ms, PERF.md's kernel table, an H100 80GB HBM3 at 700 W),
# printed beside this run's: K8 large's
# launches on the envelope cell to LARGE_MC_RUNS (m = 300: 150 + 150 on
# 300 windows), K11 and K9's window stream on the 19,997 windows
OLD_BODY_MS = {("K8", "mix", 128): 443.5, ("K8", "threefry", 128): 452.1,
           ("K8", "native", 128): 320.3, ("K8", "mix", 200): 1628.1,
           ("K8", "threefry", 200): 1647.4, ("K8", "native", 200): 1089.4,
           ("K8", "mix", 300): 1741.1, ("K11", "mix", 128): 78.2,
           ("K11", "threefry", 128): 79.3, ("K11", "mix", 200): 257.2,
           ("K11", "threefry", 200): 260.2, ("K9", "window", 128): 478.1,
           ("K9", "window", 200): 1937.4}
# phase 17e, K8's large-panel body over m at the envelope's 11 : 9 split,
# on LARGE_CSS_WORKLOAD's windows to LARGE_MC_PLAIN's depth; the plain
# loop on LARGE_MC_PLAIN's cut where phase 17a has no cell.  174: the last
# m at which the shared form held 8 warps on an H100 before it needed 16
LARGE_SWEEP_M = (65, 96, 128, 174, 200, 300)
# approx mode past m = 64: |log10 p| card vs CPU (tests/
# test_torch_large_panels_mc.py, measured on the CPU at m = 128 and 200)
LARGE_LOG10_P_BAND = 1e-2


def large_power_band(m: int) -> float:
    """K9's shared stream past m = 64 against its plain version, by
    power_err: m u (u = 2^-24).  The kernel adds a score's m^2 products
    one after another in one float32 register (tile_gemm), the plain
    version's matmul in blocks, so the kernel's sums drift like m
    roundings of a score; measured 0.36-0.90 m u at m = 21 to 300, the
    plain version's 0.12 m u or less (tests/measure_large_forms.py and
    this script's 19,997 windows)."""
    return m * 2.0 ** -24


def power_err(kp, pp, n: int) -> float:
    """Largest |kp - pp| of [chunks, 3, B] power sums of n scores against
    n rms^q (rms^2 = pp[:, 1] / n): each sum's error against its
    magnitude, which a sum near zero cannot inflate."""
    import torch

    rms = (pp[:, 1:2] / n).sqrt()
    q = torch.arange(1, 4, device=pp.device, dtype=pp.dtype)[None, :, None]
    return float(((kp - pp).abs() / (n * rms ** q)).max())
LIBRARY_17 = [("window", {"mc_stream": "window"}),
              ("window threefry", {"mc_stream": "window", "rng": "threefry"}),
              ("native", {"perm_backend": "native"}),
              ("approx shared", {"p_mode": "approx"}),
              ("approx window", {"p_mode": "approx", "mc_stream": "window"})]
WINDOW_CPU_PANEL = (60, 3_000)
WIDE_FET = ((250_000, 50_000), (1_000_000, 200_000), (2_000_000, 400_000))
WIDE_K10_WINDOWS, WIDE_STEP_WINDOWS = 1_000, 64
# depth cuts of phase 17d's plain versions (the plain bootstrap's cost is
# its Renyi steps times the windows it carries): K2 and K2r against their
# plain versions on the first WIDE_PLAIN_WINDOWS windows of each width,
# K10 on the first WIDE_K10_PLAIN of its windows (the kernels on all)
WIDE_PLAIN_WINDOWS, WIDE_K10_PLAIN = 128, 16
# the wide body's edge cases (phase 17d): a few windows at P = 4,096 (the
# plain bootstrap walks n / 2 steps one at a time at perc 0.5: at P =
# 16,384 the phase took 123 s)
WIDE_EDGE_P, WIDE_EDGE_WINDOWS = 4_096, 6
# the (precision, index into WIDE_FET) cases each plain version runs on
WIDE_PLAIN = {"fet_aggregate": {("fast", 0), ("exact", 0), ("exact", 1), ("fast", 2)},
              "fet_aggregate_ranks": {("exact", 0), ("exact", 2)}}
REPLACES = {
    "fet_lut_build": "divergence_tpu/kernels/fet.py:372",
    "fet_snp_logs": "divergence_tpu/kernels/fet.py:318",
    "fet_aggregate": "divergence_tpu/kernels/fet.py:630",
    "css_dissim": "divergence_tpu/kernels/css.py:55",
    "css_dissim_gathered": "divergence_tpu/kernels/css.py:34",
    "css_cmds": "divergence_tpu/kernels/css.py:478",
    "css_smacof": "divergence_tpu/kernels/css.py:225",
    "css_mc_coeff": "divergence_tpu/kernels/perm.py:249",
    "css_mc_shared": "divergence_tpu/kernels/perm.py:281",
    "css_mc_scan": "divergence_tpu/kernels/perm.py:362",
    "css_mc_window": "divergence_tpu/kernels/perm.py:164",
    "css_mc_power": "divergence_tpu/kernels/perm.py:599",
    "css_mc_power_window": "divergence_tpu/kernels/perm.py:599",
    "fet_window": "divergence_tpu/kernels/fet.py:668",
    "css_perm_chunk": "divergence_tpu/kernels/perm.py:396",
    "fet_lut_rank": "divergence_tpu/kernels/fet.py:454",
    "fet_snp_ranks": "divergence_tpu/kernels/fet.py:454",
    "fet_aggregate_ranks": "divergence_tpu/kernels/fet.py:495",
    "css_dissim_tiles": "divergence_tpu/kernels/css.py:55",
    "css_cmds_block": "divergence_tpu/kernels/linalg.py:247",
    "css_smacof_block": "divergence_tpu/kernels/css.py:225",
    "css_mc_coeff_block": "divergence_tpu/kernels/perm.py:249",
    "css_mc_window_block": "divergence_tpu/kernels/perm.py:164",
    "css_mc_power_window_block": "divergence_tpu/kernels/perm.py:599",
    "css_perm_chunk_block": "divergence_tpu/kernels/perm.py:396",
    "fet_aggregate_wide": "divergence_tpu/kernels/fet.py:630",
    "fet_aggregate_ranks_wide": "divergence_tpu/kernels/fet.py:495",
    "fet_window_wide": "divergence_tpu/kernels/fet.py:668",
}
SOURCES = {
    "fet_lut_build": "divergence_tpu_torch/csrc/fet_snp.cu",
    "fet_snp_logs": "divergence_tpu_torch/csrc/fet_snp.cu",
    "fet_aggregate": "divergence_tpu_torch/csrc/fet_aggregate.cu",
    "css_dissim": "divergence_tpu_torch/csrc/css_dissim.cu",
    "css_dissim_gathered": "divergence_tpu_torch/csrc/css_dissim.cu",
    "css_cmds": "divergence_tpu_torch/csrc/css_cmds.cu",
    "css_smacof": "divergence_tpu_torch/csrc/css_smacof.cu",
    "css_mc_coeff": "divergence_tpu_torch/csrc/css_mc.cu",
    "css_mc_shared": "divergence_tpu_torch/csrc/css_mc.cu",
    "css_mc_scan": "divergence_tpu_torch/csrc/css_mc.cu",
    "css_mc_window": "divergence_tpu_torch/csrc/css_mc_window.cu",
    "css_mc_power": "divergence_tpu_torch/csrc/css_mc_power.cu",
    "css_mc_power_window": "divergence_tpu_torch/csrc/css_mc_window.cu",
    "fet_window": "divergence_tpu_torch/csrc/fet_window.cu",
    "css_perm_chunk": "divergence_tpu_torch/csrc/css_mc_window.cu",
    "fet_lut_rank": "divergence_tpu_torch/csrc/fet_rank.cu",
    "fet_snp_ranks": "divergence_tpu_torch/csrc/fet_rank.cu",
    "fet_aggregate_ranks": "divergence_tpu_torch/csrc/fet_aggregate_ranks.cu",
    "css_dissim_tiles": "divergence_tpu_torch/csrc/css_dissim.cu",
    "css_cmds_block": "divergence_tpu_torch/csrc/css_cmds.cu",
    "css_smacof_block": "divergence_tpu_torch/csrc/css_smacof.cu",
    "css_mc_coeff_block": "divergence_tpu_torch/csrc/css_mc.cu",
    "css_mc_window_block": "divergence_tpu_torch/csrc/css_mc_window.cu",
    "css_mc_power_window_block": "divergence_tpu_torch/csrc/css_mc_power.cu",
    "css_perm_chunk_block": "divergence_tpu_torch/csrc/css_mc_window.cu",
    "fet_aggregate_wide": "divergence_tpu_torch/csrc/fet_aggregate.cu",
    "fet_aggregate_ranks_wide": "divergence_tpu_torch/csrc/fet_aggregate_ranks.cu",
    "fet_window_wide": "divergence_tpu_torch/csrc/fet_window.cu",
}
# the large-panel path (phase 16b): these launch there, with K7's product
# and scan
LARGE_PATH = ("css_dissim_tiles", "css_cmds_block", "css_smacof_block", "css_mc_coeff_block",
              "css_mc_shared", "css_mc_scan")
# phase 17's main path (the step, run_css's MC options, run_fet and the
# step on wide windows): these launch there
WIDE_PATH = ("css_mc_window_block", "css_mc_power_window_block", "css_perm_chunk_block",
             "fet_aggregate_wide", "fet_aggregate_ranks_wide", "fet_window_wide")
# K1r's LUT sort at these panels (G = 17,424; 65,536; 194,481; 2,313,441),
# the last the largest symmetric panel where the LUT is on (39 + 39 fails
# lut_active's 1e8 bound)
RANK_PANELS = ((11, 10), (15, 15), (20, 20), (38, 38))
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
    peak rate of their type (``ops``: {"f32": n, "f64": n} in the data
    sheet's operations, a multiply-add two; "f32_op", "i32", "f64_op":
    single operations that are not multiply-adds, at their instruction
    rate; elsewhere integer operations are counted at the float32 rate, an
    underestimate of their time)."""
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


def median_ms(torch, fn, reps: int, queued: bool = False) -> float:
    """Median device time of ``fn`` over ``reps`` warm calls, each between
    its own two CUDA events; ``queued``: each enqueued behind a busy kernel
    (``torch.cuda._sleep``), so that the host's time to enqueue its
    launches does not show."""
    import statistics

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` warm calls (CUDA events),
    enqueued behind a busy kernel (``torch.cuda._sleep``) so that the
    card runs them back to back, as the main path's range loop queues K7's
    coefficients behind the last range's product: a short kernel's
    wrapper time on the host does not show."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
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


def ptxas_summary(log: str, names: tuple) -> dict:
    """{kernel<template argument>: (registers, stack bytes, spill store
    bytes, spill load bytes)} of the kernels of ``-Xptxas -v``'s log whose
    mangled entry name holds one of ``names``."""
    import re

    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"(" + "|".join(names) + r")I(?:Li(\d+)E|([fd]))E", m.group(1))
            entry = None if t is None else (
                f"{t.group(1)}<{t.group(2) or {'f': 'float', 'd': 'double'}[t.group(3)]}>")
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            out[entry] = [None, *map(int, m.groups())]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in out:
            out[entry][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def phase_build(kfet_build, results) -> None:
    """The kernel library (nvcc, one process a source) and, beside it on a
    thread, the native host library (g++: the GTrack parser and the VCF
    converter)."""
    import threading

    from divergence_tpu_torch import native

    host = {}

    def build_host():
        t0 = time.perf_counter()
        host["ok"] = native.native_available()
        host["s"] = time.perf_counter() - t0

    th = threading.Thread(target=build_host)
    th.start()
    info = kfet_build.build()
    th.join()
    say(f"[build] nvcc {info.seconds:.2f} s -> {info.path.name}")
    say(f"[build] g++ host library {host['s']:.2f} s -> "
        f"{native.library_path().name if host['ok'] else native.build_error()}")
    check(host["ok"], f"the native host library did not build: {native.build_error()}")
    for line in info.log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            say("[build]", line.strip())
    # K11's buckets (perm_chunk<MB>) and K6's two forms (css_smacof<T>)
    for name, key in (("css_perm_chunk", "perm_chunk"), ("css_smacof", "css_smacof")):
        summary = ptxas_summary(info.log, (key,))
        check(bool(summary), f"the build log shows no {key} kernel")
        for entry, (regs, stack, st, ld) in summary.items():
            say(f"[build] {name} {entry}: {regs} registers, {stack} bytes stack, "
                f"spills {st} / {ld} bytes")
        results[name]["ptxas"] = {e: list(v) for e, v in summary.items()}


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
    # the kernels are timed with their descriptors on the card, as the
    # engines hand them over (an upload from the host is not kernel time)
    lo_d, npos_d, slot_d = (t.to(dev) for t in plan_ids)
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
        agg = lambda: kfet.fet_aggregate(ks, lo_d, npos_d, slot_d, key, 0.95, 100)  # noqa: E731
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
        # logs and descriptors in, 2 values out; the bootstrap's hashes,
        # pows and compares (bootstrap_ops)
        size = ks.element_size()
        results["fet_aggregate"]["bound" if fast else "bound_exact"] = bound(
            ks.numel() * size + B * 3 * 8 + B * 2 * size,
            bootstrap_ops(npos, 0.95, 100, fast))


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
    from divergence_tpu_torch.kernels.linalg import INVERSE_ITERS
    from divergence_tpu_torch.tools.synth import make_chromosome, make_panel

    vals = pair.to_device(dev)
    lo, npos, _ = plan_ids
    lo_d, npos_d = lo.to(dev), npos.to(dev)
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
        ms = cuda_ms(torch, lambda: kcss.css_dissim(vals, lo_d, npos_d, dt), 5)
        pms = cuda_ms(torch, lambda: kcss.dissimilarity_plain(vals, lo, npos).to(dt), 1)
        ms_p = cuda_ms(torch, lambda: kcss.css_dissim(p_vals, p_lo.to(dev), p_npos.to(dev), dt),
                       5)
        pms_p = cuda_ms(torch, lambda: kcss.dissimilarity_plain(p_vals, p_lo, p_npos).to(dt), 1)
        say(f"[K3 css_dissim {prec}] bench B={lo.numel()} windows vs the counts "
            f"twin, panel B={p_lo.numel()} vs the prefix twin: max_abs_diff={diff} "
            f"(exact counts); kernel {ms:.4f} ms plain {pms:.4f} ms; panel kernel "
            f"{ms_p:.4f} ms plain {pms_p:.4f} ms")
        check(diff == 0.0, f"css_dissim {prec}: counts differ by {diff}")
        results["css_dissim"][prec] = (diff, diff, ms, pms)
        # codes in once, m x m counts out in the precision's dtype (8 bytes
        # exact); the pair popcounts (two ANDs, two popcounts and two adds
        # a pair and 32-SNP word) are integer operations
        m = ASIZE + BSIZE
        words = int(((npos + 31) // 32).sum())
        results["css_dissim"]["bound" if prec == "fast" else "bound_exact"] = bound(
            vals.numel() * 2 + lo.numel() * (16 + m * m * k.element_size()),
            {"f32": 6 * words * m * (m - 1) // 2})
        del kp
    del p_plain, p_vals

    # K3 at the funnel shift's edges: windows starting at lo % 32 in
    # {0, 1, 31} of 0 to 4,096 SNPs, the longest ending on the last SNP
    edge_rs = np.random.default_rng(5)
    for shift in (0, 1, 31):
        ev = torch.from_numpy(edge_rs.choice(np.array([3, -3, 0, -10000], np.int16),
                                             size=(4096 + 64 + shift, ASIZE + BSIZE)))
        e_lo = torch.tensor([96 * i + shift for i in range(6)] + [64 + shift])
        e_n = torch.tensor([0, 1, 31, 32, 33, 87, 4096])
        want = kcss.dissimilarity_plain(ev, e_lo, e_n)
        for dt in (torch.float32, torch.float64):
            got = kcss.css_dissim(ev.to(dev), e_lo, e_n, dt)
            check(torch.equal(got.double().cpu(), want),
                  f"css_dissim at lo % 32 == {shift}: counts differ")
    say("[K3 css_dissim edges] windows of 0, 1, 31, 32, 33, 87, 4096 SNPs at lo % 32 in "
        "{0, 1, 31}: counts equal to the plain twin in both precisions")

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
        # the eigensolver's multisection steps, and the library yardstick:
        # torch.linalg.eigh on the same centred matrices, the eigen step
        # alone (cuSOLVER, in the plain version's batches)
        steps = torch.zeros(dis.shape[0], dtype=torch.int32, device=dev)
        kcss.css_cmds(dis, npos_d, ASIZE, BSIZE, steps=steps)
        centred = kcss.double_centre(kcss.fill_averages(dis)[0])
        lib = cuda_ms(torch, lambda: [torch.linalg.eigh(centred[i:i + kcss._CMDS_BATCH])
                                      for i in range(0, centred.shape[0], kcss._CMDS_BATCH)], 1)
        del centred
        say(f"[K5 css_cmds {prec}] B={dis.shape[0]} windows, {excluded} excluded "
            f"(eigengap <= {GAP_BOUND:g}; allowed {int(0.01 * dis.shape[0])}), "
            f"{int(kv.sum())} valid, {int(ks.isnan().sum())} NaN in both: scores "
            f"max_rel_err={err:.3e}, {bad} beyond {tol_txt}; kernel {ms:.4f} ms "
            f"plain {pms:.4f} ms; eigen step alone (torch.linalg.eigh) {lib:.4f} ms; "
            f"multisection steps mean {float(steps.float().mean()):.2f} max "
            f"{int(steps.max())}, inverse iteration {INVERSE_ITERS} solves a vector")
        check(excluded <= 0.01 * dis.shape[0], f"css_cmds: {excluded} degenerate windows")
        check(bad == 0, f"css_cmds {prec}: {bad} windows beyond tolerance")
        results["css_cmds"][prec] = (abs_err(got, want), err, ms, pms)
        results["css_cmds"][prec + "_excluded"] = excluded
        results["css_cmds"][prec + "_library_ms"] = lib
        results["css_cmds"][prec + "_steps"] = (float(steps.float().mean()), int(steps.max()))
        # D in, distances out; an eigensolver needs at least the (4/3) m^3
        # of a tridiagonal reduction, at the precision's rate
        m, B = ASIZE + BSIZE, dis.shape[0]
        esize, rate = (4, "f32") if prec == "fast" else (8, "f64")
        results["css_cmds"]["bound" if prec == "fast" else "bound_exact"] = bound(
            B * (2 * m * m * esize + 8 + esize + 1), {rate: B * 4 * m**3 // 3})
        del ks, kd, kv, ps, pd, pv, dis, steps
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


def smacof_ops(m: int) -> int:
    """Operations of one Guttman transform with its stress: per pair i < j
    a distance (2 differences, 2 products, a sum, a square root), its
    residual (a difference, a product, a sum) and b_ij (a division), 10;
    per ordered pair i != j the row sums (2 products, 3 sums), 5; a square
    root or division counted as one operation, an underestimate of its
    time."""
    return 10 * m * (m - 1) // 2 + 5 * m * (m - 1)


# the FET bootstrap's operations (K2, K2r, K10): a threefry-2x32 hash is
# 20 rounds of an add, a rotate (one funnel shift) and an xor, plus 12
# key-injection adds, at the int32 rate; a pow counts as 20 operations of
# its precision (a log and an exp, each a range reduction and a short
# polynomial)
THREEFRY_OPS, POW_OPS = 72, 20


def bootstrap_ops(npos, perc: float, nsamples: int, fast: bool, sort: bool = True) -> dict:
    """Operations the windows' bootstrap needs, from their SNP counts:
    per window (t1 + 1) x (nsamples + 1) threefry hashes (a fold_in a step
    and a draw a sample; t1 = n - 1 - floor((n - 1) perc)) at the int32
    rate, (t1 + 1) x nsamples pows at the precision's rate, and where the
    body sorts (the warp and block bodies; ``sort``) the bitonic network's
    compares (P/2 a stage, log2 P (log2 P + 1) / 2 stages) at the rate of
    float32 operations that are not multiply-adds.  The wide body sorts
    nothing: its picks need the order statistics, which a select finds
    reading each key a few times (bytes, counted by the caller once)."""
    import numpy as np

    n = np.asarray(npos, dtype=np.int64)
    n = n[n > 0]
    steps = np.maximum(n - 1 - np.floor((n - 1) * perc), 0) + 1
    ops = {"i32": float((steps * (nsamples + 1)).sum()) * THREEFRY_OPS,
           "f32" if fast else "f64": float((steps * nsamples).sum()) * POW_OPS}
    if sort:
        lg = np.maximum(5, np.ceil(np.log2(np.maximum(n, 1))))
        ops["f32_op"] = float((2.0 ** lg / 2 * lg * (lg + 1) / 2).sum())
    return ops


def old_reckoning(npos, perc: float, nsamples: int, fast: bool) -> dict:
    """The bootstrap's operations as PR 12-14 counted them, printed beside
    bootstrap_ops's on the wide rows: the hashes and the network's
    compares at the float32 multiply-add peak."""
    ops = bootstrap_ops(npos, perc, nsamples, fast, sort=True)
    ops["f32"] = ops.get("f32", 0.0) + ops.pop("i32") + ops.pop("f32_op")
    return ops


def smacof_check(torch, kcss, dis, npos, asize, bsize, mds, key, slots, prec, label,
                 band=None, plain_windows=None, old_ms=None):
    """css_smacof against css_smacof_plain on the card at one precision
    (fast: within ``band``, (max, 90th percentile), by default
    SMACOF_FAST_BAND), the kernel on every window, the plain version on the
    first ``plain_windows`` (all by default; a window's result does not
    depend on the others).  Returns ((max_abs_err, max_rel_err, kernel ms,
    plain ms), windows whose chosen restart or transform count differ,
    Guttman transforms of every restart summed over the windows)."""
    dt = torch.float32 if prec == "fast" else torch.float64
    d = dis.to(dt).contiguous()
    total = torch.zeros(d.shape[0], dtype=torch.int32, device=d.device)
    kern = lambda: kcss.css_smacof(d, npos, asize, bsize, mds, key, slots,  # noqa: E731
                                   transforms=total)
    ks, kd, kv, kr, kn = kern()
    n = d.shape[0] if plain_windows is None else min(d.shape[0], plain_windows)
    (ps, pd, pv, pr, pn), pms = event_ms(
        torch, lambda: kcss.css_smacof_plain(d[:n], npos[:n], asize, bsize, mds, key,
                                             slots[:n])
    )
    torch.cuda.synchronize()
    all_n, all_v = kn, kv
    ks, kd, kv, kr, kn = ks[:n], kd[:n], kv[:n], kr[:n], kn[:n]
    check(torch.equal(kv, pv), f"{label} {prec}: valid flags differ")
    check(torch.equal(ks.isnan(), ps.isnan()), f"{label} {prec}: NaN patterns differ")
    B = n
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
        top, q90 = band or SMACOF_FAST_BAND[mds]
        err = float(rel.max()) if rel.numel() else 0.0
        q = float(torch.quantile(rel, 0.9)) if rel.numel() else 0.0
        tol_txt = (f"max_rel_err={err:.3e} (band {top:g}), 90th percentile {q:.3e} "
                   f"(band {q90:g}); {differ} windows stop differently")
        check(err <= top and q <= q90, f"{label} {prec}: {err}, q90 {q} beyond the band")
    ms = cuda_ms(torch, kern, 2)
    steps = all_n[all_v].double()
    check(bool((total >= all_n).all()), f"{label} {prec}: transforms below the chosen restart's")
    old_txt = "" if old_ms is None else f" (before the redesign: {old_ms} ms)"
    subset = "" if n == d.shape[0] else f" on the first {n}"
    say(f"[K6 {label} {prec}] B={d.shape[0]} windows, {int(all_v.sum())} valid, "
        f"{int(ks.isnan().sum())} NaN in both{subset}, mean {float(steps.mean()):.1f} / max "
        f"{int(all_n.max())} Guttman transforms on the chosen restart, "
        f"{float(total.double().mean()):.1f} a window over every restart: {tol_txt}{subset}; "
        f"kernel {ms:.3f} ms{old_txt}, plain {pms:.3f} ms ({n} windows)")
    return (abs_err(got, want), err, ms, pms), differ, int(total.sum())


def large_smacof_band(mds: int, m: int) -> tuple:
    """K6's fast band at panel size m: the JAX package's own float32 band
    measured at that m in that mode, else SMACOF_FAST_BAND."""
    return LARGE_SMACOF_BAND.get((mds, m), SMACOF_FAST_BAND[mds])


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
            if mds == 1:   # D in, distances out; every restart's transforms
                # (the chosen restart's alone would be about n_init-fold too
                # few), each at least smacof_ops(m)
                m = ASIZE + BSIZE
                size = 4 if prec == "fast" else 8
                kind = "f32" if prec == "fast" else "f64"
                b = bound(dis.shape[0] * (2 * m * m * size + 9 + size),
                          {kind: smacof_ops(m) * steps})
                r["bound" if prec == "fast" else "bound_exact"] = b
                r.setdefault("transforms", {})[prec] = steps
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
    total8 = torch.zeros(d8.shape[0], dtype=torch.int32, device=dev)
    (s8, _, v8, _, n8), ms = event_ms(
        torch, lambda: kcss.css_smacof(d8, npos8_d, ASIZE, BSIZE, 1, key, slot8_d,
                                       transforms=total8)
    )
    check(bool(torch.isfinite(s8[v8]).all()) and int(v8.sum()) > 0, "css_smacof bench: non-finite")
    m = ASIZE + BSIZE
    b8 = bound(d8.shape[0] * (2 * m * m * 4 + 13), {"f32": smacof_ops(m) * int(total8.sum())})
    say(f"[K6 css_smacof mds=1 fast bench] B={d8.shape[0]} windows, {int(v8.sum())} valid, "
        f"mean {float(n8[v8].double().mean()):.1f} transforms on the chosen restart, "
        f"{float(total8.double().mean()):.1f} over every restart: kernel {ms:.1f} ms "
        f"({d8.shape[0] / ms * 1e3:,.0f} windows/s, one call), bound {b8[0]:.3f} ms "
        f"({b8[1]}); plain version not run at this size")
    r["bench_fast_ms"], r["bound_bench"] = ms, b8
    del d8, s8, v8, n8, total8
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


def mc_windows(torch, workload, dev, a=ASIZE, b=BSIZE, limit=None):
    """(dist [B, m, m] float32 on the card, float64 observed scores,
    chromosome hashes, slots) of a CSS workload's valid windows at panel a
    + b, at most ``limit``: phase 1 in fast mode, as the engine gives them
    to phase 2."""
    import numpy as np

    from divergence_tpu_torch import rng
    from divergence_tpu_torch.kernels import css as kcss

    vals, lo, npos, slot = large_cells(torch, a, b, workload[:3], dev)
    if limit is not None:
        lo, npos, slot = lo[:limit], npos[:limit], slot[:limit]
    s, d, v = kcss.css_phase1(vals, lo, npos, a, b, fast=True)
    keep = v.cpu().numpy()
    slots = slot.numpy()[keep]
    chroms = np.full(len(slots), rng.chrom_hash("_"), dtype=np.int64)
    return d[v].float().contiguous(), s[v].double().cpu().numpy(), chroms, slots


def window_ops(form: str, m: int, asize: int) -> dict:
    """Operations of one window-stream permutation, by type: m draws (two
    mix32, 16 integer operations, or a threefry-2x32, ~70), the ranks as a
    bitonic sort's compares of the m (draw, index) keys (p/2 log2 p
    (log2 p + 1) / 2, p the power of two >= m: 1,792 at m = 128, not the
    m^2 a rank count takes), and the score: a*b + m - 2 float32 products
    and as many adds, each rounded on its own (no fused multiply-add, so
    each an instruction), or in the float64 form about C(g, 2) + g + m
    float64 adds over the rank order (g the smaller group)."""
    bsize = m - asize
    p = 1 << max(m - 1, 1).bit_length()
    lg = p.bit_length() - 1
    ints = (70 if form == "threefry" else 16) * m + p // 2 * lg * (lg + 1) // 2
    if form == "native":
        g = min(asize, bsize)
        return {"i32": ints, "f64_op": g * (g - 1) // 2 + g + m + 6}
    return {"i32": ints, "f32_op": 2 * (asize * bsize + m - 2)}


def pace(ms: float, perms: int, bnd: tuple, old: float | None = None) -> str:
    """ns a permutation, the ratio to the bound and (where given) the old body's
    time of the same cell, for a phase 17 line."""
    was = "" if old is None else f"; old body {old:,.1f} ms ({old / ms:.1f}x this)"
    return f"{ms * 1e6 / max(perms, 1):.2f} ns a permutation, {ms / bnd[0]:.1f}x the bound{was}"


def explain_differences(torch, kperm, rng, dist, scores, wkeys, got, n, h, chunk,
                        bitgen, native, a=ASIZE, b=BSIZE, label="K8") -> int:
    """Windows whose (nscores, hits) differ between a kernel and its plain
    version; each must hold a permutation, among those either consumed,
    whose score lies within TIE_RTOL (float32 forms, rescored in float64)
    or TIE_RTOL_F64 (the float64 form, rescored in its own order) of the
    observed score: a near tie.  Returns their count."""
    import numpy as np

    bad = np.nonzero((got.nscores != n) | (got.hits != h))[0]
    for w in bad:
        nn = int(max(got.nscores[w], n[w]))
        r = torch.cat([kperm._ranks(rng.fold_in(wkeys[w:w + 1], k), chunk, a + b, bitgen)
                       for k in range(-(-nn // chunk))], dim=-1)
        D = dist[w:w + 1].double()
        obs = float(np.float32(scores[w]))
        if native:
            s64 = kperm._native_scores(D, kperm._row_totals(D), r, a, b)[0]
        else:
            s64 = (D[..., None] * kperm._rank_coeff(r, a, b).double()).sum(dim=(1, 2))[0]
        gap = float((s64[:nn] - obs).abs().min()) / max(abs(obs), 1.0)
        say(f"[{label}] window {w}: (n, hits) kernel ({got.nscores[w]}, {got.hits[w]}) plain "
            f"({n[w]}, {h[w]}); nearest permuted score {gap:.2e} from the observed")
        check(gap <= (TIE_RTOL_F64 if native else TIE_RTOL),
              f"{label}: window {w} differs without a near tie ({gap})")
    return len(bad)


def k8_launch_times(torch, kperm, dist, scores, wkeys, bitgen, native, a=ASIZE, b=BSIZE,
                    runs=MC_RUNS, kernel="css_mc_window") -> dict:
    """One call of K8's range loop to ``runs`` at chunk 256 with the
    ``kernel`` (css_mc_window or css_mc_window_block) and css_mc_scan
    launches between CUDA events: their summed device times, the host
    wall, the ranges and the permutations computed (every running window
    pays for its whole range) and consumed."""
    obs = torch.as_tensor(scores).to(dist.device).float()
    ranges = []
    with timed_launches(torch, kperm, (kernel, "css_mc_scan")) as spans:
        (nsc, _), wall = host_ms(torch, lambda: kperm.mc_window(
            dist, obs, wkeys, a, b, 256, runs, 10, bitgen, native=native, ranges=ranges))
    kms = {k: sum(x.elapsed_time(y) for x, y in v) for k, v in spans.items()}
    computed = sum(n * (min(runs, (k + nk) * 256) - k * 256) for k, nk, n in ranges)
    return {"hits_ms": kms[kernel], "scan_ms": kms["css_mc_scan"], "wall_ms": wall,
            "ranges": ranges, "computed": computed, "nsc": nsc.cpu().numpy()}


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
        lt = k8_launch_times(torch, kperm, dist, scores, wkeys, bitgen, backend == "native")
        check(np.array_equal(lt["nsc"], got.nscores), f"css_mc_window {form}: rerun differs")
        say(f"[K8 css_mc_window {form}] {B} windows, {perms} permutations, "
            f"{int((n == MC_RUNS).sum())} to the {MC_RUNS} cap: {nd} windows differ (allowed "
            f"{int(MC_DIFFER_SHARE * B)}: near ties); kernel {ms:.1f} ms plain {pms:.1f} ms "
            f"(host wall, one call each; {perms / ms * 1e3:,.0f} vs "
            f"{perms / pms * 1e3:,.0f} perms/s); launches alone (CUDA events): css_mc_window "
            f"{lt['hits_ms']:.2f} ms, css_mc_scan {lt['scan_ms']:.3f} ms in a "
            f"{lt['wall_ms']:.1f} ms call; {len(lt['ranges'])} ranges {lt['ranges']}; "
            f"{lt['computed']} permutations computed for {perms} consumed "
            f"({lt['computed'] / max(perms, 1):.4f}x)")
        r[f"launches_{form}"] = lt
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
    kern()                                       # warm-up
    got, ms = host_ms(torch, kern)
    k7()
    got7, ms7 = host_ms(torch, k7)
    perms, perms7 = int(got.nscores.sum()), int(got7.nscores.sum())
    wkeys16 = rng.window_keys(key, wchroms, wslots)
    lt = k8_launch_times(torch, kperm, wdist, wscores, wkeys16, "mix", False)
    check(np.array_equal(lt["nsc"], got.nscores), "css_mc_window 16x: rerun differs")
    bnd16 = bound(wdist.shape[0] * (m * m * 4 + 4 + 16 + 8),
                  {t: v * perms for t, v in window_ops("mix", m, ASIZE).items()})
    say(f"[K8 css_mc_window mix, 16x worst case] {wdist.shape[0]} windows, {perms} "
        f"permutations: kernel {ms:.1f} ms ({perms / ms * 1e3:,.0f} perms/s; host wall, "
        f"one call); launches alone (CUDA events): css_mc_window {lt['hits_ms']:.2f} ms, "
        f"css_mc_scan {lt['scan_ms']:.3f} ms in a {lt['wall_ms']:.1f} ms call; "
        f"{len(lt['ranges'])} ranges {lt['ranges']}; {lt['computed']} permutations "
        f"computed for {perms} consumed ({lt['computed'] / max(perms, 1):.4f}x); bound "
        f"{bnd16[0]:.2f} ms ({bnd16[1]}); K7 css_mc_shared on the same windows {ms7:.1f} ms "
        f"for {perms7} permutations ({perms7 / ms7 * 1e3:,.0f} perms/s); plain version not "
        "run at this size")
    check(bool(((got.hits == 10) | (got.nscores == MC_RUNS)).all()), "css_mc_window 16x")
    r["worst_ms"], r["worst_k7_ms"] = ms, ms7
    r["launches_16x"], r["bound_16x"], r["perms_16x"] = lt, bnd16, perms
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
        ms = median_ms(torch, kern, 5)
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
            f"two calls bit-equal={repeat}; kernel {ms:.3f} ms (median of 5 calls) plain "
            f"{pms:.3f} ms")
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
                                       {"f32": 2 * m * m * nperm, "f64_op": 5 * nperm})
            flat = pdist.reshape(PB, m * m)
            r9["library_ms"] = cuda_ms(torch, lambda: flat @ M, 3)
            say(f"[K9] library yardstick torch.matmul [{PB}, {m * m}] @ [{m * m}, "
                f"{M.shape[1]}]: {r9['library_ms']:.3f} ms")
            del M
        else:
            ops = {t: v * nperm for t, v in window_ops("mix", m, ASIZE).items()}
            ops["f64_op"] = 5 * nperm
            r9["bound_window"] = bound(PB * (m * m * 4 + 16) + out_bytes, ops)
            # the kernel's sum order, mirrored in torch on the plain
            # scores: the same bits on every window
            mirror = kperm.window_power_order(torch.stack([
                kperm._perm_scores(pdist, rng.fold_in(pwkeys, c), ASIZE, BSIZE, APPROX_CHUNK)
                for c in range(APPROX_CHUNKS)], dim=1))
            same_bits = torch.equal(kp.view(torch.int64), mirror.view(torch.int64))
            del mirror
            # the launches alone, each call between two CUDA events
            with timed_launches(torch, kperm, ("css_mc_power",)) as spans:
                for _ in range(5):
                    kern()
            torch.cuda.synchronize()
            kms = sorted(a.elapsed_time(b) for a, b in spans["css_mc_power"])[2]
            say(f"[K9 css_mc_power window] bit-equal to its sum order mirrored in torch "
                f"(window_power_order) on all {PB} windows: {same_bits}; the launches alone "
                f"(CUDA events, median of 5 calls) {kms:.3f} ms, bound "
                f"{r9['bound_window'][0]:.3f} ms ({r9['bound_window'][1]})")
            check(same_bits, "css_mc_power window: the sums differ from window_power_order")
            results["css_mc_power_window"].update({
                "fast": (abs_err(kp, pp), prel, ms, pms), "bound": r9["bound_window"],
                "kernel_ms": kms, "mirror_bit_equal": same_bits, "differ": nd})
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
    results["css_mc_power_window"]["bench_ms"] = r9["bench_ms"]["window"]
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
        p, a, b = synth.make_panel(WINDOW_MULTI_SNPS, WINDOW_MULTI_REGION, ASIZE, BSIZE,
                                   seed=30 + i)
        pairs[seqid] = (SnpPair(p, a, b), WINDOW_MULTI_REGION)
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
            f"(3 x {WINDOW_MULTI_SNPS} SNPs, {n_scored} windows, mc_runs {MULTI_MC_RUNS}): "
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


def k10_bound(kfet, npos, fast: bool, sort: bool = True) -> tuple[float, str]:
    """K10's bound on gathered windows of the 11 + 10 panel: each window's
    n (a + b) int16 codes, npos and slot in, 2 values out, the LUT read
    once; two compares a code for the tables, and the bootstrap's
    operations (bootstrap_ops; ``sort`` False for the wide body)."""
    m = ASIZE + BSIZE
    n_tests = int(npos.sum())
    size = 4 if fast else 8
    lut = (ASIZE + 1) ** 2 * (BSIZE + 1) ** 2 * size
    ops = bootstrap_ops(npos, 0.95, 100, fast, sort)
    ops["i32"] += 2 * m * n_tests
    return bound(n_tests * m * 2 + npos.numel() * (16 + 2 * size) + lut, ops)


def gathered_bound(npos, m: int, size: int) -> tuple[float, str]:
    """K4's gather form: each window's n m int16 codes and npos in, m x m
    counts of ``size`` bytes out; two ANDs, two popcounts and two adds a
    pair and 32-SNP word."""
    words = int(((npos + 31) // 32).sum())
    return bound(int(npos.sum()) * m * 2 + npos.numel() * (8 + m * m * size),
                 {"f32": 6 * words * m * (m - 1) // 2})


def onehot_operands(torch, av, bv, npos, P: int):
    """The float32 one-hots of gathered windows: [B, m, 2P] = [maj | mnr]
    and [B, 2P, m] = [mnr ; maj], rows past npos zero, built in chunks;
    their product is the windows' counts (JAX's K4 body)."""
    B, m = av.shape[0], av.shape[2] + bv.shape[2]
    dev = av.device
    A = torch.empty((B, m, 2 * P), dtype=torch.float32, device=dev)
    Bm = torch.empty((B, 2 * P, m), dtype=torch.float32, device=dev)
    npos_d = npos.to(dev)
    for s0 in range(0, B, 50_000):
        sl = slice(s0, min(s0 + 50_000, B))
        codes = torch.cat([av[sl], bv[sl]], dim=-1)
        valid = (torch.arange(P, device=dev)[None, :] < npos_d[sl, None])[..., None]
        maj, mnr = (((codes == c) & valid).float() for c in (3, -3))
        A[sl, :, :P], A[sl, :, P:] = maj.transpose(1, 2), mnr.transpose(1, 2)
        Bm[sl, :P], Bm[sl, P:] = mnr, maj
    return A, Bm


def phase_step_kernels(torch, pair, plan, ids, dev, results, k2_bench) -> dict:
    """Phase 12: K10 and K11 against their plain versions on the 19,997
    windows of the 200 k workload (K10 both precisions, K11 both draw
    streams; K11 also on a 200 k-SNP stickleback-shaped panel, where the
    null is hit), K11 against K8's first chunk on that panel, K10 on the
    ~800 k bench windows bit-equal to phase 2's K1 -> K2, and K11 at the
    step's size (those windows' distances, 128 permutations each, both
    draw streams) against its plain version and timed alone.  Returns the
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
    npos_d, slot_d = npos.to(dev), slot.to(dev)   # kernels timed with descriptors on the card
    key = rng.fold_in(rng.prng_key(0), 0)
    r10["differ"] = {}
    for prec in ("fast", "exact"):
        fast = prec == "fast"
        tol = TOL[prec]
        kern = lambda: kfet.fet_window_batch(  # noqa: E731
            av, bv, npos_d, 0.95, key, 100, maxs, nmax, fast, slot_d)
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
        r10["bound" if fast else "bound_exact"] = k10_bound(kfet, npos, fast)

    # K10 on synthetic windows at P = 256 (the block body) and 4,096 (the
    # wide body)
    rs = np.random.default_rng(12)
    for Pb, Bb in ((256, 2000), (4096, 200)):
        codes = np.array([3, -3, 0, -10000], np.int16)
        sa = torch.from_numpy(rs.choice(codes, size=(Bb, Pb, ASIZE))).to(dev)
        sb = torch.from_numpy(rs.choice(codes, size=(Bb, Pb, BSIZE))).to(dev)
        sn = torch.from_numpy(rs.integers(Pb // 2 + 1, Pb + 1, size=Bb))
        ss = torch.arange(Bb) * 5
        for prec in ("fast", "exact"):
            fast, tol = prec == "fast", TOL[prec]
            (ks, kd), (ps, pd) = (f(sa, sb, sn, 0.95, key, 100, maxs, nmax, fast, ss) for f in (
                kfet.fet_window_batch, kfet.fet_window_batch_plain))
            err_sc = rel_err(ks, ps)
            beyond = int(((kd.double() - pd.double()).abs()
                          / pd.double().abs().clamp(min=1.0) > tol).sum())
            ms = cuda_ms(torch, lambda: kfet.fet_window_batch(
                sa, sb, sn, 0.95, key, 100, maxs, nmax, fast, ss), 3)
            form = kfet.window_form(Pb, 100, 4 if fast else 8, 4 if fast else 8)
            say(f"[K10 fet_window {prec}, {form} body] {Bb} synthetic windows at P={Pb}: scores "
                f"max_rel_err={err_sc:.3e} (tol {tol:g}); stddev {beyond} windows beyond tol "
                f"(allowed {int(STDDEV_BEYOND_SHARE * Bb) + 1}); kernel {ms:.4f} ms")
            check(err_sc <= tol and beyond <= STDDEV_BEYOND_SHARE * Bb + 1,
                  f"fet_window {prec} {form} body at P={Pb}: {err_sc}, {beyond}")
            r10[f"synthetic_{Pb}_{prec}_ms"] = ms
        del sa, sb

    # K3's gather form on the same windows: the plain twin's counts exactly
    rg = results["css_dissim_gathered"]
    for prec in ("fast", "exact"):
        dt = torch.float32 if prec == "fast" else torch.float64
        k = kcss.css_dissim_gathered(av, bv, npos_d, dt)
        q = kcss.dissimilarity_gathered_plain(av, bv, npos)
        diff = abs_err(k, q)
        ms = cuda_ms(torch, lambda: kcss.css_dissim_gathered(av, bv, npos_d, dt), 10)
        pms = cuda_ms(torch, lambda: kcss.dissimilarity_gathered_plain(av, bv, npos), 2)
        say(f"[K3 css_dissim_gathered {prec}] {B} windows (P={P}): max_abs_diff={diff} "
            f"(exact counts); kernel {ms:.4f} ms plain {pms:.4f} ms")
        check(diff == 0.0, f"css_dissim_gathered {prec}: counts differ by {diff}")
        rg[f"{prec}_20k"] = (diff, diff, ms, pms)
        rg[f"bound_20k_{prec}"] = gathered_bound(npos, m, k.element_size())
        del k, q

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
        dist32, obs32 = dist.float().contiguous(), css_s.float().contiguous()
        for bitgen in ("mix", "threefry"):
            kern = lambda: kperm.permutation_chunk(  # noqa: E731
                dist32, obs32, ones, PERM_CHUNK, wkeys, ASIZE, BSIZE, PERM_CHUNK, bitgen)
            plain = lambda: kperm.permutation_chunk_plain(  # noqa: E731
                dist32, obs32, ones, PERM_CHUNK, wkeys, ASIZE, BSIZE, PERM_CHUNK, bitgen)
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
                r11[f"{bitgen}_20k"] = (float((k[0] - q[0]).abs().max()), 0.0, ms, pms)
            say(f"[K11 css_perm_chunk {bitgen}, {label}] {WB} windows x {PERM_CHUNK} "
                f"permutations ({int(k[0].sum())} hits, {int(k[1].sum())} windows reach "
                f"need = 1): {nd} windows differ from the plain version (allowed 0){timing}")
            check(nd == 0, f"css_perm_chunk {bitgen} ({label}): {nd} windows differ")
            r11["differ"][f"{bitgen}_{label}"] = nd
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
    del av, bv, hav, hbv, dist, css_s, wkeys, dist32, obs32
    torch.cuda.empty_cache()

    # K10 on the ~800 k bench windows: phase 2's K1 -> K2 bit for bit
    lo8, npos8, slot8 = (torch.from_numpy(a[ids].copy()) for a in (plan.lo, plan.npos, plan.slot))
    bav, bbv, Bp = gather_windows(torch, pair.to_device(dev), lo8, npos8, STEP_P, STEP_SHARES)
    B8 = lo8.numel()
    npos8_d, slot8_d = npos8.to(dev), slot8.to(dev)
    ckey = chromosome_key(0, "chrBench")
    r10["bench_ms"], r10["bit_equal"] = {}, True
    for prec in ("fast", "exact"):
        fast, tol = prec == "fast", TOL[prec]
        kern = lambda: kfet.fet_window_batch(  # noqa: E731
            bav[:B8], bbv[:B8], npos8_d, 0.95, ckey, 100, maxs, nmax, fast, slot8_d)
        s, d = kern()
        eq = torch.equal(s, k2_bench[prec][0]) and torch.equal(d, k2_bench[prec][1])
        ms = cuda_ms(torch, kern, 5)
        # the plain version in chunks of windows (its [B, P, support]
        # intermediates), one pass timed
        chunks = [slice(i, min(i + 100_000, B8)) for i in range(0, B8, 100_000)]
        (ps, pd), pms = event_ms(torch, lambda: tuple(torch.cat(c) for c in zip(*(
            kfet.fet_window_batch_plain(bav[c], bbv[c], npos8[c], 0.95, ckey, 100, maxs,
                                        nmax, fast, slot8[c])
            for c in chunks))))
        err_sc = rel_err(s, ps)
        beyond = int(((d.double() - pd.double()).abs() / pd.double().abs().clamp(min=1.0)
                      > tol).sum())
        b = k10_bound(kfet, npos8, fast)
        say(f"[K10 fet_window {prec}, bench] {B8} windows at P={STEP_P}: bit-equal to phase "
            f"2's K1 -> K2: {eq}; against the plain version scores max_rel_err={err_sc:.3e}, "
            f"stddev {beyond} windows beyond tol (allowed {int(STDDEV_BEYOND_SHARE * B8)}); "
            f"kernel {ms:.3f} ms (mean of 5 warm calls), plain {pms:.1f} ms (one call), bound "
            f"{b[0]:.3f} ms ({b[1]})")
        check(eq, f"fet_window {prec} differs from K1 -> K2 on the bench windows")
        check(err_sc <= tol and beyond <= STDDEV_BEYOND_SHARE * B8,
              f"fet_window {prec} on the bench windows: {err_sc}, {beyond}")
        r10["bench_ms"][prec] = ms
        r10[f"bench_plain_ms_{prec}"] = pms
        r10[f"bound_800k_{prec}"] = b
        del s, d, ps, pd

    # K3's gather form on the bench windows: the plain twin's counts, and
    # the library yardstick, one torch.bmm of the windows' one-hots
    # [B, m, 2P] @ [B, 2P, m] (the one-hots built beforehand, not timed)
    lib_counts = None
    for prec in ("fast", "exact"):
        dt = torch.float32 if prec == "fast" else torch.float64
        k = kcss.css_dissim_gathered(bav[:B8], bbv[:B8], npos8_d, dt)
        q = kcss.dissimilarity_gathered_plain(bav[:B8], bbv[:B8], npos8)
        diff = abs_err(k, q)
        del q
        ms = cuda_ms(torch, lambda: kcss.css_dissim_gathered(bav[:B8], bbv[:B8], npos8_d, dt),
                     5)
        _, pms = event_ms(torch, lambda: kcss.dissimilarity_gathered_plain(
            bav[:B8], bbv[:B8], npos8))
        say(f"[K3 css_dissim_gathered {prec}, bench] {B8} windows at P={STEP_P}: "
            f"max_abs_diff={diff} (exact counts); kernel {ms:.4f} ms (mean of 5 warm calls), "
            f"plain {pms:.1f} ms (one call)")
        check(diff == 0.0, f"css_dissim_gathered {prec} on the bench windows: {diff}")
        rg[prec] = (diff, diff, ms, pms)
        rg["bound" if prec == "fast" else "bound_exact"] = gathered_bound(
            npos8, m, k.element_size())
        if prec == "exact":
            lib_counts = k
        else:
            del k
    A, Bm = onehot_operands(torch, bav[:B8], bbv[:B8], npos8, STEP_P)
    same = torch.equal(torch.bmm(A, Bm).double(), lib_counts)
    lib = cuda_ms(torch, lambda: torch.bmm(A, Bm), 3)
    say(f"[K3 library yardstick] torch.bmm [{B8}, {m}, {2 * STEP_P}] @ [{B8}, {2 * STEP_P}, "
        f"{m}] float32 one-hots (not timed: their construction): {lib:.4f} ms; equal to the "
        f"kernel's counts: {same}")
    check(same, "torch.bmm of the one-hots differs from css_dissim_gathered")
    rg["library_ms"] = results["css_dissim"]["library_ms"] = lib
    del A, Bm, lib_counts
    torch.cuda.empty_cache()

    # K11 alone at the step's size: the bench windows' exact CSS distances
    # and keys as make_divergence_step gives them, against the plain version
    # on every window; the kernel timed by CUDA events
    k_css, k_mc = (rng.fold_in(rng.prng_key(0), i) for i in (1, 2))
    css_s, dist, _ = kcss.css_window_batch(bav[:B8], bbv[:B8], npos8, k_css, ASIZE, BSIZE,
                                           slot=slot8)
    dist32, obs32 = dist.float().contiguous(), css_s.float().contiguous()
    del dist, css_s
    wkeys = rng.fold_in(rng.fold_in(k_mc.to(dev), 0), slot8.to(dev))
    ones = torch.ones(B8, dtype=torch.int32, device=dev)
    perms = B8 * PERM_CHUNK
    for bitgen in ("mix", "threefry"):
        kern = lambda: kperm.permutation_chunk(  # noqa: E731
            dist32, obs32, ones, PERM_CHUNK, wkeys, ASIZE, BSIZE, PERM_CHUNK, bitgen)
        k = kern()
        q, pms = event_ms(torch, lambda: kperm.permutation_chunk_plain(
            dist32, obs32, ones, PERM_CHUNK, wkeys, ASIZE, BSIZE, PERM_CHUNK, bitgen))
        nd = int(((k[0] != q[0]) | (k[1] != q[1]) | (k[2] != q[2])).sum())
        del q
        ms = cuda_ms(torch, kern, 10)
        ops = {t: v * perms for t, v in window_ops(bitgen, m, ASIZE).items()}
        b = bound(B8 * (m * m * 4 + 4 + 4 + 16) + B8 * 9, ops)
        say(f"[K11 css_perm_chunk {bitgen}, step size] {B8} windows x {PERM_CHUNK} "
            f"permutations ({int(k[0].sum())} hits): {nd} windows differ from the plain "
            f"version (allowed 0); kernel {ms:.4f} ms ({perms / ms * 1e3:,.0f} "
            f"permutations/s), plain {pms:.1f} ms (one call), bound {b[0]:.3f} ms ({b[1]})")
        check(nd == 0, f"css_perm_chunk {bitgen} (step size): {nd} windows differ")
        r11["differ"][f"{bitgen}_step"] = nd
        r11[bitgen] = (0.0, 0.0, ms, pms)
        r11[f"bound_{bitgen}"] = b
    r11["fast"], r11["bound"] = r11["mix"], r11["bound_mix"]
    del dist32, obs32, wkeys, ones, k
    torch.cuda.empty_cache()
    pad = Bp - B8
    return {
        "av": bav, "bv": bbv, "B": B8,
        "npos": torch.cat([npos8, torch.zeros(pad, dtype=torch.int64)]),
        "slot": torch.cat([slot8, torch.zeros(pad, dtype=torch.int64)]),
    }


def phase_step_library(torch, gathered, dev, card, tmp: Path, results) -> None:
    """Phase 13: the sharded step at full width on the ~800 k bench windows
    (warm min of 3, profiled, its kernels timed by CUDA events and its
    concatenations on the card measured), over 4 shares of the card against 1 (bit-
    equal), against its all-plain version on 20,000 windows; bench-scaling
    at its defaults; run-fet and run-css with --shard and with
    --num-hosts 2 + merge-tracks on phase 9's small files, byte-equal to
    the unsharded tracks."""
    import numpy as np

    from divergence_tpu_torch import rng
    from divergence_tpu_torch.kernels import css as kcss
    from divergence_tpu_torch.kernels import fet as kfet
    from divergence_tpu_torch.kernels import perm as kperm
    from divergence_tpu_torch.parallel import make_divergence_step, make_mesh
    from divergence_tpu_torch.tools import cli, synth
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
    # each kernel's time by CUDA events around its launches, in one warm
    # call (one run's profiler table lacked css_cmds' record: its
    # per-kernel rows are printed beside these, not relied on), and the
    # bytes of every concatenation on the card in that call (a joint copy
    # of the codes would be 4.3 GB)
    path = {kfet: ("fet_window",), kcss: ("css_dissim_gathered", "css_cmds"),
            kperm: ("css_perm_chunk",)}
    cat_bytes = [0]
    real_cat = torch.cat

    def counting_cat(tensors, *args, **kwargs):
        out = real_cat(tensors, *args, **kwargs)
        if out.is_cuda:
            cat_bytes.append(out.numel() * out.element_size())
        return out

    with contextlib.ExitStack() as stack:
        spans = {}
        for mod, kernel_names in path.items():
            spans.update(stack.enter_context(timed_launches(torch, mod, kernel_names)))
        torch.cat = counting_cat
        try:
            one(av, bv, npos, slot, key)
        finally:
            torch.cat = real_cat
        torch.cuda.synchronize()
    kms_by = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    k5_ms, k10_ms = kms_by["css_cmds"], kms_by["fet_window"]
    k3_ms, k11_ms = kms_by["css_dissim_gathered"], kms_by["css_perm_chunk"]
    check(all(v > 0 for v in kms_by.values()), f"step: a kernel of the path took no time {kms_by}")
    check(max(cat_bytes) < 100e6, f"step: a concatenation of {max(cat_bytes)} bytes on the card")
    seen = {k: sum(ms for ms, name in top if key in name)
            for k, key in (("K5", "css_cmds"), ("K11", "perm_chunk"), ("K10", "fet_window"),
                           ("K3", "css_dissim"))}
    say(f"[step] make_divergence_step(11, 10) defaults on {B} bench windows (+{Bp - B} empty, "
        f"P={STEP_P}), 1 device: warm wall min {min(walls1):.1f} ms median "
        f"{float(np.median(walls1)):.1f} ms ({B / min(walls1) * 1e3:,.0f} windows/s); "
        f"{n_valid} CSS-valid windows, score_sum {float(out1['score_sum']):.6f}, "
        f"{int(out1['mc_hits'].sum())} MC hits; profiled wall {wall:.1f} ms, device "
        f"{dev_ms:.1f} ms ({100 * dev_ms / wall:.1f} % busy); most device time: "
        + "; ".join(f"{name[:50]} {ms:.2f} ms" for ms, name in top[:3]) + "; the profiler's "
        + ", ".join(f"{k} {v:.2f}" for k, v in seen.items()) + f" ms; by CUDA events: K5 "
        f"css_cmds {k5_ms:.2f} ms ({100 * k5_ms / wall:.1f} % of the wall), K11 perm_chunk "
        f"{k11_ms:.2f} ms, K10 fet_window {k10_ms:.2f} ms, K3 css_dissim_gathered "
        f"{k3_ms:.2f} ms, the four {100 * sum(kms_by.values()) / min(walls1):.1f} % of the "
        f"warm wall; largest concatenation on the card {max(cat_bytes):,} bytes, on {card}")

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
    dis = kcss.css_dissim_gathered(av[:n], bv[:n], npos[:n], torch.float64)
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
                       "k5_ms": k5_ms, "k5_share": k5_ms / wall, "k10_ms": k10_ms,
                       "k3_ms": k3_ms, "k11_ms": k11_ms, "cat_bytes": max(cat_bytes),
                       "kernel_share": sum(kms_by.values()) / min(walls1),
                       "device_ms": dev_ms, "profiler_ms": seen,
                       "plain_ms": pms, "kernel_ms_20k": kms}
    del outk, outp, dis

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

    # a slot-range merge in fast mode on a panel off the LUT: per-SNP
    # float32 scores with no table to read them from
    a, b = OFF_LUT_PANEL
    check(not kfet.lut_active(a, b), f"{a} + {b} should be off the LUT")
    pos, am, bm = synth.make_panel(SMALL_SNPS, SMALL_REGION, a, b, seed=42)
    off = [tmp / f"offlut_pop{g}.gtrack" for g in "AB"]
    synth.write_gtrack(off[0], "chrI", pos, am)
    synth.write_gtrack(off[1], "chrI", pos, bm)
    base = ["run-fet", "--pop-a", str(off[0]), "--pop-b", str(off[1]), "--device", str(dev),
            "--precision", "fast"]
    ref = tmp / "offlut_ref.track"
    cli.main(base + ["--out", str(ref)])
    shards = [tmp / f"offlut_h{h}.track" for h in (0, 1)]
    for h, out in enumerate(shards):
        cli.main(base + ["--out", str(out), "--num-hosts", "2", "--host-id", str(h)])
    merged = tmp / "offlut_merged.track"
    cli.main(["merge-tracks", "--inputs", *map(str, shards), "--out", str(merged)])
    rows = [len(p.read_text().splitlines()) - 1 for p in shards]
    eq_merge = merged.read_bytes() == ref.read_bytes()
    say(f"[step cli] run-fet fast at {a} + {b} (off the LUT): --num-hosts 2 shards of {rows} "
        f"rows merged byte-equal {eq_merge}")
    check(eq_merge and min(rows) > 0, f"run-fet fast at {a} + {b}: merged track differs")


def float_bits(torch, t):
    """A float tensor's bits, for equality that tells -0.0 from +0.0."""
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def phase_rank_kernels(torch, pair, plan_ids, dev, results, k2_bench, card) -> None:
    """Phase 14: K1r and K2r on the bench FET workload, both precisions:
    ``fet_lut_rank`` against its plain version on K1's LUT, exactly, at
    each of RANK_PANELS, timed (median of 5, queued) beside
    ``torch.sort(lut + 0.0, stable=True)`` alone; ``fet_snp_ranks`` on the
    8 M SNPs (the
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
    lo_d, npos_d, slot_d = (t.to(dev) for t in plan_ids)   # timed as phase 2 times K2
    B, N = lo.numel(), vals.shape[0]
    key = chromosome_key(0, "chrBench")
    idx = kfet._lut_index(kfet.count_tables(vals[:, :ASIZE], vals[:, ASIZE:]), ASIZE, BSIZE)
    rl, rs, ra = (results[k] for k in ("fet_lut_rank", "fet_snp_ranks", "fet_aggregate_ranks"))
    big = RANK_PANELS[-1][0]
    check(kfet.lut_active(big, big) and not kfet.lut_active(big + 1, big + 1),
          f"{big} + {big} must be the largest symmetric panel with a LUT")
    for prec in ("fast", "exact"):
        fast = prec == "fast"
        dt = torch.float32 if fast else torch.float64
        tol = TOL[prec]

        # K1r's LUT sort at each panel
        for a, b in RANK_PANELS:
            label = f"{a}+{b}"
            lut = kfet.fet_lut(a, b, kfet.support_size(a, b), a + b + 2, dt, dev)
            G = lut.numel()
            (ks, kr), (ps, pr) = kfet.fet_lut_rank(lut), kfet.fet_lut_rank_plain(lut)
            torch.cuda.synchronize()
            eq = torch.equal(kr, pr) and torch.equal(float_bits(torch, ks), float_bits(torch, ps))
            ms = median_ms(torch, lambda: kfet.fet_lut_rank(lut), 5, queued=True)  # noqa: B023
            pms = median_ms(torch, lambda: kfet.fet_lut_rank_plain(lut), 5,  # noqa: B023
                            queued=True)
            lms = median_ms(torch, lambda: torch.sort(lut + 0.0, stable=True), 5,  # noqa: B023
                            queued=True)
            # G values in, G values and ranks out; a comparison sort's G
            # log2 G compares of (value, index)
            bnd = bound(G * (2 * lut.element_size() + 4),
                        {"f32": 2 * G * int(np.ceil(np.log2(G)))})
            say(f"[K1r fet_lut_rank {prec}, {label}] G={G}: sorted LUT and ranks "
                f"equal to the plain version's: {eq}; kernel {ms:.4f} ms, torch.sort(lut + 0.0, "
                f"stable=True) alone {lms:.4f} ms ({ms / lms:.2f}x), plain {pms:.4f} ms, bound "
                f"{bnd[0]:.5f} ms ({bnd[1]}); medians of 5, queued")
            check(eq, f"fet_lut_rank {prec} {label} differs from its plain version")
            rl[f"{a}_{b}_{prec}"] = {"G": G, "ms": ms, "plain_ms": pms,
                                      "library_ms": lms, "bound_ms": bnd[0]}
            if (a, b) == (ASIZE, BSIZE):
                rl[prec] = (0.0, 0.0, ms, pms)
                rl["library_ms" if fast else "library_ms_exact"] = lms
                if fast:   # the row's bound keeps the float32 sizes
                    rl["bound"] = bound(G * 4 * 3, {"f32": 2 * G * int(np.ceil(np.log2(G)))})
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
        agg = lambda: kfet.fet_aggregate_ranks(  # noqa: E731
            ls, r, lo_d, npos_d, slot_d, key, 0.95, 100)
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
        # ranks, LUT and descriptors in, 2 values out; the bootstrap's
        # hashes, pows and compares (bootstrap_ops)
        size = ls.element_size()
        ra["bound" if fast else "bound_exact"] = bound(
            N * 4 + ls.numel() * size + B * 3 * 8 + B * 2 * size,
            bootstrap_ops(npos, 0.95, 100, fast))
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

    from divergence_tpu_torch.io import gtrack, read_score_track
    from divergence_tpu_torch.tools import cli

    a_path, b_path, sizes = files
    walls = {}
    gtrack.PARSES.update(native=0, python=0)
    for prec in ("fast", "exact"):
        out = tmp / f"all_{prec}"
        t0 = time.perf_counter()
        cli.main(["run-all", "--pop-a", str(a_path), "--pop-b", str(b_path), "--outdir", str(out),
                  "--chrom-sizes", str(sizes), "--precision", prec, "--device", str(dev)])
        walls[prec] = time.perf_counter() - t0
        split = {name: json.loads((out / f"{name}_summary.json").read_text())["timings_s"]
                 for name in ("fet", "css")}
        walls[f"split_{prec}"] = split
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
    walls["parses"] = dict(gtrack.PARSES)
    return walls


def large_cells(torch, a, b, workload, dev):
    """(codes [N, m] on the card, lo, npos, slot host tensors) of a
    make_chromosome workload's valid windows at panel a + b."""
    from divergence_tpu_torch.engine import SnpPair
    from divergence_tpu_torch.tools.synth import make_chromosome

    npos_, region, seed = workload
    pos, am, bm = make_chromosome(npos_, region, a, b, seed)
    return (SnpPair(pos, am, bm).to_device(dev), *windows_of(torch, pos, region))


def form_switches(form, lo: int, hi: int) -> list:
    """The panel sizes m where ``form(m)`` changes between lo and hi: each
    switch as (m - 1, m), the last m of one form and the first of the next."""
    out, prev = [], form(lo)
    for m in range(lo + 1, hi + 1):
        cur = form(m)
        if cur != prev:
            out.append((m - 1, m))
        prev = cur
    return out


def cmds_case(torch, kcss, dis, npos, a, b, prec, label) -> tuple:
    """K5 against css_cmds_plain on the windows ``dis`` at one precision
    (exact 1e-9 / fast rtol 2e-3 atol 1e-4 where the eigengap exceeds 1e-6;
    valid flags and NaN patterns equal).  Returns (max_abs_err,
    max_rel_err, windows excluded by the eigengap, the plain version's ms
    by CUDA events)."""
    dt = torch.float32 if prec == "fast" else torch.float64
    d = dis.to(dt).contiguous()
    ks, _, kv = kcss.css_cmds(d, npos, a, b)
    (ps, _, pv), pms = event_ms(torch, lambda: kcss.css_cmds_plain(d, npos, a, b))
    torch.cuda.synchronize()
    check(torch.equal(kv, pv), f"{label} {prec}: valid flags differ")
    check(torch.equal(ks.isnan(), ps.isnan()), f"{label} {prec}: NaN patterns differ")
    ok = gap_ok(torch, kcss, dis)
    sel = ok & ~ps.isnan() & pv
    got, want = ks.double()[sel], ps.double()[sel]
    if prec == "exact":
        bad = int((((got - want).abs() / want.abs().clamp(min=1.0)) > TOL_CSS).sum())
    else:
        bad = int(((got - want).abs() > FAST_ATOL + FAST_RTOL * want.abs()).sum())
    excluded = int((~ok).sum())
    check(bad == 0, f"{label} {prec}: {bad} windows beyond tolerance")
    check(excluded <= 0.01 * d.shape[0] + 1, f"{label}: {excluded} degenerate windows")
    return abs_err(got, want), rel_err(got, want), excluded, pms


def phase_large_kernels(torch, dev, card, results) -> None:
    """Phase 16a: the large-panel forms of K3, K5, K7's coefficients and K6
    against their plain versions on the card, both precisions, at 70 + 58
    and 110 + 90 (timed by CUDA events with their bounds and library
    yardsticks), the device-memory paths at 150 + 150, and each kernel on
    both sides of each shared-memory switch the main path crosses up to
    m = 300."""
    import numpy as np

    from divergence_tpu_torch import rng
    from divergence_tpu_torch.kernels import css as kcss
    from divergence_tpu_torch.kernels import perm as kperm

    for a, b in LARGE_PANELS:
        m = a + b
        vals, lo, npos, slot = large_cells(torch, a, b, LARGE_KERNEL_WORKLOAD, dev)
        B = lo.numel()
        lo_d, npos_d = lo.to(dev), npos.to(dev)
        tag = f"{a}+{b}"
        # K3: exact integer counts, the tile form at both sizes
        plain64 = kcss.dissimilarity_plain(vals, lo, npos)
        check(kcss.dissim_form(m) == "tiles", f"css_dissim at m = {m} takes the warp form")
        words = int(((npos + 31) // 32).sum())
        for prec in ("fast", "exact"):
            dt = torch.float32 if prec == "fast" else torch.float64
            k = kcss.css_dissim(vals, lo, npos, dt)
            torch.cuda.synchronize()
            diff = abs_err(k, plain64)
            ms = cuda_ms(torch, lambda: kcss.css_dissim(vals, lo_d, npos_d, dt), 3)
            med = median_ms(torch, lambda: kcss.css_dissim(vals, lo_d, npos_d, dt), 5)
            pms = cuda_ms(torch, lambda: kcss.dissimilarity_plain(vals, lo, npos).to(dt), 1)
            bnd = bound(vals.numel() * 2 + B * (16 + m * m * k.element_size()),
                        {"f32": 6 * words * m * (m - 1) // 2})
            say(f"[K3 css_dissim_tiles {tag} {prec}] B={B} windows: max_abs_diff={diff} "
                f"(exact counts); kernel {ms:.4f} ms (mean of 3 calls; median of 5 "
                f"{med:.4f}) plain {pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) on {card}")
            check(diff == 0.0, f"css_dissim {tag} {prec}: counts differ by {diff}")
            results["css_dissim_tiles"][f"{prec}_{m}"] = (diff, diff, ms, pms)
            results["css_dissim_tiles"][f"median_{prec}_{m}"] = med
            results["css_dissim_tiles"][f"bound_{prec}_{m}"] = bnd
            del k
        # the library yardstick, as phase 12's: one torch.bmm of the
        # windows' float32 one-hots [B, m, 2P] @ [B, 2P, m], P the widest
        # window (the gather and the one-hots built beforehand, not timed)
        P = int(npos.max())
        offs = torch.arange(P, device=dev)[None, :]
        idx = torch.where(offs < npos_d[:, None], lo_d[:, None] + offs, lo_d[:, None])
        g = vals[idx]
        A, Bm = onehot_operands(torch, g[..., :a], g[..., a:], npos, P)
        del g, idx
        same = torch.equal(torch.bmm(A, Bm).double(), plain64)
        lib = cuda_ms(torch, lambda: torch.bmm(A, Bm), 3)
        say(f"[K3 library yardstick {tag}] torch.bmm [{B}, {m}, {2 * P}] @ [{B}, {2 * P}, "
            f"{m}] float32 one-hots (not timed: their construction): {lib:.4f} ms; equal to "
            f"the plain counts: {same}")
        check(same, f"torch.bmm of the one-hots at {tag} differs from the plain counts")
        results["css_dissim_tiles"][f"library_{m}"] = lib
        del A, Bm
        torch.cuda.empty_cache()
        # K5 on every window, held to its plain version on the first
        # LARGE_PLAIN_WINDOWS (cuSOLVER's eigh takes ~1.7 ms a matrix here)
        n = min(B, LARGE_PLAIN_WINDOWS)
        r = results["css_cmds_block"]
        for prec in ("fast", "exact"):
            dt = torch.float32 if prec == "fast" else torch.float64
            dis = plain64.to(dt)
            form = kcss.cmds_form(m, dt)
            err = cmds_case(torch, kcss, plain64[:n], npos_d[:n], a, b, prec,
                            f"css_cmds {tag}")
            steps = torch.zeros(B, dtype=torch.int32, device=dev)
            kcss.css_cmds(dis, npos_d, a, b, steps=steps)
            ms_all = cuda_ms(torch, lambda: kcss.css_cmds(dis, npos_d, a, b), 2)
            ms = cuda_ms(torch, lambda: kcss.css_cmds(dis[:n], npos_d[:n], a, b), 2)
            pms = err[3]
            old = OLD_BLOCK_MS.get(("K5", prec, m))
            centred = kcss.double_centre(kcss.fill_averages(dis[:n])[0])
            lib = cuda_ms(torch, lambda: torch.linalg.eigh(centred), 1)
            del centred
            esize, rate = (4, "f32") if prec == "fast" else (8, "f64")
            bnd, bnd_all = (bound(w * (2 * m * m * esize + 8 + esize + 1),
                                  {rate: w * 4 * m**3 // 3}) for w in (n, B))
            say(f"[K5 css_cmds_block {tag} {prec}] form {form}: against the plain version "
                f"on the first {n} windows ({err[2]} excluded by the eigengap): "
                f"max_rel_err={err[1]:.3e}; on those {n}: kernel {ms:.3f} ms, plain "
                f"{pms:.1f} ms, torch.linalg.eigh of the centred matrices {lib:.1f} ms, bound "
                f"{bnd[0]:.3f} ms ({bnd[1]}); on all {B}: kernel {ms_all:.3f} ms (before the "
                f"redesign: {old} ms), bound {bnd_all[0]:.3f} ms; multisection steps mean "
                f"{float(steps.float().mean()):.2f} max {int(steps.max())} on {card}")
            r[f"{prec}_{m}"] = (err[0], err[1], ms, pms)
            r[f"bound_{prec}_{m}"] = bnd
            r[f"windows_{prec}_{m}"] = (n, n)
            r[f"subset_{prec}_{m}"] = {"eigh_ms": lib, "excluded": err[2],
                                       "all_windows": B, "ms_all_windows": ms_all,
                                       "bound_ms_all_windows": bnd_all[0]}
            del dis, steps
        # K7's coefficients, 16 chunks of 256, both draw streams
        key = rng.fold_in(rng.prng_key(5), 2)
        for bitgen in ("mix", "threefry"):
            k = kperm.coeff_range(key, 0, 16, m, a, b, 256, dev, bitgen)
            p = kperm.coeff_range_plain(key, 0, 16, m, a, b, 256, dev, bitgen)
            torch.cuda.synchronize()
            same = torch.equal(k.view(torch.int32), p.view(torch.int32))
            ms = queued_ms(torch, lambda: kperm.coeff_range(key, 0, 16, m, a, b, 256, dev,
                                                             bitgen), 5)
            pms = cuda_ms(torch, lambda: kperm.coeff_range_plain(key, 0, 16, m, a, b, 256, dev,
                                                                 bitgen), 1)
            bnd = bound(k.numel() * 4, {})
            say(f"[K7 css_mc_coeff_block {tag} {bitgen}] 16 chunks of 256, M [{m * m}, "
                f"{k.shape[1]}]: bit-equal {same}; kernel {ms:.4f} ms (calls queued back to "
                f"back) plain {pms:.2f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) on {card}")
            check(same, f"css_mc_coeff_block {tag} {bitgen}: M differs")
            results["css_mc_coeff_block"][f"{bitgen}_{m}"] = (0.0, 0.0, ms, pms)
            results["css_mc_coeff_block"][f"bound_{bitgen}_{m}"] = bnd
            del k, p
        del plain64, vals
        torch.cuda.empty_cache()

        # K6: modes 1 and 2 on the 997 windows of the 10 k workload
        vals, lo, npos, slot = large_cells(torch, a, b, LARGE_CSS_WORKLOAD, dev)
        dis = kcss.dissimilarity_plain(vals, lo, npos)
        key = rng.fold_in(rng.prng_key(0), rng.chrom_hash("_"))   # run_css's default
        npos_d, slot_d = npos.to(dev), slot.to(dev)
        r = results["css_smacof_block"]
        for mds in (1, 2):
            for prec in ("fast", "exact"):
                dt = torch.float32 if prec == "fast" else torch.float64
                out, differ, transforms = smacof_check(
                    torch, kcss, dis, npos_d, a, b, mds, key, slot_d, prec,
                    f"css_smacof_block mds={mds} {tag} ({kcss.smacof_form(m, mds, dt)})",
                    band=large_smacof_band(mds, m),
                    plain_windows=LARGE_SMACOF_PLAIN if prec == "exact" else None,
                    old_ms=OLD_BLOCK_MS.get(("K6", mds, prec, m)))
                r[f"mds{mds}_{prec}_{m}"] = out
                r[f"windows_mds{mds}_{prec}_{m}"] = (
                    dis.shape[0], min(dis.shape[0], LARGE_SMACOF_PLAIN) if prec == "exact"
                    else dis.shape[0])
                r.setdefault("differ", {})[f"mds{mds}_{prec}_{m}"] = differ
                r.setdefault("transforms", {})[f"mds{mds}_{prec}_{m}"] = transforms
                size = 4 if prec == "fast" else 8
                r[f"bound_mds{mds}_{prec}_{m}"] = bound(
                    dis.shape[0] * (2 * m * m * size + 9 + size),
                    {"f32" if prec == "fast" else "f64": smacof_ops(m) * transforms})
        del dis, vals
        torch.cuda.empty_cache()

    # the device-memory paths: 150 + 150 on LARGE_DEVICE_WINDOWS windows
    a, b = LARGE_DEVICE_PANEL
    m = a + b
    vals, lo, npos, slot = large_cells(torch, a, b, LARGE_KERNEL_WORKLOAD, dev)
    lo, npos = lo[:LARGE_DEVICE_WINDOWS], npos[:LARGE_DEVICE_WINDOWS]
    plain64 = kcss.dissimilarity_plain(vals, lo, npos)
    got = kcss.css_dissim(vals, lo, npos, torch.float64)
    check(torch.equal(got, plain64), f"css_dissim {a}+{b}: counts differ")
    forms = {"css_cmds": {}}
    for prec in ("fast", "exact"):
        dt = torch.float32 if prec == "fast" else torch.float64
        forms["css_cmds"][prec] = kcss.cmds_form(m, dt)
        err = cmds_case(torch, kcss, plain64, npos.to(dev), a, b, prec, f"css_cmds {a}+{b}")
        results["css_cmds_block"][f"device_{prec}_{m}"] = err
    key = rng.fold_in(rng.prng_key(5), 2)
    same = torch.equal(kperm.coeff_range(key, 0, 2, m, a, b, 256, dev).view(torch.int32),
                       kperm.coeff_range_plain(key, 0, 2, m, a, b, 256, dev).view(torch.int32))
    check(same, f"css_mc_coeff_block {a}+{b}: M differs")
    say(f"[large panels {a}+{b}] {lo.numel()} windows: css_dissim ({kcss.dissim_form(m)}) "
        f"counts equal; css_cmds forms {forms['css_cmds']} within the CMDS tolerances "
        f"({results['css_cmds_block'][f'device_exact_{m}'][1]:.3e} exact); "
        f"css_mc_coeff ({kperm.coeff_form(m)}) bit-equal")
    del plain64, vals, got
    # K7's coefficients at more panel sizes, chunks and ranges
    checked = []
    for cm, nk, chunk in COEFF_CASES:
        for bitgen in ("mix", "threefry"):
            args = (key, 3, nk, cm, (cm + 1) // 2, cm // 2, chunk, dev, bitgen)
            k = kperm.coeff_range(*args)
            p = kperm.coeff_range_plain(*args)
            check(torch.equal(k.view(torch.int32), p.view(torch.int32)),
                  f"css_mc_coeff_block m = {cm}, {nk} x {chunk} {bitgen}: M differs")
            del k, p
            torch.cuda.empty_cache()
        checked.append(f"m = {cm}: {nk} x {chunk}")
    say(f"[K7 css_mc_coeff_block] bit-equal to the plain version in both draw streams at "
        f"{'; '.join(checked)}")

    # every kernel of the main path on both sides of each shared-memory
    # switch it crosses up to m = 300, the largest panel above, on a few
    # windows of a small chromosome (tests/test_torch_kernels_gpu.py
    # checks every switch, the gathered form's and those above 300 too)
    checked = []
    top = sum(LARGE_DEVICE_PANEL)

    def small(m, limit):
        a, b = (m + 1) // 2, m // 2
        vals, lo, npos, slot = large_cells(torch, a, b, LARGE_SWITCH_WORKLOAD, dev)
        return a, b, vals, lo[:limit], npos[:limit], slot[:limit]

    for lo_m, hi_m in form_switches(kcss.dissim_form, 2, top):
        for m in (lo_m, hi_m):
            a, b, vals, lo, npos, _ = small(m, SWITCH_WINDOWS[0])
            check(torch.equal(kcss.css_dissim(vals, lo, npos, torch.float32).double(),
                              kcss.dissimilarity_plain(vals, lo, npos)),
                  f"css_dissim at m = {m}: counts differ")
            checked.append(f"css_dissim {m} {kcss.dissim_form(m)}")
    for dt, prec in ((torch.float32, "fast"), (torch.float64, "exact")):
        for lo_m, hi_m in form_switches(lambda m: kcss.cmds_form(m, dt), 2, top):
            for m in (lo_m, hi_m):
                a, b, vals, lo, npos, _ = small(m, SWITCH_WINDOWS[1])
                cmds_case(torch, kcss, kcss.dissimilarity_plain(vals, lo, npos),
                          npos.to(dev), a, b, prec, f"css_cmds at m = {m}")
                checked.append(f"css_cmds {prec} {m} {kcss.cmds_form(m, dt)}")
        key = rng.fold_in(rng.prng_key(0), rng.chrom_hash("_"))
        for mds in (1, 2):
            for lo_m, hi_m in form_switches(lambda m: kcss.smacof_form(m, mds, dt), 2, top):
                for m in (lo_m, hi_m):
                    a, b, vals, lo, npos, slot = small(m, SWITCH_WINDOWS[2])
                    smacof_check(torch, kcss, kcss.dissimilarity_plain(vals, lo, npos),
                                 npos.to(dev), a, b, mds, key, slot.to(dev), prec,
                                 f"css_smacof at m = {m}", band=large_smacof_band(mds, m))
                    checked.append(f"css_smacof mds={mds} {prec} {m} "
                                   f"{kcss.smacof_form(m, mds, dt)}")
    key = rng.fold_in(rng.prng_key(5), 2)
    for lo_m, hi_m in form_switches(kperm.coeff_form, 2, top):
        for m in (lo_m, hi_m):
            for bitgen in ("mix", "threefry"):
                args = (key, 1, 2, m, (m + 1) // 2, m // 2, 32, dev, bitgen)
                check(torch.equal(kperm.coeff_range(*args).view(torch.int32),
                                  kperm.coeff_range_plain(*args).view(torch.int32)),
                      f"css_mc_coeff at m = {m} {bitgen}: M differs")
            checked.append(f"css_mc_coeff {m} {kperm.coeff_form(m)}")
    say(f"[large panels, switches] equal to the plain versions on both sides of each "
        f"shared-memory switch: {'; '.join(checked)}")
    results["large_switches"] = checked
    torch.cuda.empty_cache()


def phase_large_library(torch, dev, card, tmp: Path, results) -> None:
    """Phase 16b, the large panels' main path: run_css at its defaults
    (CMDS, the shared stream) with LARGE_MC_RUNS permutations on the 10 k
    workload at 70 + 58 and 110 + 90, both precisions (warm walls,
    windows/s, MC permutations/s, the MC's ranges), with threefry draws,
    and with mds=SMACOF and CMDS_SMACOF at 70 + 58; run_css on the card against run_css on the CPU
    at 70 + 58; run-css and run-all on a 20 k-SNP GTrack pair at 110 + 90,
    run-all's tracks equal to run-css's and to the library's."""
    import numpy as np

    from divergence_tpu_torch import rng
    from divergence_tpu_torch.config import CssConfig, MdsAlgorithm
    from divergence_tpu_torch.core.windows import plan_windows
    from divergence_tpu_torch.engine import SnpPair, run_css, run_fet
    from divergence_tpu_torch.io import read_score_track
    from divergence_tpu_torch.kernels import css as kcss
    from divergence_tpu_torch.kernels import perm as kperm
    from divergence_tpu_torch.tools import cli, synth

    npos_, region, seed = LARGE_CSS_WORKLOAD
    walls = results["large_library"] = {}
    for a, b in LARGE_PANELS:
        m = a + b
        pair = SnpPair(*synth.make_chromosome(npos_, region, a, b, seed))
        modes = [("cmds", {}), ("cmds threefry", {"rng": "threefry"})]
        if (a, b) == LARGE_PANELS[0]:
            modes += [("smacof", {"mds": MdsAlgorithm.SMACOF}),
                      ("cmds+smacof", {"mds": MdsAlgorithm.CMDS_SMACOF})]
        for mode, kw in modes:
            for prec in ("fast", "exact"):
                cfg = CssConfig(precision=prec, mc_runs=LARGE_MC_RUNS, **kw)
                scans = kperm.LAUNCHES["css_mc_scan"]
                (scores, pvals), summary, w = warm_runs(
                    lambda sm: run_css(pair, region, cfg, device=dev, summary=sm))
                ranges = (kperm.LAUNCHES["css_mc_scan"] - scans) // (len(w) + 1)
                c, t = summary.counters, summary.timings_s
                scored = scores != 0
                check(scores.shape == (region // 500,) and not np.isnan(scores).any()
                      and not np.isnan(pvals).any(), f"run_css {a}+{b} {mode} {prec}: shape or NaN")
                check(c["windows_scored"] == int(scored.sum()) > 0, f"run_css {a}+{b}: scored")
                check(bool(((pvals[scored] > 0) & (pvals[scored] <= 1)).all()),
                      f"run_css {a}+{b} {mode} {prec}: p outside (0, 1]")
                best = min(w)
                say(f"[large library {a}+{b} {mode} {prec}] run_css {npos_} SNPs / {region} bp, "
                    f"{LARGE_MC_RUNS} permutations: {c['windows_scored']} windows scored, "
                    f"{c['mc_permutations']} MC permutations; warm wall min {best:.4f} s "
                    f"median {float(np.median(w)):.4f} s; {c['windows_scored'] / best:,.0f} "
                    f"windows/s, {c['mc_permutations'] / best:,.0f} perms/s; {ranges} MC "
                    f"ranges (a host sync each); stages dispatch "
                    f"{t.get('css_dispatch', 0):.4f} s, phase-1 sync "
                    f"{t.get('css_phase1_sync', 0):.4f} s, MC {t.get('css_mc', 0):.4f} s "
                    f"on {card}")
                walls[f"{mode}_{prec}_{m}"] = {
                    "wall_s": best, "windows_per_s": c["windows_scored"] / best,
                    "perms_per_s": c["mc_permutations"] / best, "mc_ranges": ranges}
        del pair

    # the card against the CPU, 70 + 58, a stickleback-shaped panel whose
    # null is hit (windows stop early, so the CPU's plain MC stays short)
    a, b = LARGE_PANELS[0]
    m = a + b
    cpos, cam, cbm = synth.make_panel(*LARGE_CPU_PANEL, a, b, seed=5)
    cpu_region = LARGE_CPU_PANEL[1]
    pair = SnpPair(cpos, cam, cbm)
    plan = plan_windows(cpos, cpu_region, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    lo, npos = (torch.from_numpy(x[ids].copy()) for x in (plan.lo, plan.npos))
    dis = kcss.dissimilarity_plain(pair.to_device(dev), lo, npos)
    gap = np.zeros(cpu_region // 500, dtype=bool)
    gap[plan.slot[ids]] = gap_ok(torch, kcss, dis).cpu().numpy()
    for prec in ("fast", "exact"):
        cfg = CssConfig(precision=prec, mc_runs=LARGE_MC_RUNS, seed=3)
        g_s, g_p = run_css(pair, cpu_region, cfg, device=dev)
        c_s, c_p = run_css(pair, cpu_region, cfg, device="cpu")
        check(np.array_equal(g_s != 0, c_s != 0), f"card vs CPU {prec}: scored windows differ")
        ok = (c_s != 0) & gap
        rel = np.abs(g_s - c_s)[ok] / np.maximum(np.abs(c_s[ok]), 1.0)
        if prec == "exact":
            check(rel.max(initial=0.0) <= TOL_CSS, f"card vs CPU exact: {rel.max()}")
        else:
            check(np.allclose(g_s[ok], c_s[ok], rtol=FAST_RTOL, atol=FAST_ATOL),
                  "card vs CPU fast scores")
        differ = np.nonzero(g_p != c_p)[0]
        if len(differ):   # each a float32 near tie among the permutations
            _, dist, _ = kcss.css_phase1(pair.to_device(dev), lo, npos, a, b,
                                         fast=prec == "fast")
            M = kperm.shared_coeff(rng.fold_in(rng.prng_key(cfg.seed), 2), 0,
                                   -(-LARGE_MC_RUNS // cfg.mc_chunk), m, a, b, cfg.mc_chunk,
                                   dev).double()
            row = {int(s): i for i, s in enumerate(plan.slot[ids])}
            for s in differ:
                obs = float(np.float32(g_s[s]))
                s64 = dist[row[int(s)]].reshape(-1).double() @ M
                tie = float((s64[:LARGE_MC_RUNS] - obs).abs().min()) / max(abs(obs), 1.0)
                check(tie <= TIE_RTOL, f"card vs CPU {prec}: slot {s} p differs without a "
                                       f"near tie ({tie})")
            del M, dist
        n_sc = int((c_s != 0).sum())
        say(f"[large library {a}+{b} card vs CPU {prec}] run_css on {n_sc} windows "
            f"({int((~gap[c_s != 0]).sum())} excluded by the eigengap): scores max_rel_err="
            f"{rel.max(initial=0.0):.3e}; p differs on {len(differ)} windows (allowed "
            f"{int(MC_DIFFER_SHARE * n_sc)}, each a float32 near tie)")
        check(len(differ) <= MC_DIFFER_SHARE * n_sc, f"card vs CPU {prec}: {len(differ)} p differ")
    del pair, dis

    # the CLI at 110 + 90: run-css and run-all, both precisions
    a, b = LARGE_PANELS[1]
    snps, cli_region, cli_seed = LARGE_CLI
    pos, am, bm = synth.make_chromosome(snps, cli_region, a, b, cli_seed)
    a_path, b_path = tmp / "large_popA.gtrack", tmp / "large_popB.gtrack"
    synth.write_gtrack(a_path, "chrI", pos, am)
    synth.write_gtrack(b_path, "chrI", pos, bm)
    sizes = tmp / "large_chrom.sizes"
    sizes.write_text(f"chrI\t{cli_region}\n")
    pair = SnpPair(pos, am, bm)
    inputs = ["--pop-a", str(a_path), "--pop-b", str(b_path), "--chrom-sizes", str(sizes),
              "--device", str(dev)]
    for prec in ("fast", "exact"):
        css_out, out = tmp / f"large_css_{prec}.track", tmp / f"large_all_{prec}"
        t0 = time.perf_counter()
        cli.main(["run-css", *inputs, "--out", str(css_out), "--precision", prec])
        w_css = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli.main(["run-all", *inputs, "--outdir", str(out), "--precision", prec])
        w_all = time.perf_counter() - t0
        args = cli.build_parser().parse_args(["run-all", *inputs, "--outdir", str(out),
                                              "--precision", prec])
        lib = {"fet.track": run_fet(pair, cli_region, cli._fet_config(args), device=dev,
                                    seqid="chrI"),
               "css.track": run_css(pair, cli_region, cli._css_config(args), device=dev,
                                    seqid="chrI")}
        same = {}
        for name, (sc, aux) in lib.items():
            _, starts, tsc, taux = read_score_track(out / name)
            slots = starts // 500
            nz = np.nonzero(sc)[0]
            same[name] = (np.array_equal(slots, nz) and np.array_equal(tsc, sc[nz])
                          and np.array_equal(taux, aux[nz]))
        same["css.track = run-css"] = (out / "css.track").read_bytes() == css_out.read_bytes()
        html = (out / "report.html").read_text()
        _, cstarts, _, cp = read_score_track(out / "css.track")
        say(f"[large cli {a}+{b} {prec}] {snps} SNPs / {cli_region} bp GTrack pair: run-css "
            f"{w_css:.2f} s, run-all {w_all:.2f} s (GTrack parse included), {len(cstarts)} "
            f"CSS rows, p in [{cp.min():.3g}, {cp.max():.3g}]; equal to the library and "
            f"run-css: {same}")
        check(all(same.values()), f"large run-all {prec}: {same}")
        check(len(cstarts) > 0 and bool(((cp > 0) & (cp <= 1)).all()), f"large run-all {prec}")
        check("FET score track" in html and "CSS regions" in html, f"large run-all {prec}: report")
        walls[f"cli_{prec}"] = {"run_css_s": w_css, "run_all_s": w_all}


# ------------------------------------------------------------------ phase 17


def phase_large_mc_kernels(torch, dev, card, results) -> None:
    """Phase 17a-b: K8's large-panel form in its three forms on the
    997-window envelope cell at 70 + 58 and 110 + 90 (the range loop's
    launches to LARGE_MC_RUNS by CUDA events; held to the plain loop on
    the depth cut LARGE_MC_PLAIN) and at 150 + 150 on LARGE_DEVICE_WINDOWS
    windows; K11's and K9's large-panel forms (and K9's shared stream) on
    the 19,997 windows of the 200 k-SNP workload against their plain
    versions (K11 and K9's window stream on a depth cut)."""
    import numpy as np

    from divergence_tpu_torch import rng
    from divergence_tpu_torch.kernels import perm as kperm

    key = rng.fold_in(rng.prng_key(0), 2).to(dev)
    r8 = results["css_mc_window_block"]
    cut_w, cut_runs = LARGE_MC_PLAIN
    cells = [(a, b, LARGE_CSS_WORKLOAD, None, FORMS_17) for a, b in LARGE_PANELS]
    cells.append((*LARGE_DEVICE_PANEL, LARGE_KERNEL_WORKLOAD, LARGE_DEVICE_WINDOWS,
                  FORMS_17[:1]))
    for a, b, workload, limit, forms in cells:
        m = a + b
        dist, scores, chroms, slots = mc_windows(torch, workload, dev, a, b, limit)
        B = dist.shape[0]
        wkeys = rng.window_keys(key, chroms, slots)
        obs = torch.as_tensor(scores).to(dev).float()
        nw = min(B, cut_w if m < 300 else LARGE_MC_PLAIN_300[0])
        runs_cut = cut_runs if m < 300 else LARGE_MC_PLAIN_300[1]
        for form, bitgen, backend in forms:
            native = backend == "native"
            launch_times = lambda: k8_launch_times(  # noqa: E731
                torch, kperm, dist, scores, wkeys, bitgen, native, a, b, LARGE_MC_RUNS,
                "css_mc_window_block")
            launch_times()   # warm-up
            lt = launch_times()
            lt["ranges"], lt["consumed"] = len(lt["ranges"]), int(lt.pop("nsc").sum())
            kern = lambda: kperm.significance(  # noqa: E731
                dist[:nw], scores[:nw], a, b, 10, runs_cut, key, chroms=chroms[:nw],
                slots=slots[:nw], backend=backend, bitgen=bitgen, stream="window")
            kern()
            got, ms = host_ms(torch, kern)
            if native:
                plain = lambda: kperm.mc_native_plain(  # noqa: E731
                    dist[:nw], scores[:nw], wkeys[:nw], a, b, 256, runs_cut, 10)
            else:
                plain = lambda: kperm.mc_significance(  # noqa: E731
                    dist[:nw], scores[:nw], wkeys[:nw], a, b, 256, runs_cut, 10,
                    stream="window", bitgen=bitgen)
            (pv, n, h), pms = host_ms(torch, plain)
            nd = explain_differences(torch, kperm, rng, dist, scores, wkeys, got, n, h, 256,
                                     bitgen, native, a, b, f"K8 large {a}+{b} {form}")
            check(nd <= MC_DIFFER_SHARE * nw + 1, f"css_mc_window_block {a}+{b} {form}: {nd}")
            perms = lt["consumed"]
            bnd = bound(B * (m * m * 4 + 4 + 16 + 8),
                        {t: v * lt["computed"] for t, v in window_ops(form, m, a).items()})
            cut_bnd = bound(nw * (m * m * 4 + 28),
                            {t: v * int(n.sum()) for t, v in window_ops(form, m, a).items()})
            say(f"[K8 css_mc_window_block {a}+{b} {form}] {B} windows to {LARGE_MC_RUNS}: "
                f"launches alone {lt['hits_ms']:.2f} ms (+ css_mc_scan {lt['scan_ms']:.3f}) "
                f"in a {lt['wall_ms']:.1f} ms call, {lt['ranges']} ranges, {lt['computed']} "
                f"permutations computed for {perms} consumed "
                f"({perms / lt['wall_ms'] * 1e3:,.0f} perms/s), bound {bnd[0]:.3f} ms "
                f"({bnd[1]}): "
                f"{pace(lt['hits_ms'], lt['computed'], bnd, OLD_BODY_MS.get(('K8', form, m)))}; "
                f"depth cut {nw} windows to {runs_cut}: kernel {ms:.1f} ms plain "
                f"{pms:.1f} ms (host wall), {nd} windows differ (near ties), form "
                f"{kperm.window_form(m, native)} on {card}")
            r8[f"{form}_{m}"] = (float(np.abs(got.pvals - pv).max()), float(nd), ms, pms)
            r8[f"bound_{form}_{m}"] = cut_bnd
            r8[f"launches_{form}_{m}"] = {**lt, "bound_ms": bnd[0], "bound_by": bnd[1]}
        del dist, wkeys, obs
        torch.cuda.empty_cache()
    mL = sum(LARGE_PANELS[-1])
    r8["fast"], r8["bound"] = r8[f"mix_{mL}"], r8[f"bound_mix_{mL}"]

    # K11 and K9 on the 19,997 windows of the 200 k-SNP workload
    r11, r9 = results["css_perm_chunk_block"], results["css_mc_power_window_block"]
    for a, b in LARGE_PANELS:
        m = a + b
        dist, scores, chroms, slots = mc_windows(torch, LARGE_KERNEL_WORKLOAD, dev, a, b)
        B = dist.shape[0]
        wkeys = rng.window_keys(key, chroms, slots)
        obs = torch.as_tensor(scores).to(dev).float()
        need = torch.full((B,), 10, dtype=torch.int32, device=dev)
        for bitgen in ("mix", "threefry"):
            kern = lambda: kperm.permutation_chunk(  # noqa: E731
                dist, obs, need, PERM_CHUNK, wkeys, a, b, PERM_CHUNK, bitgen)
            k = kern()
            ms = cuda_ms(torch, kern, 3)
            c = min(B, LARGE_CHUNK_PLAIN)
            plain = lambda: kperm.permutation_chunk_plain(  # noqa: E731
                dist[:c], obs[:c], need[:c], PERM_CHUNK, wkeys[:c], a, b, PERM_CHUNK, bitgen)
            p, pms = event_ms(torch, plain)
            nd = int(sum((x[:c].cpu() != y.cpu()).sum() for x, y in zip(k, p)))
            check(nd == 0, f"css_perm_chunk_block {a}+{b} {bitgen}: {nd} outputs differ "
                           f"from the plain version on the first {c} windows")
            cms = cuda_ms(torch, lambda: kperm.permutation_chunk(
                dist[:c], obs[:c], need[:c], PERM_CHUNK, wkeys[:c], a, b, PERM_CHUNK, bitgen), 3)
            ops = {t: v * PERM_CHUNK for t, v in window_ops(bitgen, m, a).items()}
            bnd = bound(B * (m * m * 4 + 4 + 4 + 16 + 9), {t: v * B for t, v in ops.items()})
            cbnd = bound(c * (m * m * 4 + 4 + 4 + 16 + 9), {t: v * c for t, v in ops.items()})
            say(f"[K11 css_perm_chunk_block {a}+{b} {bitgen}] {B} windows x {PERM_CHUNK}: "
                f"kernel {ms:.3f} ms (bound {bnd[0]:.3f} ms, {bnd[1]}): "
                f"{pace(ms, B * PERM_CHUNK, bnd, OLD_BODY_MS.get(('K11', bitgen, m)))}; the first {c} "
                f"windows equal to the plain version: kernel {cms:.3f} ms plain {pms:.1f} ms "
                f"(bound {cbnd[0]:.4f} ms) on {card}")
            r11[f"{bitgen}_{m}"] = (0.0, 0.0, cms, pms)
            r11[f"bound_{bitgen}_{m}"] = cbnd
            r11[f"all_windows_{bitgen}_{m}"] = {"windows": B, "ms": ms, "bound_ms": bnd[0]}
        nperm = B * APPROX_CHUNK * APPROX_CHUNKS
        for stream in ("shared", "window"):
            keys = key if stream == "shared" else wkeys
            c = B if stream == "shared" else min(B, LARGE_POWER_PLAIN)
            kern = lambda: kperm.null_power_sums(  # noqa: E731
                dist, keys, a, b, APPROX_CHUNK, 0, APPROX_CHUNKS, stream)
            kp = kern()
            ms = cuda_ms(torch, kern, 2)
            pk = keys if stream == "shared" else keys[:c]
            pp, pms = event_ms(torch, lambda: kperm.null_power_sums_plain(
                dist[:c], pk, a, b, APPROX_CHUNK, 0, APPROX_CHUNKS, stream))
            prel = power_err(kp[..., :c], pp, APPROX_CHUNK)
            rtol = 1e-12 if stream == "window" else large_power_band(m)
            check(prel <= rtol, f"css_mc_power {stream} {a}+{b}: power sums {prel}")

            def power_bound(nw):
                n = nw * APPROX_CHUNK * APPROX_CHUNKS
                ops = {"f32": 2 * m * m * n} if stream == "shared" else {
                    t: v * n for t, v in window_ops("mix", m, a).items()}
                ops["f64_op"] = 5 * n
                return bound(nw * (m * m * 4 + 16) + APPROX_CHUNKS * 3 * nw * 8, ops)

            bnd = power_bound(B)
            say(f"[K9 css_mc_power {stream} {a}+{b}] {B} windows x {APPROX_CHUNKS} chunks of "
                f"{APPROX_CHUNK}: kernel {ms:.2f} ms (bound {bnd[0]:.3f} ms, {bnd[1]}): "
                f"{pace(ms, nperm, bnd, OLD_BODY_MS.get(('K9', stream, m)))}; power "
                f"sums power_err={prel:.3e} (band {rtol:.3g}) against the plain version on "
                f"{c} windows ({pms:.1f} ms there) on {card}")
            if stream == "window":
                cms = cuda_ms(torch, lambda: kperm.null_power_sums(
                    dist[:c], pk, a, b, APPROX_CHUNK, 0, APPROX_CHUNKS, stream), 3)
                say(f"[K9 css_mc_power window {a}+{b}] the first {c} windows: kernel "
                    f"{cms:.3f} ms plain {pms:.1f} ms")
                r9[f"window_{m}"] = (abs_err(kp[..., :c], pp), prel, cms, pms)
                r9[f"bound_window_{m}"] = power_bound(c)
                r9[f"all_windows_window_{m}"] = {"windows": B, "ms": ms, "bound_ms": bnd[0]}
            else:
                results["css_mc_power"][f"shared_{m}"] = (abs_err(kp, pp), prel, ms, pms)
                results["css_mc_power"][f"bound_shared_{m}"] = bnd
            del kp, pp
        del dist, wkeys, obs
        torch.cuda.empty_cache()
    for name, key_ in ((r11, f"mix_{mL}"), (r9, f"window_{mL}")):
        name["fast"], name["bound"] = name[key_], name["bound_" + key_]


def shared_switch(kperm, lo: int = 65, hi: int = 300) -> int:
    """The largest m in [lo, hi] at which K8's float32 large-panel body
    takes the shared form on this card (the kernel library's own
    reckoning), lo where it takes none."""
    return max((m for m in range(lo, hi + 1) if kperm.window_form(m) == "shared"), default=lo)


def phase_large_mc_sweep(torch, dev, card, results) -> None:
    """Phase 17e: K8's large-panel body (mix, fast) at each m of
    LARGE_SWEEP_M and at the two sides of its shared / split switch (the
    last m of the shared form and the first of the split form), a = 11 m /
    20 rounded, on the envelope cell's windows to LARGE_MC_PLAIN's depth:
    the range loop's launches by CUDA events, in the form the wrapper
    takes; held to the plain loop on LARGE_MC_PLAIN's cut where phase 17a
    has no cell (m < 128).  Time a permutation against m^2 (what the old
    body's rank count and column walk grew with) and a*b (the nonzero
    terms)."""
    from divergence_tpu_torch import rng
    from divergence_tpu_torch.kernels import perm as kperm

    key = rng.fold_in(rng.prng_key(0), 2).to(dev)
    nw, runs = LARGE_MC_PLAIN
    sweep = results["css_mc_window_block"]["sweep"] = {}
    last = shared_switch(kperm)
    for m in sorted(set(LARGE_SWEEP_M) | {last, last + 1}):
        a = (11 * m + 10) // 20
        b = m - a
        dist, scores, chroms, slots = mc_windows(torch, LARGE_CSS_WORKLOAD, dev, a, b)
        B = dist.shape[0]
        wkeys = rng.window_keys(key, chroms, slots)
        f = kperm.window_form(m)
        run = lambda: k8_launch_times(  # noqa: E731
            torch, kperm, dist, scores, wkeys, "mix", False, a, b, runs, "css_mc_window_block")
        run()
        lt = run()
        bnd = bound(B * (m * m * 4 + 28),
                    {t: v * lt["computed"] for t, v in window_ops("mix", m, a).items()})
        ns = lt["hits_ms"] * 1e6 / lt["computed"]
        say(f"[K8 sweep {a}+{b} {f}] {B} windows to {runs}: launches {lt['hits_ms']:.3f} ms "
            f"for {lt['computed']} permutations computed: "
            f"{pace(lt['hits_ms'], lt['computed'], bnd)}; "
            f"{ns / (m * m) * 1e3:.3f} ps per m^2, {ns / (a * b) * 1e3:.3f} ps per a*b "
            f"term, bound {bnd[0]:.3f} ms ({bnd[1]}) on {card}")
        sweep[f"{f}_{m}"] = {"a": a, "b": b, "ms": lt["hits_ms"], "computed": lt["computed"],
                             "ns_per_perm": ns, "bound_ms": bnd[0]}
        if m < LARGE_PANELS[0][0] + LARGE_PANELS[0][1]:
            got = kperm.significance(dist[:nw], scores[:nw], a, b, 10, runs, key,
                                     chroms=chroms[:nw], slots=slots[:nw], stream="window")
            pv, n, h = kperm.mc_significance(dist[:nw], scores[:nw], wkeys[:nw], a, b, 256, runs,
                                             10, stream="window")
            nd = explain_differences(torch, kperm, rng, dist, scores, wkeys, got, n, h, 256,
                                     "mix", False, a, b, f"K8 sweep {a}+{b}")
            check(nd <= MC_DIFFER_SHARE * nw + 1, f"K8 sweep {a}+{b}: {nd} windows differ")
        del dist, wkeys
        torch.cuda.empty_cache()


def phase_large_mc_library(torch, dev, card, tmp: Path, results) -> None:
    """Phase 17b-c, the main path: make_divergence_step at 70 + 58 and
    110 + 90 on the 19,997 windows of the 200 k-SNP workload gathered at P
    = 128 (warm wall; against the step with plain=True on the first
    LARGE_STEP_PLAIN windows); run_css at 110 + 90 with the window stream
    (mix, threefry), the native evaluator and approx mode (both streams)
    on the 997-window envelope cell with LARGE_MC_RUNS permutations (warm
    walls), the card against the CPU on WINDOW_CPU_PANEL; run-css
    --mc-stream window on phase 16's 20 k-SNP GTrack pair."""
    import numpy as np

    from divergence_tpu_torch import rng
    from divergence_tpu_torch.config import CssConfig
    from divergence_tpu_torch.engine import SnpPair, run_css
    from divergence_tpu_torch.parallel import make_divergence_step, make_mesh
    from divergence_tpu_torch.tools import cli, synth

    walls = results["large_mc_library"] = {}
    mesh = make_mesh(devices=[dev])
    for a, b in LARGE_PANELS:
        m = a + b
        npos_, region, seed = LARGE_KERNEL_WORKLOAD
        pos, am, bm = synth.make_chromosome(npos_, region, a, b, seed)
        vals = SnpPair(pos, am, bm).to_device(dev)
        lo, npos, slot = windows_of(torch, pos, region)
        offs = torch.arange(STEP_P, device=dev)[None, :]
        lo_d, npos_d = lo.to(dev), npos.to(dev)
        g = vals[torch.where(offs < npos_d[:, None], lo_d[:, None] + offs, lo_d[:, None])]
        av, bv = g[..., :a].contiguous(), g[..., a:].contiguous()
        del g
        key = rng.prng_key(1)
        step = make_divergence_step(mesh, a, b)
        step(av, bv, npos, slot, key)
        out, ms = host_ms(torch, lambda: step(av, bv, npos, slot, key))
        c = min(lo.numel(), LARGE_STEP_PLAIN)
        want, pms = host_ms(torch, lambda: make_divergence_step(mesh, a, b, plain=True)(
            av[:c], bv[:c], npos[:c], slot[:c], key))
        fet_err = rel_err(out["fet_scores"][:c], want["fet_scores"])
        check(fet_err <= TOL["exact"], f"step {a}+{b}: FET {fet_err}")
        check(torch.equal(out["css_valid"][:c], want["css_valid"]), f"step {a}+{b}: valid")
        css = ((out["css_scores"][:c] - want["css_scores"]).abs()
               / want["css_scores"].abs().clamp(min=1.0))
        beyond = int((css > TOL_CSS).sum())
        hits_differ = int((out["mc_hits"][:c] != want["mc_hits"]).sum())
        say(f"[step {a}+{b}] make_divergence_step on {lo.numel()} windows at P = {STEP_P}: "
            f"warm wall {ms:.1f} ms ({lo.numel() / ms * 1e3:,.0f} windows/s); the first {c} "
            f"against plain=True ({pms:.1f} ms): FET max_rel_err={fet_err:.3e}, CSS beyond "
            f"1e-9 on {beyond} windows, mc_hits differ on {hits_differ} on {card}")
        check(beyond <= 0.01 * c, f"step {a}+{b}: CSS beyond 1e-9 on {beyond} windows")
        check(hits_differ <= 1, f"step {a}+{b}: mc_hits differ on {hits_differ} windows")
        walls[f"step_{m}_ms"] = ms
        del av, bv, vals, out, want
        torch.cuda.empty_cache()

    # run_css at 110 + 90 with the MC options, 997 windows
    a, b = LARGE_PANELS[-1]
    m = a + b
    npos_, region, seed = LARGE_CSS_WORKLOAD
    pair = SnpPair(*synth.make_chromosome(npos_, region, a, b, seed))
    for label, kw in LIBRARY_17:
        cfg = CssConfig(precision="fast", mc_runs=LARGE_MC_RUNS, **kw)
        (scores, pvals), summary, w = warm_runs(
            lambda sm: run_css(pair, region, cfg, device=dev, summary=sm), reps=1)
        cnt = summary.counters
        scored = scores != 0
        check(not np.isnan(scores).any() and not np.isnan(pvals).any()
              and bool(((pvals[scored] > 0) & (pvals[scored] <= 1)).all()),
              f"run_css {a}+{b} {label}: NaN or p outside (0, 1]")
        best = min(w)
        say(f"[large mc library {a}+{b} {label}] run_css {npos_} SNPs / {region} bp, "
            f"{LARGE_MC_RUNS} permutations: {cnt['windows_scored']} windows, "
            f"{cnt['mc_permutations']} permutations; warm wall min {best:.4f} s "
            f"({cnt['mc_permutations'] / best:,.0f} perms/s) on {card}")
        walls[f"{label}_{m}_s"] = best

    # the card against the CPU: p equal but near ties, approx in its band
    cpos, cam, cbm = synth.make_panel(*WINDOW_CPU_PANEL, a, b, seed=5)
    cpair = SnpPair(cpos, cam, cbm)
    for label, kw in LIBRARY_17:
        cfg = CssConfig(precision="exact", mc_runs=MULTI_MC_RUNS, seed=3, **kw)
        g_s, g_p = run_css(cpair, WINDOW_CPU_PANEL[1], cfg, device=dev)
        c_s, c_p = run_css(cpair, WINDOW_CPU_PANEL[1], cfg, device="cpu")
        scored = c_s != 0
        check(np.array_equal(g_s != 0, scored), f"card vs CPU {label}: scored windows differ")
        if kw.get("p_mode") == "approx":
            dl = np.abs(np.log10(g_p[scored]) - np.log10(c_p[scored]))
            worst = float(dl.max(initial=0.0))
            check(worst <= LARGE_LOG10_P_BAND, f"card vs CPU {label}: |dlog10 p| {worst}")
            note = f"max |dlog10 p|={worst:.3e} (band {LARGE_LOG10_P_BAND:g})"
        else:
            differ = int((g_p != c_p).sum())
            check(differ <= MC_DIFFER_SHARE * scored.sum() + 1,
                  f"card vs CPU {label}: p differs on {differ} windows")
            note = f"p differs on {differ} windows"
        say(f"[large mc library {a}+{b} card vs CPU {label}] {int(scored.sum())} windows, "
            f"{MULTI_MC_RUNS} permutations: {note}")

    # the CLI: run-css --mc-stream window on phase 16's GTrack pair
    a_path, b_path = tmp / "large_popA.gtrack", tmp / "large_popB.gtrack"
    sizes = tmp / "large_chrom.sizes"
    check(a_path.exists() and sizes.exists(), "phase 16's GTrack pair is missing")
    out = tmp / "large_css_window.track"
    t0 = time.perf_counter()
    cli.main(["run-css", "--pop-a", str(a_path), "--pop-b", str(b_path), "--chrom-sizes",
              str(sizes), "--device", str(dev), "--out", str(out), "--mc-stream", "window",
              "--mc-runs", str(LARGE_MC_RUNS)])
    w_cli = time.perf_counter() - t0
    rows = [ln for ln in out.read_text().splitlines() if ln and not ln.startswith("#")]
    check(len(rows) > 0, "run-css --mc-stream window wrote no rows")
    say(f"[large mc cli {a}+{b}] run-css --mc-stream window --mc-runs {LARGE_MC_RUNS} on the "
        f"{LARGE_CLI[0]}-SNP GTrack pair: {w_cli:.2f} s, {len(rows)} rows")
    walls["cli_window_s"] = w_cli


def wide_rows(torch, positions, region, wsize, wstep):
    """(lo, npos, slot) host tensors of the valid windows at wsize / wstep."""
    import numpy as np

    from divergence_tpu_torch.core.windows import plan_windows

    plan = plan_windows(positions, region, wsize, wstep)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    return tuple(torch.from_numpy(x[ids].copy()) for x in (plan.lo, plan.npos, plan.slot))


def phase_wide_fet_kernels(torch, kfet, pair, positions, dev, card, results) -> None:
    """Phase 17d, the kernels: the bench FET workload at each of WIDE_FET's
    window widths: K1 -> K2 in both precisions and K1r -> K2r exact against
    their plain versions, K2r = K2 bit for bit (the block and wide bodies
    side by side), timed by CUDA events; K10 on the first WIDE_K10_WINDOWS
    250 kb windows gathered at P = 8,192 and on the first
    WIDE_STEP_WINDOWS 2 Mb windows at P = 65,536 (the wide body), against
    its plain version and K1 -> K2 bit for bit."""
    from divergence_tpu_torch import rng

    vals = pair.to_device(dev)
    maxs, nmax = kfet.support_size(ASIZE, BSIZE), ASIZE + BSIZE + 2
    key = rng.fold_in(rng.prng_key(BENCH_SEED), rng.chrom_hash("chrB"))
    ragg, rr, rw = (results[k] for k in ("fet_aggregate_wide", "fet_aggregate_ranks_wide",
                                         "fet_window_wide"))
    for wi, (wsize, wstep) in enumerate(WIDE_FET):
        lo, npos, slot = wide_rows(torch, positions, BENCH_REGION, wsize, wstep)
        B = lo.numel()
        P = kfet._window_pad(int(npos.max()))
        lo_d, npos_d, slot_d = lo.to(dev), npos.to(dev), slot.to(dev)
        ls, ranks = kfet.fet_snp_ranks(vals, ASIZE, maxs, nmax, False)
        for prec in ("fast", "exact"):
            fast = prec == "fast"
            logs = kfet.fet_snp_logs(vals, ASIZE, maxs, nmax, fast)
            kern = lambda: kfet.fet_aggregate(  # noqa: E731
                logs, lo_d, npos_d, slot_d, key, 0.95, 100)
            k = kern()
            ms = cuda_ms(torch, kern, 3)
            if not fast:
                kr = lambda: kfet.fet_aggregate_ranks(  # noqa: E731
                    ls, ranks, lo_d, npos_d, slot_d, key, 0.95, 100)
                got = kr()
                check(torch.equal(got, k), f"K2r {wsize}: not equal to K1 -> K2")
                if (prec, wi) in WIDE_PLAIN["fet_aggregate_ranks"]:
                    rms = cuda_ms(torch, kr, 3)
                    n = min(B, WIDE_PLAIN_WINDOWS)
                    rp, rpms = event_ms(torch, lambda: kfet.fet_aggregate_ranks_plain(
                        ls, ranks, lo[:n], npos[:n], slot[:n], key, 0.95, 100))
                    rerr = rel_err(got[0][:n], rp[0])
                    rform = kfet.window_form(P, 100, 4, 8)
                    rbytes = int(npos.sum()) * 4 + B * 40 + ls.numel() * 8
                    rbnd = bound(rbytes, bootstrap_ops(npos.numpy(), 0.95, 100, False,
                                                       sort=rform != "wide"))
                    rold = bound(rbytes, old_reckoning(npos.numpy(), 0.95, 100, False))
                    say(f"[K2r fet_aggregate_ranks exact, {wsize} / {wstep}] the {rform} "
                        f"body: equal to K1 -> K2 on every window, score max_rel_err "
                        f"{rerr:.3e} against its plain version on the first {n}; kernel "
                        f"{rms:.3f} ms ({B} windows) plain {rpms:.1f} ms ({n}), bound "
                        f"{rbnd[0]:.3f} ms ({rbnd[1]}; the old reckoning {rold[0]:.3f}) on "
                        f"{card}")
                    check(rerr <= TOL["exact"], f"K2r {wsize}: scores {rerr}")
                    rr[f"exact_{wsize}"] = (abs_err(got[:, :n], rp), rel_err(got[:, :n], rp),
                                            rms, rpms)
                    rr[f"bound_exact_{wsize}"] = rbnd
                    rr[f"windows_exact_{wsize}"] = (B, n)
                    rr[f"form_exact_{wsize}"] = rform
                    del rp
                del got
            if (prec, wi) not in WIDE_PLAIN["fet_aggregate"]:
                say(f"[K2 fet_aggregate {prec}, {wsize} / {wstep}] {B} windows (P = {P}): "
                    f"kernel {ms:.3f} ms on {card}")
                continue
            n = min(B, WIDE_PLAIN_WINDOWS)
            p, pms = event_ms(torch, lambda: kfet.fet_aggregate_plain(
                logs, lo[:n], npos[:n], slot[:n], key, 0.95, 100))
            kn = k[:, :n]
            sc_err, sd_rel = rel_err(kn[0], p[0]), (kn[1].double() - p[1].double()).abs() / \
                p[1].double().abs().clamp(min=1.0)
            beyond = int((sd_rel > TOL[prec]).sum())
            bits = int((float_bits(torch, kn) != float_bits(torch, p)).sum())
            size = 4 if fast else 8
            form = kfet.window_form(P, 100, size, size)
            nbytes = int(npos.sum()) * size + B * (24 + 2 * size)
            bnd = bound(nbytes, bootstrap_ops(npos.numpy(), 0.95, 100, fast,
                                              sort=form != "wide"))
            old_bnd = bound(nbytes, old_reckoning(npos.numpy(), 0.95, 100, fast))
            say(f"[K2 fet_aggregate {prec}, {wsize} / {wstep}] {B} windows, max "
                f"{int(npos.max())} SNPs (P = {P}, the {form} body): score max_rel_err="
                f"{sc_err:.3e}, stddev beyond {TOL[prec]:g} on {beyond}, {bits} of {2 * n} "
                f"values of the first {n} windows not bit-equal to the plain version; kernel "
                f"{ms:.3f} ms ({B} windows) plain {pms:.1f} ms ({n}), bound {bnd[0]:.3f} ms "
                f"({bnd[1]}; the old reckoning {old_bnd[0]:.3f} ms) on {card}")
            check(sc_err <= TOL[prec], f"K2 {prec} {wsize}: scores {sc_err}")
            check(beyond <= STDDEV_BEYOND_SHARE * n + 1, f"K2 {prec} {wsize}: stddev {beyond}")
            tag = f"{prec}_{wsize}"
            ragg[tag] = (abs_err(kn, p), max(sc_err, float(sd_rel.max())), ms, pms)
            ragg[f"bound_{tag}"] = bnd
            ragg[f"windows_{tag}"] = (B, n)
            ragg[f"form_{tag}"] = form
            del logs, k, p
        del ls, ranks
        # K10 (the wide body) on the first WIDE_K10_WINDOWS of the narrowest
        # width's windows and on the first WIDE_STEP_WINDOWS of the
        # widest's; K1 -> K2 bit for bit
        if wsize in (WIDE_FET[0][0], WIDE_FET[-1][0]):
            narrow = wsize == WIDE_FET[0][0]
            c = min(B, WIDE_K10_WINDOWS if narrow else WIDE_STEP_WINDOWS)
            offs = torch.arange(P, device=dev)[None, :]
            g = vals[torch.where(offs < npos_d[:c, None], lo_d[:c, None] + offs,
                                 lo_d[:c, None])]
            av, bv = g[..., :ASIZE].contiguous(), g[..., ASIZE:].contiguous()
            del g
            for prec in ("fast", "exact") if narrow else ("exact",):
                fast = prec == "fast"
                want = kfet.fet_aggregate(kfet.fet_snp_logs(vals, ASIZE, maxs, nmax, fast),
                                          lo_d[:c], npos_d[:c], slot_d[:c], key, 0.95, 100)
                k10 = lambda: kfet.fet_window_batch(  # noqa: E731
                    av, bv, npos[:c], 0.95, key, 100, maxs, nmax, fast, slot[:c])
                s10, d10 = k10()
                check(torch.equal(s10, want[0]) and torch.equal(d10, want[1]),
                      f"K10 {prec} at P = {P}: not K1 -> K2 bit for bit")
                ms10 = cuda_ms(torch, k10, 3)
                n = min(c, WIDE_K10_PLAIN)
                (ps, pd), pms10 = event_ms(torch, lambda: kfet.fet_window_batch_plain(
                    av[:n], bv[:n], npos[:n], 0.95, key, 100, maxs, nmax, fast, slot[:n]))
                s10, d10 = s10[:n], d10[:n]
                err = max(rel_err(s10, ps), rel_err(d10, pd))
                size = 4 if fast else 8
                form = kfet.window_form(P, 100, size, size)
                b10 = k10_bound(kfet, npos[:c], fast, sort=form != "wide")
                say(f"[K10 fet_window {prec}, {wsize} / {wstep}] the first {c} windows "
                    f"gathered at P = {P} ({(av.numel() + bv.numel()) * 2 / 1e9:.2f} GB of "
                    f"codes), the {form} body: K1 -> K2 bit for bit, max_rel_err {err:.3e} "
                    f"against the plain version on the first {n}; kernel {ms10:.3f} ms plain "
                    f"{pms10:.1f} ms ({n} windows), bound {b10[0]:.3f} ms on {card}")
                check(rel_err(s10, ps) <= TOL[prec], f"K10 {prec} at P = {P}: {err}")
                target = results["fet_window"] if narrow else rw
                target[f"{prec}_{wsize}"] = (abs_err(s10, ps), err, ms10, pms10)
                target[f"bound_{prec}_{wsize}"] = b10
                target[f"windows_{prec}_{wsize}"] = (c, n)
            del av, bv
        torch.cuda.empty_cache()
    # the kernels line: the wide bodies' cases (K2 fast at 2 Mb, exact at
    # 1 Mb; K2r and K10 exact at 2 Mb, under fast as the entry's first),
    # with the windows the kernel's and the plain version's times cover
    w1, w2 = WIDE_FET[1][0], WIDE_FET[-1][0]
    ragg["fast"], ragg["bound"] = ragg[f"fast_{w2}"], ragg[f"bound_fast_{w2}"]
    ragg["exact"], ragg["bound_exact"] = ragg[f"exact_{w1}"], ragg[f"bound_exact_{w1}"]
    ragg["windows"], ragg["windows_exact"] = ragg[f"windows_fast_{w2}"], ragg[f"windows_exact_{w1}"]
    for r in (rr, rw):
        r["fast"], r["bound"] = r[f"exact_{w2}"], r[f"bound_exact_{w2}"]
        r["windows"] = r[f"windows_exact_{w2}"]
    del vals
    torch.cuda.empty_cache()


def phase_wide_fet_edges(torch, kfet, dev, card, results) -> None:
    """Phase 17d, the wide body's edge cases, on WIDE_EDGE_WINDOWS windows
    of n in (P / 2, P] SNPs at P = WIDE_EDGE_P over synthetic per-SNP
    scores (a third zeros, one +inf, the rest exponential): a tie-heavy
    cell (97 % zeros), every band sorted in device scratch (band_keys = 0:
    the bytes of the shared-memory band), 37 samples, perc 0.5 and 0.999,
    and windows of 1, 2 and 40 SNPs among the wide ones.  K2 within TOL of
    its plain version (the windows whose score or stddev is not finite
    byte for byte); K2r on the scores' ranks into their sorted distinct
    values equal to K2 byte for byte."""
    import numpy as np

    from divergence_tpu_torch import rng

    key = rng.fold_in(rng.prng_key(9), rng.chrom_hash("chrE"))
    P, B = WIDE_EDGE_P, WIDE_EDGE_WINDOWS
    out = results["fet_aggregate_wide"].setdefault("edges", {})
    for prec in ("fast", "exact"):
        dt = torch.float32 if prec == "fast" else torch.float64
        zero = 0.0 if prec == "fast" else -0.0   # the sign K1 gives a zero score
        for case in ("ties", "forced_band", "nsamples37", "perc0.5", "perc0.999", "small_n"):
            rs = np.random.default_rng(len(case) + (prec == "fast"))
            N = 3 * P
            share = 0.97 if case == "ties" else 0.33
            x = np.where(rs.random(N) < share, zero, rs.exponential(size=N))
            x[N // 2] = np.inf
            logs = torch.from_numpy(x).to(dt).to(dev)
            npos = rs.integers(P // 2 + 1, P + 1, size=B)
            npos[0] = P
            if case == "small_n":
                npos[1:4] = (1, 2, 40)
            lo = torch.from_numpy(rs.integers(0, N - npos + 1))
            npos = torch.from_numpy(npos)
            slot = torch.arange(B, dtype=torch.int64) * 3 + 1
            perc = float(case[4:]) if case.startswith("perc") else 0.95
            ns = 37 if case == "nsamples37" else 100
            form = kfet.window_form(P, ns, dt.itemsize, dt.itemsize)
            k2 = kfet.fet_aggregate(logs, lo, npos, slot, key, perc, ns)
            p = kfet.fet_aggregate_plain(logs, lo, npos, slot, key, perc, ns)
            # a window that holds the +inf score: its non-finite values byte for byte
            fin = torch.isfinite(p).all(dim=0)
            err = rel_err(k2[0][fin], p[0][fin])
            same = torch.equal(k2[:, ~fin].contiguous().view(torch.uint8),
                               p[:, ~fin].contiguous().view(torch.uint8))
            sd_rel = (k2[1][fin].double() - p[1][fin].double()).abs() / \
                p[1][fin].double().abs().clamp(min=1.0)
            beyond = int((sd_rel > TOL[prec]).sum())
            if case == "forced_band":
                forced = kfet.fet_aggregate(logs, lo, npos, slot, key, perc, ns, band_keys=0)
                same &= torch.equal(forced.view(torch.uint8), k2.view(torch.uint8))
            lut, ranks = torch.unique(logs, sorted=True, return_inverse=True)
            k2r = kfet.fet_aggregate_ranks(lut.contiguous(), ranks.to(torch.int32).contiguous(),
                                           lo, npos, slot, key, perc, ns,
                                           band_keys=0 if case == "forced_band" else None)
            same_r = torch.equal(k2r.view(torch.uint8), k2.view(torch.uint8))
            say(f"[K2 / K2r wide body, {case} {prec}] {B} windows at P = {P} ({form}): "
                f"score max_rel_err {err:.3e} against the plain version, stddev beyond "
                f"{TOL[prec]:g} on {beyond}, K2r = K2 bytes {same_r}"
                + f", {int((~fin).sum())} windows with the +inf score equal byte for byte "
                f"{same}" + f" on {card}")
            check(form == "wide", f"K2 edge {case} {prec}: the {form} body, not the wide one")
            check(err <= TOL[prec] and beyond <= 1, f"K2 edge {case} {prec}: {err}, {beyond}")
            check(same and same_r, f"K2 / K2r edge {case} {prec}: bytes differ")
            out[f"{case}_{prec}"] = (err, beyond)
            del logs, k2, p, k2r


def phase_wide_fet_library(torch, pair, positions, dev, card, results) -> None:
    """Phase 17d, the main path: run_fet on the bench FET workload at each
    of WIDE_FET's widths in both precisions (warm wall), and the sharded
    step on WIDE_STEP_WINDOWS of the 1 Mb windows gathered at P = 32,768
    (K10's wide body, float64), its FET outputs equal to K1 -> K2."""
    import numpy as np

    from divergence_tpu_torch import rng
    from divergence_tpu_torch.config import FetConfig, WindowConfig
    from divergence_tpu_torch.engine import run_fet
    from divergence_tpu_torch.kernels import fet as kfet
    from divergence_tpu_torch.parallel import make_divergence_step, make_mesh

    walls = results["wide_fet_library"] = {}
    for wsize, wstep in WIDE_FET:
        for prec in ("fast", "exact"):
            cfg = FetConfig(window=WindowConfig(wsize=wsize, wstep=wstep), precision=prec)
            run = lambda: run_fet(pair, BENCH_REGION, cfg, device=dev, seqid="chrB")  # noqa: E731
            run()
            w = []
            for _ in range(3):
                t0 = time.perf_counter()
                sc, sd = run()
                w.append(time.perf_counter() - t0)
            check(sc.shape == (BENCH_REGION // wstep,) and not np.isnan(sc).any()
                  and (sc != 0).sum() > 0, f"run_fet {wsize} {prec}: shape, NaN or empty")
            say(f"[wide fet library {wsize} / {wstep} {prec}] run_fet {BENCH_SNPS} SNPs: "
                f"{int((sc != 0).sum())} windows, warm wall min {min(w):.4f} s on {card}")
            walls[f"{prec}_{wsize}_s"] = min(w)
    # the step on wide windows: K10's wide body
    wsize, wstep = WIDE_FET[1]
    lo, npos, slot = wide_rows(torch, positions, BENCH_REGION, wsize, wstep)
    lo, npos, slot = lo[:WIDE_STEP_WINDOWS], npos[:WIDE_STEP_WINDOWS], slot[:WIDE_STEP_WINDOWS]
    P = kfet._window_pad(int(npos.max()))
    vals = pair.to_device(dev)
    offs = torch.arange(P, device=dev)[None, :]
    lo_d, npos_d = lo.to(dev), npos.to(dev)
    g = vals[torch.where(offs < npos_d[:, None], lo_d[:, None] + offs, lo_d[:, None])]
    av, bv = g[..., :ASIZE].contiguous(), g[..., ASIZE:].contiguous()
    del g
    key = rng.prng_key(1)
    step = make_divergence_step(make_mesh(devices=[dev]), ASIZE, BSIZE)
    out, ms = host_ms(torch, lambda: step(av, bv, npos, slot, key))
    maxs, nmax = kfet.support_size(ASIZE, BSIZE), ASIZE + BSIZE + 2
    want = kfet.fet_aggregate(kfet.fet_snp_logs(vals, ASIZE, maxs, nmax, False), lo_d, npos_d,
                              slot.to(dev), rng.fold_in(key, 0), 0.95, 100)
    same = (torch.equal(out["fet_scores"], want[0])
            and torch.equal(out["fet_stddev"], want[1]))
    say(f"[wide step] make_divergence_step on {lo.numel()} windows of {wsize} bp gathered at "
        f"P = {P} (K10's {kfet.window_form(P, 100, 8, 8)} body): {ms:.1f} ms; FET equal to "
        f"K1 -> K2 bit for bit: {same}")
    check(same, "the wide step's FET differs from K1 -> K2")
    walls["step_wide_ms"] = ms
    del av, bv, vals


def phase_ingest(torch, dev, tmp: Path, files, results) -> dict:
    """Phase 18: the ingestion path and the remaining tools at full width.
    (a) a VCF of phase 3's 500 k-SNP / 25 Mbp chromosome (11 + 10, 21
    sample columns); (b) ``convert-vcf`` per population by the native
    converter, byte-equal to the Python ``_convert_stream`` on the first
    INGEST_PY_SNPS SNPs, and ``run-fet`` (fast) on the converted pair,
    its score lines byte-equal to phase 3's; (c) ``read_gtrack_points`` on
    phase 3's files, native (each, and both at once as ``_load_pairs``
    reads them) and the Python reader on one, s per 10 M rows; (d)
    phase 15's ``run-all`` walls and stage split beside those the Python
    reader gave (RUN_ALL_PYTHON_PARSE_S) and which parser it took, with the host's share outside the
    engines (``_load_pairs``; the region callers and the report); (e) ``doctor`` as a subprocess; (f)
    ``bench-mc`` at its defaults on INGEST_MC_BACKENDS, then the same on
    a 64-window cut, on the card and on the CPU (the plain versions),
    checksums equal; (g) ``convert-snp-table`` on a small table against
    its expected rows.  The launch counts are reset before (b) and read
    after (f)'s run at the defaults; returns them."""
    import argparse
    import contextlib
    import io
    import threading

    import numpy as np

    from divergence_tpu_torch.io import gtrack, read_gtrack_points
    from divergence_tpu_torch.io.vcf import _convert_stream
    from divergence_tpu_torch.kernels import css as kcss
    from divergence_tpu_torch.kernels import fet as kfet
    from divergence_tpu_torch.kernels import perm as kperm
    from divergence_tpu_torch.native import library_path, native_available
    from divergence_tpu_torch.tools import cli, synth
    from divergence_tpu_torch.tools.bench_mc import run_mc_bench

    a_path, b_path, sizes = files
    check(native_available(), "the native host library did not build")
    say(f"[ingest] native host library {library_path().name}")

    # (a) the VCF of phase 3's chromosome
    t0 = time.perf_counter()
    pos, am, bm = synth.make_panel(CLI_SNPS, CLI_REGION, ASIZE, BSIZE, seed=5)
    vcf = tmp / "cli.vcf"
    names = synth.write_vcf(vcf, "chrI", pos, am, bm)
    say(f"[ingest vcf] wrote {CLI_SNPS} SNPs x {len(names)} samples, "
        f"{vcf.stat().st_size / 1e6:.1f} MB in {time.perf_counter() - t0:.2f} s")

    # (b) convert-vcf per population, then run-fet on the converted pair
    for mod in (kfet, kcss, kperm):
        mod.reset_launches()
    groups = {"A": names[:ASIZE], "B": names[ASIZE:]}
    conv, walls = {}, {}
    for g, members in groups.items():
        conv[g] = tmp / f"vcf_pop{g}.gtrack"
        t0 = time.perf_counter()
        cli.main(["convert-vcf", "--vcf", str(vcf), "--population", ",".join(members),
                  "--out", str(conv[g])])
        walls[f"convert_{g}"] = time.perf_counter() - t0
    head, n_data = [], 0
    with open(vcf) as fh:
        for line in fh:
            head.append(line)
            n_data += not line.startswith("#")
            if n_data == INGEST_PY_SNPS:
                break
    same_py = {}
    for g, members in groups.items():
        ref = io.StringIO()
        ref.write(gtrack.gtrack_points_header("unknown"))
        check(_convert_stream(io.StringIO("".join(head)), members, ref) == members,
              f"_convert_stream population {g}")
        want = ref.getvalue().encode()
        with open(conv[g], "rb") as fh:
            same_py[g] = fh.read(len(want)) == want
    say(f"[ingest convert-vcf] native converter {walls['convert_A']:.3f} / "
        f"{walls['convert_B']:.3f} s (A / B, {CLI_SNPS} SNPs); first {INGEST_PY_SNPS} SNPs "
        f"byte-equal to the Python _convert_stream {same_py}")
    check(all(same_py.values()), f"convert-vcf differs from _convert_stream: {same_py}")
    out = tmp / "vcf_fet_fast.track"
    t0 = time.perf_counter()
    cli.main(["run-fet", "--pop-a", str(conv["A"]), "--pop-b", str(conv["B"]), "--out", str(out),
              "--chrom-sizes", str(sizes), "--device", str(dev)])
    walls["run_fet"] = time.perf_counter() - t0

    def score_lines(path):
        return [ln for ln in path.read_text().splitlines() if not ln.startswith("#")]

    got, want = score_lines(out), score_lines(tmp / "fet_fast.track")
    say(f"[ingest run-fet] on the converted pair: {len(got)} score lines, byte-equal to "
        f"phase 3's run-fet on the write_gtrack pair: {got == want}; wall "
        f"{walls['run_fet']:.2f} s")
    check(len(got) > 0 and got == want, "run-fet on the converted pair differs from phase 3's")

    # (c) the parse alone on phase 3's files
    gtrack.PARSES.update(native=0, python=0)
    rows = {}
    for name, path in (("A", a_path), ("B", b_path)):
        t0 = time.perf_counter()
        tracks = read_gtrack_points(path)
        walls[f"native_{name}"] = time.perf_counter() - t0
        rows[name] = len(tracks["chrI"].pos)
    both = {}
    t0 = time.perf_counter()
    th = threading.Thread(target=lambda: both.update(b=read_gtrack_points(b_path)))
    th.start()
    both["a"] = read_gtrack_points(a_path)
    th.join()
    walls["native_both"] = time.perf_counter() - t0
    native_parses = dict(gtrack.PARSES)
    t0 = time.perf_counter()
    py = gtrack._group_rows_indexed(*gtrack._read_rows_chunked(a_path))
    walls["python_A"] = time.perf_counter() - t0
    same = (np.array_equal(py["chrI"].pos, both["a"]["chrI"].pos)
            and np.array_equal(py["chrI"].vals, both["a"]["chrI"].vals))
    per10m = {k: walls[k] / rows[k[-1]] * 1e7 for k in ("native_A", "native_B", "python_A")}
    per10m["native_both"] = walls["native_both"] / (rows["A"] + rows["B"]) * 1e7
    say(f"[ingest parse] {rows['A']} + {rows['B']} rows: native {walls['native_A']:.3f} / "
        f"{walls['native_B']:.3f} s, both at once {walls['native_both']:.3f} s, Python reader "
        f"(A) {walls['python_A']:.3f} s ({walls['python_A'] / walls['native_A']:.1f}x); s per "
        f"10 M rows {json.dumps({k: round(v, 4) for k, v in per10m.items()})}; native parses "
        f"{native_parses}; arrays equal to the Python reader's {same}")
    check(native_parses == {"native": 4, "python": 0}, f"the parse fell back: {native_parses}")
    check(same, "the native parse differs from the Python reader")

    # (d) phase 15's run-all, parsed natively
    ra = results["run_all_walls_s"]
    for prec in ("fast", "exact"):
        split = ra[f"split_{prec}"]
        engines = sum(split[n].get("device_init", 0.0) + split[n]["chrI"] for n in split)
        say(f"[ingest run-all {prec}] wall {ra[prec]:.2f} s (with the Python reader: "
            f"{RUN_ALL_PYTHON_PARSE_S[prec]} s); engines {engines:.2f} s, the rest (parse, align, "
            f"upload, regions, report) {ra[prec] - engines:.2f} s; split {split}")
    check(ra["parses"]["python"] == 0 and ra["parses"]["native"] > 0,
          f"phase 15's run-all did not parse natively: {ra['parses']}")
    # the host's share of run-all outside the engines: the load (both
    # parses at once and the alignment) and the region callers + report
    t0 = time.perf_counter()
    cli._load_pairs(argparse.Namespace(pop_a=str(a_path), pop_b=str(b_path),
                                       chrom_sizes=str(sizes)))
    walls["load_pairs"] = time.perf_counter() - t0
    done, redo = tmp / "all_fast", tmp / "all_fast_regions"
    redo.mkdir()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["filter-fet", "--scores", str(done / "fet.track"), "--out",
                  str(redo / "fet_regions.gtrack"), "--chrom-sizes", str(sizes)])
        cli.main(["call-css-regions", "--scores", str(done / "css.track"), "--out",
                  str(redo / "css_regions.gtrack"), "--chrom-sizes", str(sizes)])
        cli.main(["report", "--fet-track", str(done / "fet.track"), "--css-track",
                  str(done / "css.track"), "--fet-regions", str(redo / "fet_regions.gtrack"),
                  "--css-regions", str(redo / "css_regions.gtrack"), "--run-summary",
                  str(done / "fet_summary.json"), "--out", str(redo / "report.html")])
    walls["regions_report"] = time.perf_counter() - t0
    say(f"[ingest run-all] outside the engines: _load_pairs (both parses at once, the "
        f"alignment) {walls['load_pairs']:.3f} s, both region callers and the report "
        f"{walls['regions_report']:.3f} s")

    # (e) doctor in its own process
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "divergence_tpu_torch.tools.cli", "doctor", "--timeout", "120"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=False,
    )
    check(proc.returncode == 0, f"doctor failed: {proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout)
    probe, cache = doc["default_backend_probe"], doc["compile_cache"]
    say(f"[ingest doctor] {time.perf_counter() - t0:.1f} s: torch {doc['torch']} CUDA "
        f"{doc['torch_cuda']}; devices {probe}; nvidia-smi {doc['nvidia_smi']}; nvcc "
        f"{doc['nvcc']}; kernel library built {cache.get('kernel_library_built')} "
        f"({cache.get('entries')} entries); native_parser {doc['native_parser']}; cpu "
        f"{doc['cpu_compute']}")
    check(probe.get("ok") and probe.get("platform") == "cuda" and probe.get("n", 0) >= 1
          and probe.get("kind") == torch.cuda.get_device_name(0), f"doctor: devices {probe}")
    check(doc["nvcc"].get("ok") is True, f"doctor: nvcc {doc['nvcc']}")
    check(cache.get("kernel_library_built") is True, f"doctor: kernel cache {cache}")
    check(doc["native_parser"] is True, f"doctor: native_parser {doc.get('native_error')}")
    check(doc["nvidia_smi"].get("ok") is True, f"doctor: nvidia-smi {doc['nvidia_smi']}")

    # (f) bench-mc at its defaults, then a 64-window cut against the plain
    # versions
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["bench-mc", "--backends", ",".join(INGEST_MC_BACKENDS), "--device", str(dev)])
    walls["bench_mc"] = time.perf_counter() - t0
    bench = json.loads(buf.getvalue())
    launches = {**kfet.LAUNCHES, **kcss.LAUNCHES, **kperm.LAUNCHES}
    say(f"[ingest bench-mc] defaults ({walls['bench_mc']:.1f} s): {json.dumps(bench)}")
    say(f"[phase 18 main path] kernel launches: {launches}")
    errors = {k: bench[k]["error"] for k in INGEST_MC_BACKENDS if "error" in bench[k]}
    check(not errors, f"bench-mc variants failed: {errors}")
    check(all(launches[k] > 0 for k in INGEST_PATH),
          f"phase 18's path did not launch every kernel: {launches}")
    cut = {d: run_mc_bench(window_batch=INGEST_MC_CUT, backends=INGEST_MC_BACKENDS, device=d)
           for d in (dev, "cpu")}
    sums = {k: (cut[dev][k]["checksum"], cut["cpu"][k]["checksum"]) for k in INGEST_MC_BACKENDS}
    say(f"[ingest bench-mc] {INGEST_MC_CUT}-window cut, checksums card / plain: {sums}")
    check(all(a == b for a, b in sums.values())
          and all(cut[dev][k].get("nscores") == cut["cpu"][k].get("nscores")
                  for k in INGEST_MC_BACKENDS),
          f"bench-mc checksums differ from the plain versions: {sums}")

    # (g) convert-snp-table
    table = tmp / "snps.tsv"
    table.write_text(
        "#seqid\tpos\tallele1\tallele2\tfish0\tfish1\tfish2\n"
        "chrI\t100\tA\tG\tAA\tAG\tGG\n"
        "chrI\t200\tC\tT\tCC\tNN\tTC\n"
    )
    cli.main(["convert-snp-table", "--table", str(table), "--ids", "fish0,fish1,fish2",
              "--out", str(tmp / "snps.gtrack")])
    got = [ln for ln in (tmp / "snps.gtrack").read_text().splitlines()
           if ln and not ln.startswith("#")]
    say(f"[ingest convert-snp-table] rows {got}")
    check(got == SNP_TABLE_ROWS, "convert-snp-table rows differ")
    results["ingest"] = {"walls_s": walls, "rows": rows, "s_per_10m_rows": per10m,
                         "bench_mc": bench}
    return launches


def large_entries(results) -> None:
    """The kernels line's fast / exact / bound fields of the large-panel
    kernels at 110 + 90 (K6: mode 1), with the windows each time covers
    where the kernel and its plain version ran on different counts, and
    each one's every case under ``large``."""
    m = sum(LARGE_PANELS[1])
    for name, fast, exact in (
            ("css_dissim_tiles", f"fast_{m}", f"exact_{m}"),
            ("css_cmds_block", f"fast_{m}", f"exact_{m}"),
            ("css_smacof_block", f"mds1_fast_{m}", f"mds1_exact_{m}"),
            ("css_mc_coeff_block", f"mix_{m}", None)):
        r = results[name]
        r["large"] = dict(r)
        r["fast"], r["bound"] = r[fast], r["bound_" + fast]
        if "windows_" + fast in r:
            r["windows"] = r["windows_" + fast]
        if exact:
            r["exact"], r["bound_exact"] = r[exact], r["bound_" + exact]
            if "windows_" + exact in r:
                r["windows_exact"] = r["windows_" + exact]


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
    phase_build(_build, results)
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
        power_by_stream = dict(kperm.POWER_LAUNCHES)
        say(f"[CSS main path, phase-2 options] kernel launches: {window_launches}; "
            f"css_mc_coeff by draw stream: {coeff_by_bitgen}; K9 by stream: {power_by_stream}")
        check(window_launches["css_mc_window"] > 0 and window_launches["css_mc_scan"] > 0
              and window_launches["css_mc_power"] > 0 and coeff_by_bitgen["threefry"] > 0
              and all(v > 0 for v in power_by_stream.values()),
              f"the phase-2 options did not launch K8, K9 in both streams and threefry K7: "
              f"{window_launches}, {coeff_by_bitgen}, {power_by_stream}")
        launches["css_mc_window"] = window_launches["css_mc_window"]
        launches["css_mc_power"] = window_launches["css_mc_power"]
        launches["css_mc_power_window"] = power_by_stream["window"]
        results["css_mc_power"]["launches_by_stream"] = power_by_stream

        gathered = timed_phase("12", phase_step_kernels, torch, pair, plan, ids, dev,
                               results, k2_bench)
        for mod in (kfet, kcss, kperm):
            mod.reset_launches()
        timed_phase("13", phase_step_library, torch, gathered, dev, card, tmp, results)
        step_launches = {**kfet.LAUNCHES, **kcss.LAUNCHES, **kperm.LAUNCHES}
        say(f"[sharded step main path] kernel launches: {step_launches}")
        step_path = ("fet_window", "fet_lut_build", "css_dissim_gathered", "css_cmds",
                     "css_perm_chunk")
        check(all(step_launches[k] > 0 for k in step_path),
              f"the sharded step did not launch every kernel: {step_launches}")
        launches["fet_window"] = step_launches["fet_window"]
        launches["css_dissim_gathered"] = step_launches["css_dissim_gathered"]
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

        # the large panels: the kernels against their plain versions, then
        # their main path (run_css in every MDS mode, run-css, run-all)
        timed_phase("16a", phase_large_kernels, torch, dev, card, results)
        for mod in (kfet, kcss, kperm):
            mod.reset_launches()
        timed_phase("16b", phase_large_library, torch, dev, card, tmp, results)
        large_launches = {**kcss.LAUNCHES, **kperm.LAUNCHES}
        coeff_by_bitgen = dict(kperm.COEFF_LAUNCHES)
        say(f"[large-panel main path] kernel launches: {large_launches}; coefficients by "
            f"draw stream: {coeff_by_bitgen}")
        check(all(large_launches[k] > 0 for k in LARGE_PATH)
              and all(v > 0 for v in coeff_by_bitgen.values()),
              f"the large-panel path did not launch every kernel: {large_launches}, "
              f"{coeff_by_bitgen}")
        for k in ("css_dissim_tiles", "css_cmds_block", "css_smacof_block",
                  "css_mc_coeff_block"):
            launches[k] = large_launches[k]

        # the MC past m = 64 and wide FET windows: the kernels against their
        # plain versions, then their main path
        timed_phase("17a-b", phase_large_mc_kernels, torch, dev, card, results)
        timed_phase("17e", phase_large_mc_sweep, torch, dev, card, results)
        timed_phase("17d kernels", phase_wide_fet_kernels, torch, kfet, pair, positions, dev,
                    card, results)
        timed_phase("17d edges", phase_wide_fet_edges, torch, kfet, dev, card, results)
        for mod in (kfet, kcss, kperm):
            mod.reset_launches()
        timed_phase("17b-c", phase_large_mc_library, torch, dev, card, tmp, results)
        timed_phase("17d", phase_wide_fet_library, torch, pair, positions, dev, card, results)
        wide_launches = {**kfet.LAUNCHES, **kcss.LAUNCHES, **kperm.LAUNCHES}
        say(f"[phase 17 main path] kernel launches: {wide_launches}")
        check(all(wide_launches[k] > 0 for k in WIDE_PATH),
              f"phase 17's path did not launch every kernel: {wide_launches}")
        for k in WIDE_PATH:
            launches[k] = wide_launches[k]

        # the ingestion path and the remaining tools: convert-vcf ->
        # run-fet, the native parse, doctor, bench-mc (counts reset inside)
        ingest_launches = timed_phase("18", phase_ingest, torch, dev, tmp, files, results)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    large_entries(results)
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
        if "bound_exact" in r:
            entry["bound_ms_exact"], entry["bound_by_exact"] = r["bound_exact"]
        for sfx in ("", "_exact"):
            # the windows that ms (and bound_ms) and plain_ms cover, where
            # the plain version ran on a depth cut
            if "windows" + sfx in r:
                entry["windows" + sfx], entry["plain_windows" + sfx] = r["windows" + sfx]
        if name == "fet_aggregate":
            entry["stddev_windows_beyond_tol"] = {
                "fast": r["fast_beyond"], "exact": r["exact_beyond"]
            }
            entry["windows_differ"] = entry["stddev_windows_beyond_tol"]
        if name in ("css_dissim", "css_dissim_gathered"):
            entry["library_is"] = ("torch.bmm of the bench windows' float32 one-hots [B, m, 2P] "
                                   "@ [B, 2P, m], P = 128 (the one-hots built beforehand)")
        if name == "css_dissim_gathered":
            # ms / plain_ms: the ~800 k bench windows at P = 128; then the
            # 19,997 windows of the 200 k workload
            for prec in ("fast", "exact"):
                entry[f"ms_20k_{prec}"], entry[f"plain_ms_20k_{prec}"] = r[f"{prec}_20k"][2:]
                entry[f"bound_ms_20k_{prec}"] = r[f"bound_20k_{prec}"][0]
            entry["step_self_ms"] = results["step"]["k3_ms"]
        if name == "css_cmds":
            # library_ms: torch.linalg.eigh on the centred matrices alone
            entry["windows_excluded_eigengap"] = r["exact_excluded"]
            entry["library_ms"] = r["fast_library_ms"]
            entry["library_is"] = "torch.linalg.eigh of the centred matrices (eigen step alone)"
            entry["library_ms_exact"] = r["exact_library_ms"]
            entry["multisection_steps_mean_max"] = {
                "fast": r["fast_steps"], "exact": r["exact_steps"]}
            entry["step_wall_ms"] = results["step"]["wall_ms"]
            entry["step_k5_share"] = results["step"]["k5_share"]
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
            entry["bound_ms_bench_800k_fast"] = r["bound_bench"][0]
            entry["transforms_all_restarts_mds1"] = r["transforms"]
            entry["bound_counts"] = "every restart's transforms"
            entry["ptxas"] = r["ptxas"]
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
            entry["bound_ms_worst_case_16x"] = r["bound_16x"][0]
            # the range loop's launches alone (CUDA events) and its waste
            for tag in ("mix", "threefry", "native", "16x"):
                lt = r[f"launches_{tag}"]
                entry[f"kernel_ms_{tag}"] = lt["hits_ms"]
                entry[f"scan_ms_{tag}"] = lt["scan_ms"]
                entry[f"perms_computed_{tag}"] = lt["computed"]
                entry[f"perms_consumed_{tag}"] = int(lt["nsc"].sum())
                entry[f"ranges_{tag}"] = len(lt["ranges"])
        if name == "fet_window":
            # ms / plain_ms: 19,997 windows of the 200 k workload; then the
            # ~800 k bench windows, bit-equal to phase 2's K1 -> K2, and
            # synthetic windows at P = 256 (block body) and 4,096 (wide)
            entry["ms_bench_800k"] = r["bench_ms"]
            entry["bit_equal_k1_k2_800k"] = r["bit_equal"]
            for prec in ("fast", "exact"):
                entry[f"plain_ms_bench_800k_{prec}"] = r[f"bench_plain_ms_{prec}"]
                entry[f"bound_ms_bench_800k_{prec}"] = r[f"bound_800k_{prec}"][0]
                for Pb in (256, 4096):
                    entry[f"ms_synthetic_{Pb}_{prec}"] = r[f"synthetic_{Pb}_{prec}_ms"]
            entry["step_self_ms"] = results["step"]["k10_ms"]
        if name == "css_perm_chunk":
            # ms / plain_ms: mix draws at the step's size (799,997 windows x
            # 128); then threefry there, and both on the 19,997 windows of
            # the 200 k workload
            entry["ms_threefry"], entry["plain_ms_threefry"] = r["threefry"][2], r["threefry"][3]
            entry["bound_ms_threefry"], entry["bound_by_threefry"] = r["bound_threefry"]
            for form in ("mix", "threefry"):
                entry[f"ms_{form}_20k"] = r[f"{form}_20k"][2]
                entry[f"plain_ms_{form}_20k"] = r[f"{form}_20k"][3]
            entry["k8_first_chunk_windows_stopped"] = r["k8_stopped"]
            entry["ptxas"] = r["ptxas"]
        if name in FET_PATH + CSS_CMDS_PATH:
            entry["launches_run_all"] = all_launches[name]
        if name in LARGE_PATH:
            entry["launches_large_panels"] = large_launches[name]
        if "large" in r:
            # ms / plain_ms / bound_ms: 110 + 90 (K5's plain version on the
            # first LARGE_PLAIN_WINDOWS); every measured case under
            # large_panels
            entry["large_panels"] = r["large"]
        if name == "css_cmds_block":
            # ms / plain_ms / library_ms / bound_ms: the first
            # LARGE_PLAIN_WINDOWS windows; then every window of the workload
            m = sum(LARGE_PANELS[1])
            for prec, sfx in (("fast", ""), ("exact", "_exact")):
                sub = r["large"][f"subset_{prec}_{m}"]
                entry[f"ms{sfx}_{sub['all_windows']}"] = sub["ms_all_windows"]
                entry[f"bound_ms{sfx}_{sub['all_windows']}"] = sub["bound_ms_all_windows"]
            entry["library_ms"] = r["large"][f"subset_fast_{m}"]["eigh_ms"]
            entry["library_ms_exact"] = r["large"][f"subset_exact_{m}"]["eigh_ms"]
            entry["library_is"] = ("torch.linalg.eigh of the centred matrices (the eigen "
                                   "step alone)")
        if name == "css_dissim_tiles":
            m = sum(LARGE_PANELS[1])
            entry["ms_median"] = r["large"][f"median_fast_{m}"]
            entry["ms_exact_median"] = r["large"][f"median_exact_{m}"]
            entry["ms_is"] = "mean of 3 calls with css_pack (CUDA events); ms_median: of 5"
            entry["library_ms"] = r["large"][f"library_{m}"]
            entry["library_is"] = ("torch.bmm of the windows' float32 one-hots [B, m, 2P] "
                                   "@ [B, 2P, m], P the widest window (the one-hots built "
                                   "beforehand)")
        if name == "fet_lut_rank":
            # ms / plain_ms / library_ms: 11 + 10 fast; then every panel of
            # RANK_PANELS in both precisions: G, the sort's, the plain version's and torch.sort(lut + 0.0,
            # stable=True)'s medians of 5 (queued) and the bound
            entry["library_ms_exact"] = r["library_ms_exact"]
            entry["library_is"] = "torch.sort(lut + 0.0, stable=True), values and indices"
            entry["panels"] = {f"{a}+{b}_{prec}": r[f"{a}_{b}_{prec}"]
                               for a, b in RANK_PANELS for prec in ("fast", "exact")}
            entry["no_slower_than_library"] = all(
                c["ms"] <= c["library_ms"] for c in entry["panels"].values())
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
        if name in INGEST_PATH:
            entry["launches_phase18"] = ingest_launches[name]
        if name in WIDE_PATH:
            # ms / plain_ms / bound_ms: 110 + 90 (K8: its depth cut, host
            # wall; K11 and K9 on 19,997 windows, their plain versions on a
            # depth cut) or the 2 Mb windows (K2, K2r, K10); every measured
            # case, with K8's launches alone to LARGE_MC_RUNS, under cases
            entry["cases"] = {k: v for k, v in r.items()
                              if k not in ("fast", "bound", "exact", "bound_exact")}
            entry["launches_phase17"] = wide_launches[name]
        if name == "css_mc_power":
            # ms / plain_ms: the shared stream on 19,997 windows x 1,024
            # permutations (the wrapper: coefficients, product, tile sum);
            # then its launches alone and the ~800 k bench windows (both
            # streams; the window stream's own row is css_mc_power_window)
            entry["kernel_ms"], entry["coeff_ms"] = r["kernel_ms"], r["coeff_ms"]
            entry["max_rel_err_power_sums"] = f_rel
            entry["ms_bench_800k"] = r["bench_ms"]
            entry["launches_by_stream"] = r["launches_by_stream"]
            entry["ms_is"] = "median of 5 calls (CUDA events)"
        if name == "css_mc_power_window":
            # ms / plain_ms: the window stream to m = 64 on 19,997 windows
            # x 1,024 permutations through the wrapper (median of 5 calls);
            # kernel_ms its launches alone; launches: phase 11's, this
            # stream's only (kernels/perm.py POWER_LAUNCHES)
            entry["kernel_ms"] = r["kernel_ms"]
            entry["ms_is"] = "median of 5 calls (CUDA events)"
            entry["mirror_bit_equal"] = r["mirror_bit_equal"]
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
