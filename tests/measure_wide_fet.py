"""Where K2's wide body (``fet_aggregate_wide``) spends its cycles, on the
card: builds an instrumented copy of a tree's ``csrc/fet_window_stats.cuh``
and ``csrc/fet_aggregate.cu`` (this tree's by default) in which thread 0 of
each block adds the clock64 cycles since its last stamp to a phase's count
(block-cycles, summed over the windows), and runs it on windows of ~0.73 P
SNPs at P = 8,192 and 65,536 (the bench FET workload's 250 kb and 2 Mb
widths) over 8 M per-SNP scores, half of them 0 (p = 1, the common FET
score) and the rest exponential, in both precisions.

Phases of a tree whose wide body sorts (``wide_window_stats``):

    sort  — the bitonic network over the window's slab;
    boot  — the bootstrap (a fold_in, a draw and a pow a step and sample,
            the fold, the picks from the sorted slab) and the stddev.

The bootstrap's parts are split by two more builds of the same copy: the
step key ``fold_in(wkey, j)`` replaced by ``wkey`` ("no keys") and the
term ``pow(v, e)`` by ``v`` ("no pows"); what each removes is that part's
cost, the rest is the draws, the fold and the picks.

Phases of the band body (``band_window_stats``):

    keys   — a tile's step keys and exponents;
    terms  — a tile's draws and pows;
    fold   — a tile's fold of the terms into u, u2;
    ranks  — the band of ranks the picks need;
    select — the radix select of the band's two ends (a pass a digit,
             until the bins between them hold a band's keys);
    band   — the band's keys gathered and sorted;
    picks  — the replicates, the stddev and the score.

It prints cycles a window by phase and the launch's time by CUDA events
(mean of 3 after a warm call).  ``--threads`` / ``--per-sm`` /
``--early`` build the band body with another block size, cap on its
persistent grid's blocks an SM, or band size at which the select stops.
On a machine with a card and nvcc:

    python tests/measure_wide_fet.py [--csrc DIR] [--out DIR] [--threads N] [--per-sm K] [--early E]

(--csrc: another tree's ``divergence_tpu_torch/csrc``, e.g. the parent
commit's unpacked by ``git archive`` into a gitignored directory.)"""

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.modules["jax"] = None

from divergence_tpu_torch.kernels import _build  # noqa: E402
from divergence_tpu_torch.kernels import fet as kfet  # noqa: E402

NSNPS = 8_000_000
WIDTHS = (8192, 65536)
PERC, NSAMPLES = 0.95, 100

OLD_PHASES = ("sort", "boot")
NEW_PHASES = ("keys", "terms", "fold", "ranks", "select", "band", "picks")
HEAD = """
__device__ unsigned long long ph_total[16];
#define PH_MARK long long ph_last_ = clock64();
#define PH(k) if (threadIdx.x == 0) { const long long n_ = clock64(); \\
    atomicAdd(&ph_total[k], static_cast<unsigned long long>(n_ - ph_last_)); ph_last_ = n_; }
"""
TAIL = """
extern "C" int ph_read(unsigned long long* out) {
    return static_cast<int>(cudaMemcpyFromSymbol(out, ph_total, sizeof(ph_total)));
}
extern "C" int ph_reset() {
    unsigned long long z[16] = {};
    return static_cast<int>(cudaMemcpyToSymbol(ph_total, z, sizeof(z)));
}
"""
# (anchor, text before it, text after it) in the band body
NEW_STAMPS = [
    ("    // 1. the bootstrap, tile by tile of steps\n", "    PH_MARK\n", ""),
    ("        __syncthreads();\n        const int items = jn * nsamples;\n",
     None, "        PH(0)\n"),
    ("            L.term[i] = t_pow(tf::uniform<T>(L.kj[j], static_cast<uint32_t>(s)), "
     "L.ej[j]);\n        }\n        __syncthreads();\n", "", "        PH(1)\n"),
    ("            L.u2[s] = u2;\n        }\n        __syncthreads();\n", "", "        PH(2)\n"),
    ("    __syncthreads();\n    const int r_lo = sc->rmin;\n", "", None),
    ("    const U vlo = sc->plo;\n", "    PH(4)\n", ""),
    ("    // 3. the picks, replicates and stddev\n", "    PH(5)\n", ""),
    ("        if (tid == 0) *stddev_out = sd;\n    }\n    __syncthreads();\n}\n", "",
     None),
]
OLD_BODY = ("    wide_sort(g, P, buf);\n    window_picks(g, reps, n, P, wkey, perc, nsamples, "
            "value_of, score_out, stddev_out);\n    __syncthreads();\n}\n")
OLD_KEY = "tf::uniform<T>(tf::fold_in(wkey, static_cast<uint32_t>(j)),"
OLD_POW = "u = u * t_pow(v, one / t_max(w.nf - jf, one));"


def patch_header(text: str, variant: str, threads: int | None, per_sm: int | None,
                 early: int | None = None) -> str:
    """The tree's fet_window_stats.cuh with the stamps (and the variant's
    edit for a sorting body)."""
    if "band_window_stats" in text:
        for anchor, before, after in NEW_STAMPS:
            if text.count(anchor) != 1:
                raise RuntimeError(f"fet_window_stats.cuh changed: {anchor!r} found "
                                   f"{text.count(anchor)} times")
            if anchor.startswith("        __syncthreads();\n        const int items"):
                new = ("        __syncthreads();\n        PH(0)\n"
                       "        const int items = jn * nsamples;\n")
            elif anchor.startswith("    __syncthreads();\n    const int r_lo"):
                new = "    __syncthreads();\n    PH(3)\n    const int r_lo = sc->rmin;\n"
            elif anchor.startswith("        if (tid == 0) *stddev_out"):
                new = anchor[: -len("}\n")] + "    PH(6)\n}\n"
            else:
                new = before + anchor + after
            text = text.replace(anchor, new)
        if threads:
            text = re.sub(r"constexpr int kWideThreads = \d+;",
                          f"constexpr int kWideThreads = {threads};", text)
        if per_sm:
            text = re.sub(r"constexpr int kWideBlocksPerSm = \d+;",
                          f"constexpr int kWideBlocksPerSm = {per_sm};", text)
        if early:
            text = re.sub(r"constexpr int kEarlyKeys = \d+;",
                          f"constexpr int kEarlyKeys = {early};", text)
        return HEAD + text
    for anchor in (OLD_BODY, OLD_KEY, OLD_POW):
        if text.count(anchor) != 1:
            raise RuntimeError(f"fet_window_stats.cuh changed: {anchor!r}")
    text = text.replace(OLD_BODY, "    PH_MARK\n    wide_sort(g, P, buf);\n    PH(0)\n"
                        + OLD_BODY.split("\n", 1)[1][: -len("}\n")] + "    PH(1)\n}\n")
    if variant == "no keys":
        text = text.replace(OLD_KEY, "tf::uniform<T>(wkey,")
    if variant == "no pows":
        text = text.replace(OLD_POW, "u = u * v;")
    return HEAD + text


def build(csrc: Path, out: Path, tag: str, variant: str, threads, per_sm,
          early) -> ctypes.CDLL:
    work = out / f"wide_fet_{tag}"
    if work.exists():
        shutil.rmtree(work)
    shutil.copytree(csrc, work)
    hdr = work / "fet_window_stats.cuh"
    hdr.write_text(patch_header(hdr.read_text(), variant, threads, per_sm, early))
    src = work / "fet_aggregate.cu"
    src.write_text(src.read_text() + TAIL)
    lib = work / "wide_fet.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{work}", "-shared", "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def windows(P: int, rs):
    n = int(0.73 * P)
    lo = torch.arange(0, NSNPS - P, n // 5, dtype=torch.int64)
    npos = torch.from_numpy(rs.integers(n - n // 10, n + n // 10, size=lo.numel()))
    npos[0] = P - 3
    return lo, npos, torch.arange(lo.numel(), dtype=torch.int64)


def main(csrc: Path, out: Path, threads, per_sm, early) -> None:
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()
    header = (csrc / "fet_window_stats.cuh").read_text()
    band = "band_window_stats" in header
    per_sm_tree = per_sm or int(re.search(r"kWideBlocksPerSm = (\d+)", header).group(1))
    print(f"{card}; {csrc} ({'band' if band else 'sorting'} body"
          f"{f', {threads} threads' if threads else ''}, {per_sm_tree} blocks an SM"
          f"{f', the select stopping at {early} keys' if early else ''})", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = sms * per_sm_tree
    rs = np.random.default_rng(7)
    logs64 = torch.from_numpy(np.where(rs.random(NSNPS) < 0.5, 0.0,
                                       rs.exponential(size=NSNPS))).to(dev)
    variants = ("full",) if band else ("full", "no keys", "no pows")
    libs = {v: build(csrc, out, v.replace(" ", "_"), v, threads, per_sm, early)
            for v in variants}
    for P in WIDTHS:
        lo, npos, slot = windows(P, rs)
        rows, pmax = kfet._window_rows(lo, npos, slot, NSNPS, dev)
        B = lo.numel()
        for dt in (torch.float32, torch.float64):
            sfx = "f32" if dt == torch.float32 else "f64"
            logs = logs64.to(dt)
            scratch = torch.empty(grid * (2 if band else 1) * P, dtype=dt, device=dev)
            res = torch.empty((2, B), dtype=dt, device=dev)
            for v, lib in libs.items():
                fn = getattr(lib, f"fet_aggregate_wide_{sfx}")
                args = [ctypes.c_void_p(logs.data_ptr()), ctypes.c_void_p(rows.data_ptr()),
                        ctypes.c_int64(B), ctypes.c_uint32(5), ctypes.c_uint32(9),
                        ctypes.c_double(PERC), NSAMPLES, P]
                if band:
                    args.append(kfet.WIDE_BAND_KEYS)
                args += [ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(res.data_ptr()),
                         ctypes.c_void_p(None)]
                rc = fn(*args)   # warm
                torch.cuda.synchronize()
                if rc != 0:
                    raise RuntimeError(f"fet_aggregate_wide_{sfx} failed: CUDA error {rc}")
                lib.ph_reset()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    fn(*args)
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / 3
                cyc = (ctypes.c_ulonglong * 16)()
                lib.ph_read(cyc)
                names = NEW_PHASES if band else OLD_PHASES
                c = np.array(cyc[: len(names)], dtype=np.float64) / (3 * B)
                total = c.sum()
                print(f"P = {P} {sfx} {v}: {B} windows, {ms:.3f} ms; {total:,.0f} block-cycles "
                      f"a window: " + ", ".join(f"{k} {x:,.0f} ({100 * x / total:.1f} %)"
                                                 for k, x in zip(names, c)), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--per-sm", type=int, default=None)
    ap.add_argument("--early", type=int, default=None)
    ns = ap.parse_args()
    if ns.out is not None:
        ns.out.mkdir(parents=True, exist_ok=True)
        main(ns.csrc.resolve(), ns.out, ns.threads, ns.per_sm, ns.early)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(ns.csrc.resolve(), Path(tmp), ns.threads, ns.per_sm, ns.early)
