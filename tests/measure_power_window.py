"""K9's window stream to m = 64 (``css_mc_power_window``) on the card:
its time, and where a tree's kernel spends it.  Builds a tree's
``csrc/css_mc_power.cu`` and ``csrc/css_mc_window.cu`` (this tree's by
default) into a library of their own and launches the export directly on
the 19,997 windows of the 200 k-SNP / 10 Mbp workload at 11 + 10 (2 chunks
of 512, approx mode's first call) and on an escalation-sized call (64 of
those windows x 16 chunks), both draw streams: the median of 5 calls by
CUDA events, the sums held to the plain version on the first 64 windows.

A tree whose kernel is ``power_window`` (a warp a window, the runtime-m
helpers ``permk::draw``, ``rank`` and ``score_f32`` on arrays in local
memory) is split by ablation: the loop body without the float64 powers
(one add kept), then without the score (one rank read), without the
ranks (a draw kept), without the draws (the loop and the chunk keys);
each difference is that part's time.  ptxas's registers, stack and spills
and the local-memory accesses the code makes a permutation (counted from
the code: draw m stores, rank m^2 + m loads and 2m stores, score m^2 + m
loads) are printed beside them.

A tree whose kernel is ``power_sums`` (K8's small-panel body) is timed as
built (a block a (window, chunk)) and with a block a window over all its
chunks (``kPowerChunksPerBlock`` = 32).

With --bench, also the ~800 k bench windows (mix), the parent's body
whole.

    python tests/measure_power_window.py [--csrc DIR] [--out DIR] [--bench]

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

from divergence_tpu_torch import rng  # noqa: E402
from divergence_tpu_torch.core.windows import plan_windows  # noqa: E402
from divergence_tpu_torch.engine import SnpPair  # noqa: E402
from divergence_tpu_torch.kernels import _build  # noqa: E402
from divergence_tpu_torch.kernels import css as kcss  # noqa: E402
from divergence_tpu_torch.kernels import perm as kperm  # noqa: E402
from divergence_tpu_torch.tools.synth import make_chromosome  # noqa: E402

ASIZE, BSIZE = 11, 10
WORKLOAD = (200_000, 10_000_000, 7)
CHUNK, CHUNKS = 512, 2
FEW, FEW_CHUNKS = 64, 16
OLD_LOOP = """            permk::draw(ck, static_cast<uint32_t>(K), m, bitgen, x);
            permk::rank(x, m, r, ord);
            const double v = static_cast<double>(permk::score_f32(D, r, m, asize, cc));
            const double v2 = __dmul_rn(v, v);
            p1 = __dadd_rn(p1, v);
            p2 = __dadd_rn(p2, v2);
            p3 = __dadd_rn(p3, __dmul_rn(v2, v));
"""
DRAW = "            permk::draw(ck, static_cast<uint32_t>(K), m, bitgen, x);\n"
RANK = "            permk::rank(x, m, r, ord);\n"
SCORE = ("            const double v = static_cast<double>(permk::score_f32(D, r, m, asize, "
         "cc));\n")
ONE_ADD = "            p1 = __dadd_rn(p1, v);\n"
# the old loop body without its last parts, one at a time
ABLATIONS = {
    "full": OLD_LOOP,
    "no powers": DRAW + RANK + SCORE + ONE_ADD,
    "no score": DRAW + RANK + "            const double v = static_cast<double>(r[K % m]);\n"
                + ONE_ADD,
    "no rank": DRAW + "            const double v = static_cast<double>(x[K % m]);\n" + ONE_ADD,
    "no draw": "            const double v = static_cast<double>(K);\n" + ONE_ADD,
}
PARTS = ("powers", "score", "rank", "draw", "the rest")
NEW_CPB = "constexpr int kPowerChunksPerBlock = 1;"
GRIDS = {"a block a (window, chunk)": 1, "a block a window, all its chunks": 32}


def variants(csrc: Path) -> tuple[str, dict]:
    """(kind, {label: {file: text}}) of the tree's kernel."""
    power = (csrc / "css_mc_power.cu").read_text()
    window = (csrc / "css_mc_window.cu").read_text()
    if "power_window(" in power:
        if power.count(OLD_LOOP) != 1:
            raise RuntimeError("css_mc_power.cu's power_window loop changed")
        return "power_window", {k: {"css_mc_power.cu": power.replace(OLD_LOOP, body)}
                                for k, body in ABLATIONS.items()}
    if window.count(NEW_CPB) != 1:
        raise RuntimeError(f"css_mc_window.cu: {NEW_CPB!r} not found once")
    return "power_sums", {k: {"css_mc_window.cu": window.replace(
        NEW_CPB, f"constexpr int kPowerChunksPerBlock = {cpb};")} for k, cpb in GRIDS.items()}


def build_all(csrc: Path, work: Path, sets: dict) -> dict:
    """{label: (library, ptxas log)}: every variant built at once, one nvcc
    a variant (both sources into one shared library)."""
    procs = {}
    for i, (label, files) in enumerate(sets.items()):
        d = work / f"v{i}"
        shutil.copytree(csrc, d)
        for name, text in files.items():
            (d / name).write_text(text)
        lib = d / "power.so"
        procs[label] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{d}", "-shared", "-o", str(lib),
             str(d / "css_mc_power.cu"), str(d / "css_mc_window.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for label, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log[-4000:]}")
        out[label] = (ctypes.CDLL(str(lib)), log)
    return out


def ptxas(log: str, name: str) -> str:
    """ptxas's registers, stack and spills of the kernels named ``name``."""
    rows, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if name in m.group(1) and "block" not in m.group(1) else None
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            rows.append(f"stack {m.group(1)} B, spills {m.group(2)} / {m.group(3)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1] = f"{entry[-12:]}: {m.group(1)} registers, " + rows[-1]
    return "; ".join(rows)


def cell(dev):
    """(dist [B, m, m] float32, window keys) of the workload's valid
    windows, phase 1 in fast mode on the card."""
    npos_, region, seed = WORKLOAD
    pos, am, bm = make_chromosome(npos_, region, ASIZE, BSIZE, seed)
    plan = plan_windows(pos, region, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    vals = SnpPair(pos, am, bm).to_device(dev)
    lo, npos, slot = (torch.from_numpy(a[ids].copy()) for a in (plan.lo, plan.npos, plan.slot))
    s, d, v = kcss.css_phase1(vals, lo, npos, ASIZE, BSIZE, fast=True)
    keep = v.cpu().numpy()
    slots = slot.numpy()[keep]
    wkeys = rng.window_keys(rng.fold_in(rng.prng_key(0), 2).to(dev),
                            np.zeros(len(slots), np.int64), slots)
    return d[v].float().contiguous(), wkeys.to(torch.int64).contiguous()


def bench_cell(dev):
    """(dist [B, m, m] float32, window keys) of the ~800 k bench windows
    (8 M SNPs / 400 Mbp at 11 + 10, bench.py:240-241): K3 then K5's
    distances, float32, as chip_smoke.py phase 10 makes them."""
    pos, am, bm = make_chromosome(8_000_000, 400_000_000, ASIZE, BSIZE, 7)
    plan = plan_windows(pos, 400_000_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    lo, npos, slot = (torch.from_numpy(a[ids].copy()) for a in (plan.lo, plan.npos, plan.slot))
    dis = kcss.css_dissim(SnpPair(pos, am, bm).to_device(dev), lo, npos, torch.float32)
    d = kcss.css_cmds(dis, npos.to(dev), ASIZE, BSIZE)[1]
    wkeys = rng.window_keys(rng.fold_in(rng.prng_key(0), 2).to(dev),
                            np.zeros(len(ids), np.int64), slot.numpy())
    return d.float().contiguous(), wkeys.to(torch.int64).contiguous()


def median_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def main(csrc: Path, out: Path, bench: bool) -> None:
    work = out / "power_window"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    kind, sets = variants(csrc)
    libs = build_all(csrc, work, sets)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()
    m = ASIZE + BSIZE
    print(f"{card}; {csrc} (kernel {kind}); ptxas: "
          f"{ptxas(next(iter(libs.values()))[1], kind)}", flush=True)
    if kind == "power_window":
        loads, stores = 2 * m * m + 2 * m, 3 * m
        print(f"local memory a permutation at m = {m}, counted from the code: {loads} loads "
              f"and {stores} stores of 4 bytes ({4 * (loads + stores):,} bytes)", flush=True)
    dist, wkeys = cell(dev)
    B = dist.shape[0]
    between, ca, cb = kperm._coeff_constants(ASIZE, BSIZE)
    f32 = ctypes.c_float
    for lib, _ in libs.values():
        lib.css_mc_power_window.argtypes = (
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, *([ctypes.c_int] * 6), f32, f32,
            f32, ctypes.c_void_p, ctypes.c_void_p)
        lib.css_mc_power_window.restype = ctypes.c_int
    for gen, bitgen in enumerate(("mix", "threefry")):
        for label_cell, nb, nk in (("19,997-window cell", B, CHUNKS),
                                   ("escalation-sized", FEW, FEW_CHUNKS)):
            times = {}
            want = kperm.null_power_sums_plain(dist[:FEW], wkeys[:FEW], ASIZE, BSIZE, CHUNK, 0,
                                               nk, "window", bitgen)
            for label, (lib, _) in libs.items():
                o = torch.empty((nk, 3, nb), dtype=torch.float64, device=dev)

                def call(lib=lib, o=o, nb=nb, nk=nk):
                    rc = lib.css_mc_power_window(
                        dist.data_ptr(), wkeys.data_ptr(), nb, m, ASIZE, 0, nk, CHUNK, gen,
                        f32(between), f32(ca), f32(cb), o.data_ptr(), None)
                    if rc != 0:
                        raise RuntimeError(f"css_mc_power_window: CUDA error {rc}")

                times[label] = median_ms(call)
                if label in ("full", next(iter(GRIDS))):
                    rms = (want[:, 1:2] / CHUNK).sqrt()
                    q = torch.arange(1, 4, device=dev, dtype=want.dtype)[None, :, None]
                    err = float(((o[..., :FEW] - want).abs() / (CHUNK * rms ** q)).max())
                    print(f"  [{bitgen}, {label_cell}] sums against the plain version on "
                          f"{FEW} windows: {err:.2e} of their magnitude", flush=True)
            perms = nb * nk * CHUNK
            line = ", ".join(f"{k} {v:.4f} ms ({v * 1e6 / perms:.4f} ns a permutation)"
                             for k, v in times.items())
            print(f"[{bitgen}, {label_cell}: {nb} windows x {nk} chunks of {CHUNK}] {line}",
                  flush=True)
            if kind == "power_window":
                t = [times[k] for k in ABLATIONS]
                shares = [t[i] - t[i + 1] for i in range(len(t) - 1)] + [t[-1]]
                print("  by ablation: " + ", ".join(
                    f"{p} {s:.4f} ms ({100 * s / t[0]:.1f} %)" for p, s in zip(PARTS, shares)),
                    flush=True)
    if bench:
        del dist, wkeys
        torch.cuda.empty_cache()
        dist, wkeys = bench_cell(dev)
        nb = dist.shape[0]
        o = torch.empty((CHUNKS, 3, nb), dtype=torch.float64, device=dev)
        times = {}
        for label, (lib, _) in libs.items():
            if kind == "power_window" and label != "full":
                continue

            def call(lib=lib):
                if lib.css_mc_power_window(dist.data_ptr(), wkeys.data_ptr(), nb, m, ASIZE, 0,
                                           CHUNKS, CHUNK, 0, f32(between), f32(ca), f32(cb),
                                           o.data_ptr(), None) != 0:
                    raise RuntimeError("css_mc_power_window failed on the bench windows")

            times[label] = median_ms(call)
        perms = nb * CHUNKS * CHUNK
        print(f"[mix, the bench windows: {nb} windows x {CHUNKS} chunks of {CHUNK}] " + ", ".join(
            f"{k} {v:.3f} ms ({v * 1e6 / perms:.4f} ns a permutation)" for k, v in times.items()),
            flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--bench", action="store_true",
                    help="also the ~800 k bench windows (mix; the parent's full body only)")
    ns = ap.parse_args()
    if ns.out is not None:
        ns.out.mkdir(parents=True, exist_ok=True)
        main(ns.csrc.resolve(), ns.out, ns.bench)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(ns.csrc.resolve(), Path(tmp), ns.bench)
