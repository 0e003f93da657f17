"""K3's large-panel counts (``css_dissim_tiles_{f32,f64}``: ``css_pack``
then the large-panel kernel) on the card: their time, and what sets it.
Builds a tree's ``csrc/css_dissim.cu`` (this tree's by default) into a
library of its own, in variants, and launches the export directly on the
19,997 windows of the 200 k-SNP / 10 Mbp workload at 70 + 58 and 110 + 90,
fast (float32) and exact (float64): the mean of 3 calls after a warm one
(as ``chip_smoke.py`` phase 16a times the wrapper) and the median of 5, by
CUDA events, the counts held to the plain version.

Variants, each a copy of the tree's source with one change:
* full — as built;
* no stores — the kernel's output stores behind a branch never taken (a
  runtime ``nwin < 0``), the counts still computed;
* no popcounts — each ``__popc(x)`` replaced by ``x``;
* pack only — ``css_pack`` alone (the call returns before the counts);
* 16-byte stores (a tree with ``css_dissim_rows``) — each row's run
  staged in a warp's shared buffer and written by 16-byte streaming stores
  from its first 16-byte boundary (scalar ones for the head and tail), in
  place of coalesced 4- or 8-byte ones;
* 2 or 8 rows a task (``kRowsPerTask``), and 8 rows over runs of 128
  columns (``kRowRegs`` = 4);
* 4 blocks an SM (``__launch_bounds__`` caps the registers at 64; the
  kernel takes 80, so 3 blocks of 256 threads fit an SM).

    python tests/measure_dissim_large.py [--csrc DIR] [--out DIR]

(--csrc: another tree's ``divergence_tpu_torch/csrc``, e.g. the parent
commit's unpacked by ``git archive`` into a gitignored directory.)"""

import argparse
import ctypes
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

from divergence_tpu_torch.core.windows import plan_windows  # noqa: E402
from divergence_tpu_torch.engine import SnpPair  # noqa: E402
from divergence_tpu_torch.kernels import _build  # noqa: E402
from divergence_tpu_torch.kernels import css as kcss  # noqa: E402
from divergence_tpu_torch.tools.synth import make_chromosome  # noqa: E402

PANELS = ((70, 58), (110, 90))
WORKLOAD = (200_000, 10_000_000, 7)
HBM_BYTES_PER_S = 3.35e12
PACK_RETURN = "    return launch_tiles(maj, mnr, lo, npos, nwin, m, out, st);\n"
# (anchor, replacement) by variant, for each kernel
OLD = {
    "no stores": [(
        "        if (i < m) o[static_cast<int64_t>(i) * m + j] = static_cast<T>(acc[q]);\n",
        "        if (i < m && nwin < 0) o[static_cast<int64_t>(i) * m + j] = "
        "static_cast<T>(acc[q]);\n")],
    "no popcounts": [(
        "acc[q] += __popc(sw[0][r][k] & sw[3][tx][k]) + __popc(sw[1][r][k] & sw[2][tx][k]);",
        "acc[q] += (sw[0][r][k] & sw[3][tx][k]) + (sw[1][r][k] & sw[2][tx][k]);")],
}
STORES = """        // each row's run as one stream of coalesced streaming stores
#pragma unroll
        for (int r = 0; r < kRowsPerTask; ++r) {
            if (r >= rows) break;
            T* dst = out + (w * m + i0 + r) * static_cast<int64_t>(m) + c0 + lane;
#pragma unroll
            for (int u = 0; u < kRowRegs; ++u) {
                if (32 * u >= len) break;
                if (32 * u + lane < len) __stcs(dst + 32 * u, static_cast<T>(acc[r][u]));
            }
        }
"""
# each row's run staged in a warp's shared buffer, then 16-byte streaming
# stores from its first 16-byte boundary, scalar ones for the head and tail
VECTOR_STORES = """        __shared__ __align__(16) T vbuf[kRowWarps][kRowRun + 16 / sizeof(T)];
        constexpr int E = 16 / sizeof(T);
        T* buf = vbuf[warp];
#pragma unroll
        for (int r = 0; r < kRowsPerTask; ++r) {
            if (r >= rows) break;
            T* dst = out + (w * m + i0 + r) * static_cast<int64_t>(m) + c0;
            const int h = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) /
                          static_cast<int>(sizeof(T));
            const int s = (E - h) % E;
#pragma unroll
            for (int u = 0; u < kRowRegs; ++u) {
                if (32 * u >= len) break;
                if (32 * u + lane < len) buf[s + 32 * u + lane] = static_cast<T>(acc[r][u]);
            }
            __syncwarp();
            const int nv = len > h ? (len - h) / E : 0;
            const int tail = len > h ? h + E * nv : len;
            if (lane < min(h, len)) __stcs(dst + lane, buf[s + lane]);
            for (int v = lane; v < nv; v += 32) {
                if constexpr (sizeof(T) == 4) {
                    __stcs(reinterpret_cast<float4*>(dst + h + E * v),
                           *reinterpret_cast<const float4*>(buf + s + h + E * v));
                } else {
                    __stcs(reinterpret_cast<double2*>(dst + h + E * v),
                           *reinterpret_cast<const double2*>(buf + s + h + E * v));
                }
            }
            if (tail + lane < len) __stcs(dst + tail + lane, buf[s + tail + lane]);
            __syncwarp();
        }
"""
ROWS = "constexpr int kRowsPerTask = 4;"
BOUNDS = "__global__ void __launch_bounds__(kRowThreads)\ncss_dissim_rows("
REGS = "constexpr int kRowRegs = 8;"
NEW = {
    "no stores": [("if (32 * u + lane < len) __stcs(dst + 32 * u, static_cast<T>(acc[r][u]));",
                   "if (32 * u + lane < len && nwin < 0) __stcs(dst + 32 * u, "
                   "static_cast<T>(acc[r][u]));")],
    "no popcounts": [("acc[r][u] += __popc((a[r] & cj) | (b[r] & dj));",
                      "acc[r][u] += (a[r] & cj) | (b[r] & dj);")],
    "16-byte stores": [(STORES, VECTOR_STORES)],
    "2 rows a task": [(ROWS, ROWS.replace("= 4;", "= 2;"))],
    "8 rows a task": [(ROWS, ROWS.replace("= 4;", "= 8;"))],
    "8 rows a task, runs of 128": [(ROWS, ROWS.replace("= 4;", "= 8;")),
                                   (REGS, REGS.replace("= 8;", "= 4;"))],
    "4 blocks an SM": [(BOUNDS, BOUNDS.replace("(kRowThreads)", "(kRowThreads, 4)"))],
}


def variants(csrc: Path) -> tuple[str, dict]:
    """(kernel, {label: source text})."""
    src = (csrc / "css_dissim.cu").read_text()
    kind = "css_dissim_rows" if "css_dissim_rows" in src else "css_dissim_tile"
    out = {"full": src}
    for label, edits in (NEW if kind == "css_dissim_rows" else OLD).items():
        text = src
        for anchor, repl in edits:
            if text.count(anchor) != 1:
                raise RuntimeError(f"css_dissim.cu: {anchor!r} found {text.count(anchor)} times")
            text = text.replace(anchor, repl)
        out[label] = text
    if src.count(PACK_RETURN) != 2:
        raise RuntimeError("css_dissim.cu: launch_tiles is not returned twice")
    out["pack only"] = src.replace(PACK_RETURN, "    return 0;\n", 1)
    return kind, out


def build_all(csrc: Path, work: Path, texts: dict) -> dict:
    procs = {}
    for i, (label, text) in enumerate(texts.items()):
        d = work / f"v{i}"
        shutil.copytree(csrc, d)
        (d / "css_dissim.cu").write_text(text)
        lib = d / "dissim.so"
        procs[label] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{d}", "-shared", "-o", str(lib),
             str(d / "css_dissim.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for label, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log[-4000:]}")
        libs[label] = ctypes.CDLL(str(lib))
    return libs


def times_ms(fn) -> tuple[float, float]:
    """(mean of 3 calls after a warm one, median of 5 single calls)."""
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(3):
        fn()
    e.record()
    e.synchronize()
    mean = s.elapsed_time(e) / 3
    one = []
    for _ in range(5):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        one.append(s.elapsed_time(e))
    return mean, float(np.median(one))


def main(csrc: Path, out: Path) -> None:
    work = out / "dissim_large"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    kind, texts = variants(csrc)
    libs = build_all(csrc, work, texts)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()
    print(f"{card}; {csrc} (kernel {kind})", flush=True)
    P = ctypes.c_void_p
    for lib in libs.values():
        for t in ("f32", "f64"):
            fn = getattr(lib, f"css_dissim_tiles_{t}")
            fn.argtypes = (P, ctypes.c_int64, P, P, ctypes.c_int64, ctypes.c_int, P, P, P)
            fn.restype = ctypes.c_int
    npos_, region, seed = WORKLOAD
    for a, b in PANELS:
        m = a + b
        pos, am, bm = make_chromosome(npos_, region, a, b, seed)
        plan = plan_windows(pos, region, 2500, 500)
        ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
        vals = SnpPair(pos, am, bm).to_device(dev)
        N = vals.shape[0]
        lo, npos = (torch.from_numpy(x[ids].copy()).to(dev) for x in (plan.lo, plan.npos))
        B = lo.numel()
        want = kcss.dissimilarity_plain(vals, lo, npos)
        planes = torch.empty((2, (N + 31) // 32 + 1, m), dtype=torch.int32, device=dev)
        for dt, t in ((torch.float32, "f32"), (torch.float64, "f64")):
            o = torch.empty((B, m, m), dtype=dt, device=dev)
            nbytes = vals.numel() * 2 + B * (16 + m * m * o.element_size())
            line = []
            for label, lib in libs.items():
                fn = getattr(lib, f"css_dissim_tiles_{t}")

                def call(fn=fn, o=o):
                    rc = fn(vals.data_ptr(), N, lo.data_ptr(), npos.data_ptr(), B, m,
                            planes.data_ptr(), o.data_ptr(), None)
                    if rc != 0:
                        raise RuntimeError(f"css_dissim_tiles_{t}: CUDA error {rc}")

                mean, med = times_ms(call)
                if label in ("full", "16-byte stores"):
                    if not torch.equal(o.double(), want):
                        raise RuntimeError(f"{label} {t} at m = {m}: counts differ")
                line.append(f"{label} {mean:.4f} / {med:.4f}")
            print(f"[m = {m} {t}, {B} windows, mean of 3 / median of 5, ms] " + ", ".join(line)
                  + f"; bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes); counts equal "
                  "to the plain version", flush=True)
            del o
        del vals, want, planes
        torch.cuda.empty_cache()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("--out", type=Path, default=None)
    ns = ap.parse_args()
    if ns.out is not None:
        ns.out.mkdir(parents=True, exist_ok=True)
        main(ns.csrc.resolve(), ns.out)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(ns.csrc.resolve(), Path(tmp))
