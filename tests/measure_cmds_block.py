"""Where K5's block form (css_cmds_block) spends its cycles, by step, on
the card: builds an instrumented copy of ``csrc/css_block.cuh``'s
cmds_embed_block in which thread 0 of each block adds the clock64 cycles
since its last stamp to a step's count right after each step's closing
barrier (double centring; the Householder reduction's product passes and
its update passes, the sigma reductions included; the diagonal and
Gershgorin interval; the multisection; inverse iteration; the
back-transform; the dust clamp and X), runs it one block per window on
the first 264 windows of a 20 k-SNP / 1 Mbp chromosome at 70 + 58 and
110 + 90 in both precisions, at the block size css_cmds_block's launcher
picks (256 threads where two such blocks fit an SM, else 512), and prints
the threads, each step's mean cycles a window and the launch's time by
CUDA events.  The stamps add no barrier.  On a machine with a card and
nvcc:

    python tests/measure_cmds_block.py [--csrc DIR] [--out DIR]

(--csrc: another tree's ``divergence_tpu_torch/csrc``; --out, default a
temporary directory, receives the source and the library.)"""

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from divergence_tpu_torch.core.windows import plan_windows  # noqa: E402
from divergence_tpu_torch.kernels import _build  # noqa: E402
from divergence_tpu_torch.kernels import css as kcss  # noqa: E402
from divergence_tpu_torch.tools.synth import make_chromosome  # noqa: E402

# (step, the lines of cmds_embed_block where it ends: its stamp goes after
# each line that closes with the step's barrier, before each line that
# opens the next step)
AFTER, BEFORE = "after", "before"
STEPS = [
    ("double centring", [(AFTER, "    if (lane == 0) sgp[warp] = spart;\n    __syncthreads();\n")]),
    ("Householder product", [(AFTER, "        if (lane == 0) pvp[warp] = pvw;\n"
                                     "        __syncthreads();\n")]),
    ("Householder update", [(AFTER, "            if (lane == 0) sgn[warp] = part;\n"
                                    "            __syncthreads();\n"),
                            (AFTER, "        if (lane == 0) sgn[warp] = part;\n"
                                    "        __syncthreads();\n")]),
    ("diagonal, Gershgorin", [(AFTER, "    emax = block_reduce<NT>(emax, red, Max());\n")]),
    ("multisection", [(AFTER, "    const T l2 = bc[1];\n")]),
    ("inverse iteration", [(BEFORE, "    // 5. back-transform through the reflectors, warp c for eigenvector c\n")]),
    ("back-transform", [(BEFORE, "    // 6. dust clamp, X = Q sqrt(L)\n")]),
    ("dust clamp, X", [(BEFORE, "    return steps;\n")]),
]
NSTEP = len(STEPS)

HEAD = f"""
#include "css_block.cuh"
namespace cssk {{
__shared__ long long ph_acc[{NSTEP}];
__shared__ long long ph_last;
#define PH(k) if (threadIdx.x == 0) {{ const long long n_ = clock64(); \\
    ph_acc[k] += n_ - ph_last; ph_last = n_; }}
"""

KERNEL = f"""
template <int NT, int MINB, typename T>
__global__ void __launch_bounds__(NT, MINB) steps_kernel(const T* dis, int m, long long* out) {{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    void* red = smem_raw;
    T* S = reinterpret_cast<T*>(smem_raw + red_bytes<NT>());
    const T* D = dis + static_cast<int64_t>(blockIdx.x) * m * m;
    const Fill<T> fs = fill_stats_block<NT>(D, m, red);
    if (threadIdx.x == 0) {{
        for (int q = 0; q < {NSTEP}; ++q) ph_acc[q] = 0;
        ph_last = clock64();
    }}
    cmds_embed_steps<NT>(D, m, fs.avg, S, S + cmds_block_scratch(m), red);
    if (threadIdx.x == 0) {{
        for (int q = 0; q < {NSTEP}; ++q) out[static_cast<int64_t>(blockIdx.x) * {NSTEP} + q] = ph_acc[q];
    }}
}}

template <int NT, int MINB, typename T>
int launch(const T* dis, int64_t nwin, int m, long long* out, int* threads) {{
    const size_t smem = red_bytes<NT>() +
                        static_cast<size_t>(cmds_block_scratch(m) + 2 * m) * sizeof(T);
    cudaError_t e = cudaFuncSetAttribute(steps_kernel<NT, MINB, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    int per_sm = 0;
    if (e != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, steps_kernel<NT, MINB, T>,
                                                            NT, smem)) != cudaSuccess) {{
        return static_cast<int>(e);
    }}
    if (MINB == 2 && per_sm < 2) return -1;   // the launcher takes 512 threads
    *threads = NT;
    steps_kernel<NT, MINB, T><<<static_cast<unsigned>(nwin), NT, smem>>>(dis, m, out);
    return static_cast<int>(cudaGetLastError());
}}

// css_cmds.cu's launch rule: 256 threads where two blocks fit an SM, else 512
template <typename T>
int run(const T* dis, int64_t nwin, int m, long long* out, int* threads) {{
    const int rc = launch<256, 2, T>(dis, nwin, m, out, threads);
    return rc >= 0 ? rc : launch<512, 1, T>(dis, nwin, m, out, threads);
}}
}}  // namespace cssk

extern "C" int steps_f64(const double* d, int64_t n, int m, long long* s, int* t) {{
    return cssk::run<double>(d, n, m, s, t);
}}
extern "C" int steps_f32(const float* d, int64_t n, int m, long long* s, int* t) {{
    return cssk::run<float>(d, n, m, s, t);
}}
"""


def instrumented_source(csrc: Path = _build.CSRC) -> str:
    """css_block.cuh's cmds_embed_block as cmds_embed_steps, with a stamp
    after each step's closing barrier, and the kernel above."""
    src = (csrc / "css_block.cuh").read_text()
    start = src.index("template <int NT, typename T>\n__device__ int cmds_embed_block(")
    end = src.index("// Distances, score and valid flag of one window, by the block.")
    body = src[start:end].replace("__device__ int cmds_embed_block(", "__device__ int cmds_embed_steps(", 1)
    for i, (_, anchors) in enumerate(STEPS):
        for where, line in anchors:
            if line not in body:
                raise RuntimeError(f"css_block.cuh changed: no line {line!r}")
            stamp = f"    PH({i});\n"
            body = body.replace(line, line + stamp if where == AFTER else stamp + line, 1)
    return HEAD + body + KERNEL


def main(csrc: Path, out: Path) -> None:
    src, lib_path = out / "cmds_block_steps.cu", out / "cmds_block_steps.so"
    src.write_text(instrumented_source(csrc))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}", "-shared", "-o",
                    str(lib_path), str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(f"{card}; {csrc}")
    for a, b in ((70, 58), (110, 90)):
        m = a + b
        pos, am, bm = make_chromosome(20_000, 1_000_000, a, b, 7)
        plan = plan_windows(pos, 1_000_000, 2500, 500)
        ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0][:264]
        vals = torch.from_numpy(np.concatenate([am, bm], axis=1).astype(np.int16)).to(dev)
        dis = kcss.dissimilarity_plain(vals, torch.from_numpy(plan.lo[ids]),
                                       torch.from_numpy(plan.npos[ids]))
        for dt, fn in ((torch.float32, lib.steps_f32), (torch.float64, lib.steps_f64)):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p]
            threads = ctypes.c_int(0)
            d = dis.to(dt).contiguous()
            stamps = torch.zeros((d.shape[0], NSTEP), dtype=torch.int64, device=dev)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            for _ in range(2):   # the second call is the one read
                start.record()
                rc = fn(ctypes.c_void_p(d.data_ptr()), d.shape[0], m,
                        ctypes.c_void_p(stamps.data_ptr()), ctypes.byref(threads))
                stop.record()
                torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"steps kernel launch failed: CUDA error {rc}")
            steps = stamps.double().mean(0).cpu().numpy()
            total = float(steps.sum())
            print(f"m={m} {str(dt)[6:]}, {threads.value} threads: {total:,.0f} cycles a window "
                  f"({start.elapsed_time(stop):.3f} ms for {d.shape[0]} windows): " + ", ".join(
                      f"{name} {v:,.0f} ({100 * v / total:.0f} %)"
                      for (name, _), v in zip(STEPS, steps)), flush=True)


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
