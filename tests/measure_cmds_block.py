"""Where K5's block form (css_cmds_block) spends its cycles, by step, on
the card: builds an instrumented copy of ``csrc/css_block.cuh``'s
cmds_embed_block (clock64 stamps by thread 0 after a __syncthreads at each
step's start: double centring, the Householder reduction, the diagonal and
Gershgorin interval, the multisection, inverse iteration, the
back-transform, the dust clamp), runs it one block per window on the first
264 windows of a 20 k-SNP / 1 Mbp chromosome at 70 + 58 and 110 + 90 in
both precisions, and prints each step's mean cycles a window.  The extra
barriers cost a few hundred cycles a window.  On a machine with a card
and nvcc:

    python tests/measure_cmds_block.py [OUT_DIR]

(OUT_DIR, default a temporary directory, receives the source and the
library.)"""

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

# stamp i is taken where these lines of cmds_embed_block begin
STEPS = [
    ("double centring", None),
    ("Householder", "    // 2. Householder reduction to tridiagonal form;"),
    ("diagonal, Gershgorin", "    for (int i = tid; i < m; i += NT) dv[i] = A[tri(i, i)];"),
    ("multisection", "    // 3. multisection in warp 0:"),
    ("inverse iteration", "    // 4. inverse iteration, thread c for eigenvector c"),
    ("back-transform", "    // 5. back-transform through the reflectors"),
    ("dust clamp, X", "    // 6. dust clamp, X = Q sqrt(L)"),
]
NSTAMP = len(STEPS) + 1

KERNEL = """
template <typename T>
__global__ void __launch_bounds__(kBlockThreads) steps_kernel(const T* dis, int m,
                                                              long long* stamps) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    void* red = smem_raw;
    T* S = reinterpret_cast<T*>(smem_raw + kRedBytes);
    const T* D = dis + static_cast<int64_t>(blockIdx.x) * m * m;
    const Fill<T> fs = fill_stats_block(D, m, red);
    cmds_embed_steps(D, m, fs.avg, S, S + cmds_block_scratch(m), red,
                     stamps + static_cast<int64_t>(blockIdx.x) * NSTAMP);
}

template <typename T>
int run(const T* dis, int64_t nwin, int m, long long* stamps) {
    const size_t smem = kRedBytes + static_cast<size_t>(cmds_block_scratch(m) + 2 * m) * sizeof(T);
    cudaError_t e = cudaFuncSetAttribute(steps_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    steps_kernel<T><<<static_cast<unsigned>(nwin), kBlockThreads, smem>>>(dis, m, stamps);
    return static_cast<int>(cudaGetLastError());
}
}  // namespace cssk

extern "C" int steps_f64(const double* d, int64_t n, int m, long long* s) {
    return cssk::run<double>(d, n, m, s);
}
extern "C" int steps_f32(const float* d, int64_t n, int m, long long* s) {
    return cssk::run<float>(d, n, m, s);
}
"""


def instrumented_source() -> str:
    """css_block.cuh's cmds_embed_block as cmds_embed_steps, with a stamp
    at each step's start and one at its end, and the kernel above."""
    src = (_build.CSRC / "css_block.cuh").read_text()
    start = src.index("template <typename T>\n__device__ int cmds_embed_block(")
    end = src.index("// Distances, score and valid flag of one window, by the block.")
    body = src[start:end].replace(
        "__device__ int cmds_embed_block(const T* D, int m, T avg, T* S, T* X, void* red) {",
        "__device__ int cmds_embed_steps(const T* D, int m, T avg, T* S, T* X, void* red,\n"
        "                                long long* stamp) {\n"
        "    if (threadIdx.x == 0) stamp[0] = clock64();", 1)
    for i, (_, line) in enumerate(STEPS[1:], start=1):
        if line not in body:
            raise RuntimeError(f"css_block.cuh changed: no line {line!r}")
        body = body.replace(
            line, f"    __syncthreads();\n    if (threadIdx.x == 0) stamp[{i}] = clock64();\n{line}", 1)
    body = body.replace("    __syncthreads();\n    return steps;",
                        "    __syncthreads();\n    if (threadIdx.x == 0) stamp[NSTAMP - 1] = clock64();\n"
                        "    return steps;", 1)
    return (f'#include "{_build.CSRC / "css_block.cuh"}"\n'
            f"namespace cssk {{\nconstexpr int NSTAMP = {NSTAMP};\n{body}{KERNEL}")


def main(out: Path) -> None:
    src, lib_path = out / "cmds_block_steps.cu", out / "cmds_block_steps.so"
    src.write_text(instrumented_source())
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(card)
    for a, b in ((70, 58), (110, 90)):
        m = a + b
        pos, am, bm = make_chromosome(20_000, 1_000_000, a, b, 7)
        plan = plan_windows(pos, 1_000_000, 2500, 500)
        ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0][:264]
        vals = torch.from_numpy(np.concatenate([am, bm], axis=1).astype(np.int16)).to(dev)
        dis = kcss.dissimilarity_plain(vals, torch.from_numpy(plan.lo[ids]),
                                       torch.from_numpy(plan.npos[ids]))
        for dt, fn in ((torch.float32, lib.steps_f32), (torch.float64, lib.steps_f64)):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
            d = dis.to(dt).contiguous()
            stamps = torch.zeros((d.shape[0], NSTAMP), dtype=torch.int64, device=dev)
            for _ in range(2):   # the second call is the one read
                rc = fn(ctypes.c_void_p(d.data_ptr()), d.shape[0], m,
                        ctypes.c_void_p(stamps.data_ptr()))
                torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"steps kernel launch failed: CUDA error {rc}")
            steps = (stamps[:, 1:] - stamps[:, :-1]).double().mean(0).cpu().numpy()
            total = float(steps.sum())
            print(f"m={m} {str(dt)[6:]}: {total:,.0f} cycles a window: " + ", ".join(
                f"{name} {v:,.0f} ({100 * v / total:.0f} %)"
                for (name, _), v in zip(STEPS, steps)), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        Path(sys.argv[1]).mkdir(parents=True, exist_ok=True)
        main(Path(sys.argv[1]))
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(Path(tmp))
