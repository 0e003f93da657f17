"""K5's block form (css_cmds_block) at two block sizes on the card: 512
threads a block (``__launch_bounds__(512, 1)``) against 256 threads with
room for two blocks an SM (``__launch_bounds__(256, 2)``, at most 128
registers a thread).  Builds a copy of css_cmds_block's kernel from a
tree's ``csrc/css_block.cuh`` (this tree's by default) at each size, runs
both on the 19,997 windows of the 200 k-SNP / 10 Mbp chromosome (seed 7)
at 70 + 58 and 110 + 90 in both precisions, a block a window with the
slab in shared memory, and prints for each: the blocks an SM the
occupancy query allows, registers and local memory a thread, the mean
time of three launches by CUDA events, and the largest score difference
from the library's own css_cmds on the same windows (the two sizes add
the Householder step's sums in different orders).  The library's own
launch is timed beside them.  On a machine with a card and nvcc:

    python tests/measure_cmds_threads.py [--csrc DIR] [--out DIR]

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
from divergence_tpu_torch.engine import SnpPair  # noqa: E402
from divergence_tpu_torch.kernels import _build  # noqa: E402
from divergence_tpu_torch.kernels import css as kcss  # noqa: E402
from divergence_tpu_torch.tools.synth import make_chromosome  # noqa: E402

SIZES = ((512, 1), (256, 2))   # (threads, blocks an SM asked of ptxas)

SOURCE = """
#include "css_block.cuh"
namespace cssk {
// css_cmds.cu's css_cmds_block with the slab in shared memory
template <int NT, int MINB, typename T>
__global__ void __launch_bounds__(NT, MINB)
cmds_nt(const T* __restrict__ dis, const int64_t* __restrict__ npos_arr, int64_t nwin,
        int asize, int bsize, T wa, T wb, T* __restrict__ scores, T* __restrict__ dist_out,
        uint8_t* __restrict__ valid_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int m = asize + bsize;
    void* red = smem_raw;
    T* S = reinterpret_cast<T*>(smem_raw + red_bytes<NT>());
    T* X = S + cmds_block_scratch(m);
    for (int64_t w = blockIdx.x; w < nwin; w += gridDim.x) {
        const T* D = dis + w * m * m;
        const Fill<T> fs = fill_stats_block<NT>(D, m, red);
        cmds_embed_block<NT>(D, m, fs.avg, S, X, red);
        score_window_block<NT>(X, asize, bsize, wa, wb, fs.keep && npos_arr[w] > 0,
                               dist_out + w * m * m, scores + w, valid_out + w, red);
        __syncthreads();
    }
}

template <int NT, int MINB, typename T>
int run(const T* dis, const int64_t* npos, int64_t nwin, int asize, int bsize, double wa,
        double wb, T* scores, T* dist, uint8_t* valid, int* info) {
    const int m = asize + bsize;
    const size_t smem = red_bytes<NT>() +
                        static_cast<size_t>(cmds_block_scratch(m) + 2 * m + 2) * sizeof(T);
    cudaError_t e = cudaFuncSetAttribute(cmds_nt<NT, MINB, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaFuncAttributes fa;
    if ((e = cudaFuncGetAttributes(&fa, cmds_nt<NT, MINB, T>)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], cmds_nt<NT, MINB, T>, NT,
                                                            smem)) != cudaSuccess) {
        return static_cast<int>(e);
    }
    info[1] = fa.numRegs;
    info[2] = static_cast<int>(fa.localSizeBytes);
    cmds_nt<NT, MINB, T><<<static_cast<unsigned>(nwin), NT, smem>>>(
        dis, npos, nwin, asize, bsize, static_cast<T>(wa), static_cast<T>(wb), scores, dist,
        valid);
    return static_cast<int>(cudaGetLastError());
}
}  // namespace cssk

#define RUN(NT, MINB, T, SFX)                                                               \\
    extern "C" int run_##NT##_##SFX(const T* d, const int64_t* n, int64_t w, int a, int b, \\
                                    double wa, double wb, T* s, T* x, uint8_t* v, int* i) { \\
        return cssk::run<NT, MINB, T>(d, n, w, a, b, wa, wb, s, x, v, i);                 \\
    }
RUN(512, 1, float, f32)
RUN(512, 1, double, f64)
RUN(256, 2, float, f32)
RUN(256, 2, double, f64)
"""


def windows(a: int, b: int, dev):
    """(float64 dissimilarities [B, m, m], npos [B]) on the card: the
    valid windows (2500 / 500 bp) of the 200 k-SNP chromosome."""
    pos, am, bm = make_chromosome(200_000, 10_000_000, a, b, 7)
    plan = plan_windows(pos, 10_000_000, 2500, 500)
    ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
    vals = SnpPair(pos, am, bm).to_device(dev)
    lo = torch.from_numpy(plan.lo[ids].copy()).to(dev)
    npos = torch.from_numpy(plan.npos[ids].copy()).to(dev)
    return kcss.css_dissim(vals, lo, npos, torch.float64), npos


def events_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(csrc: Path, out: Path) -> None:
    src, lib_path = out / "cmds_threads.cu", out / "cmds_threads.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}", "-shared", "-o",
                    str(lib_path), str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(f"{card}; {csrc}")
    P = ctypes.c_void_p
    for a, b in ((70, 58), (110, 90)):
        m = a + b
        dis64, npos = windows(a, b, dev)
        B = dis64.shape[0]
        w = kcss.chain_weights_host(a, b)
        wa, wb = float(w[0]), float(w[-1])
        for dt, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
            d = dis64.to(dt).contiguous()
            form = kcss.cmds_form(m, dt)
            want = kcss.css_cmds(d, npos, a, b)
            lib_ms = events_ms(lambda: kcss.css_cmds(d, npos, a, b))
            line = [f"m={m} {sfx} ({B} windows): library css_cmds ({form}) {lib_ms:.3f} ms"]
            for nt, minb in SIZES:
                fn = getattr(lib, f"run_{nt}_{sfx}")
                scores = torch.empty(B, dtype=dt, device=dev)
                dist = torch.empty_like(d)
                valid = torch.empty(B, dtype=torch.uint8, device=dev)
                info = (ctypes.c_int * 3)()

                def launch():
                    rc = fn(P(d.data_ptr()), P(npos.data_ptr()), ctypes.c_int64(B), a, b,
                            ctypes.c_double(wa), ctypes.c_double(wb), P(scores.data_ptr()),
                            P(dist.data_ptr()), P(valid.data_ptr()), info)
                    if rc != 0:
                        raise RuntimeError(f"{nt} threads at m = {m} {sfx}: CUDA error {rc}")

                ms = events_ms(launch)
                same_valid = torch.equal(valid.bool(), want[2]) and torch.equal(
                    scores.isnan(), want[0].isnan())
                both = scores.isfinite() & want[0].isfinite()
                diff = float((scores.double() - want[0].double())[both].abs().max())
                line.append(f"{nt} threads ({info[0]} a SM, {info[1]} registers, {info[2]} B "
                            f"local) {ms:.3f} ms, score diff {diff:.3e}, valid flags and NaNs equal {same_valid}")
            print("; ".join(line), flush=True)
            del d, want
        del dis64
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
