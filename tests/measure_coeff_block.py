"""Where K7's large-panel coefficients (``css_mc_coeff_block``) spend their
time, on the card: builds an instrumented copy of a tree's
``csrc/css_mc.cu`` (this tree's by default) with clock64 stamps, and runs
it on 16 chunks of 256 permutations (M [m^2, 4,096] float32) at m = 128
and 200 (11 : 9), both draw streams, timing the launch by CUDA events
(mean of 5 after a warm call).

A tree whose blocks draw and rank their own 32-column group
(``css_mc_coeff_groups``): thread 0 of each block stamps after the draws'
barrier (draw), after the ranks' barrier (rank) and after a barrier
closing the write loop (write); block-cycles summed over the blocks.

A tree that ranks each column once (``css_mc_coeff_rank`` then
``css_mc_coeff_write``): lane 0 of each warp stamps after the column's
draws, sort and facts (rank; the draws are inside the sort's loads, so
draw reads 0), and each writing warp after its rows (write); warp-cycles
summed over the warps.  The ranking kernel is also timed alone, and the
write pass alone two ways: the library's float4 streaming stores, and a
variant that stages each warp's 512-byte row piece in shared memory and
stores it by a one-dimensional bulk copy (``cp.async.bulk``, two pieces
in flight a warp).

    python tests/measure_coeff_block.py [--csrc DIR] [--out DIR]

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

from divergence_tpu_torch import rng  # noqa: E402
from divergence_tpu_torch.kernels import _build  # noqa: E402
from divergence_tpu_torch.kernels import perm as kperm  # noqa: E402

PHASES = ("draw", "rank", "write")
HEAD = """
__device__ unsigned long long ph_total[4];
#define PH_MARK long long ph_last_ = clock64();
#define PH(k) if (PH_WHO) { const long long n_ = clock64(); \\
    atomicAdd(&ph_total[k], static_cast<unsigned long long>(n_ - ph_last_)); ph_last_ = n_; }
"""
TAIL = """
extern "C" int ph_read(unsigned long long* out) {
    return static_cast<int>(cudaMemcpyFromSymbol(out, ph_total, sizeof(ph_total)));
}
extern "C" int ph_reset() {
    unsigned long long z[4] = {};
    return static_cast<int>(cudaMemcpyToSymbol(ph_total, z, sizeof(z)));
}
"""
# the ranking pass alone, as css_mc_coeff_block launches it
RANK_ONLY = """
extern "C" int coeff_rank_only(uint32_t key0, uint32_t key1, int k0, int nk, int chunk,
                               int cstride, int m, int asize, int bitgen, uint32_t* gscratch) {
    const int64_t ncols = static_cast<int64_t>(nk) * cstride;
    const int warps = rank_warps(m);
    const size_t smem = static_cast<size_t>(warps) * 8 * m;
    if (smem > 48 * 1024) {
        cudaFuncSetAttribute(css_mc_coeff_rank, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    }
    css_mc_coeff_rank<<<static_cast<unsigned>((ncols + warps - 1) / warps), warps * 32, smem>>>(
        make_uint2(key0, key1), k0, chunk, cstride, m, asize, bitgen, ncols, gscratch,
        reinterpret_cast<uint8_t*>(gscratch + static_cast<int64_t>(m) * ncols));
    return static_cast<int>(cudaGetLastError());
}
"""
# the write pass alone, as css_mc_coeff_block launches it, and the same
# pass storing each warp's 512-byte row piece from shared memory by a bulk
# copy (cp.async.bulk, the TMA's one-dimensional form), two pieces in flight
WRITES = """
extern "C" int coeff_write_only(int m, int64_t ncols, float between, float ca, float cb,
                                const uint32_t* gscratch, float* out) {
    const dim3 grid(static_cast<unsigned>((ncols + kWriteCols - 1) / kWriteCols),
                    static_cast<unsigned>((m + kWriteWarps - 1) / kWriteWarps));
    css_mc_coeff_write<<<grid, kWriteWarps * 32>>>(
        m, ncols, between, ca, cb, gscratch,
        reinterpret_cast<const uint8_t*>(gscratch + static_cast<int64_t>(m) * ncols), out);
    return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kWriteWarps * 32)
coeff_write_bulk(int m, int64_t ncols, float between, float ca, float cb,
                 const uint32_t* __restrict__ fact, const uint8_t* __restrict__ ub,
                 float* __restrict__ out) {
    __shared__ __align__(128) float4 stage[kWriteWarps][2][32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int j = blockIdx.y * kWriteWarps + warp;
    const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kWriteCols;
    if (j >= m) return;
    const int64_t rest = (ncols - c0) / 4;
    const int lanes = rest < 32 ? static_cast<int>(rest) : 32;
    const int64_t c = c0 + 4 * (lane < lanes ? lane : 0);
    const int64_t jc = j * ncols + c;
    const uint4 f = *reinterpret_cast<const uint4*>(fact + jc);
    const uint32_t uj = *reinterpret_cast<const uint32_t*>(ub + jc);
    const uint32_t fq[4] = {f.x, f.y, f.z, f.w};
    float bet[4], cw[4];
    int succ[4];
    for (int q = 0; q < 4; ++q) {
        bet[q] = (uj >> (8 * q)) & 0xffu ? between : 0.0f;
        const uint32_t cls = fq[q] >> 16;
        cw[q] = cls == 1u ? ca : (cls == 2u ? cb : 0.0f);
        succ[q] = static_cast<int>(fq[q] & 0xffffu);
    }
    float* row = out + static_cast<int64_t>(j) * m * ncols + c0;
    for (int l = 0; l < m; ++l) {
        const uint32_t ul = __ldg(reinterpret_cast<const uint32_t*>(ub + l * ncols + c));
        float v[4];
        for (int q = 0; q < 4; ++q) {
            const float b = (ul >> (8 * q)) & 0xffu ? 0.0f : bet[q];
            const float chain = l == succ[q] ? cw[q] : 0.0f;
            v[q] = b - chain;
        }
        const int buf = l & 1;
        if (lane == 0 && l >= 2) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        __syncwarp();
        stage[warp][buf][lane] = make_float4(v[0], v[1], v[2], v[3]);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (lane == 0) {
            const unsigned s =
                static_cast<unsigned>(__cvta_generic_to_shared(&stage[warp][buf][0]));
            asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                         :: "l"(row + l * ncols), "r"(s), "r"(16 * lanes) : "memory");
            asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
    }
    if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

extern "C" int coeff_write_bulk_only(int m, int64_t ncols, float between, float ca, float cb,
                                     const uint32_t* gscratch, float* out) {
    const dim3 grid(static_cast<unsigned>((ncols + kWriteCols - 1) / kWriteCols),
                    static_cast<unsigned>((m + kWriteWarps - 1) / kWriteWarps));
    coeff_write_bulk<<<grid, kWriteWarps * 32>>>(
        m, ncols, between, ca, cb, gscratch,
        reinterpret_cast<const uint8_t*>(gscratch + static_cast<int64_t>(m) * ncols), out);
    return static_cast<int>(cudaGetLastError());
}
"""
OLD = [  # (anchor, replacement)
    ("    const int64_t blk = static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;\n",
     "    PH_MARK\n    const int64_t blk = static_cast<int64_t>(blockIdx.y) * gridDim.x + "
     "blockIdx.x;\n"),
    ("    __syncthreads();\n    for (int e = tid; e < kGroup * m; e += kCoeffBlockThreads) {\n"
     "        const int q",
     "    __syncthreads();\n    PH(0)\n    for (int e = tid; e < kGroup * m; e += "
     "kCoeffBlockThreads) {\n        const int q"),
    ("    __syncthreads();\n    const bool valid", "    __syncthreads();\n    PH(1)\n"
     "    const bool valid"),
    ("        out[static_cast<int64_t>(e) * ncols + c0 + lane] = v;\n    }\n}\n",
     "        out[static_cast<int64_t>(e) * ncols + c0 + lane] = v;\n    }\n"
     "    __syncthreads();\n    PH(2)\n}\n"),
]
NEW = [
    ("    const uint2 key = tf::fold_in(mc_key, static_cast<uint32_t>(k0 + col / cstride));\n",
     "    PH_MARK\n    const uint2 key = tf::fold_in(mc_key, static_cast<uint32_t>(k0 + col / "
     "cstride));\n"),
    ("            put_facts(g, static_cast<int>(keys[g] & 0xFFFF), next, m, asize, ncols, col, "
     "fact, ub);\n        }\n    }\n}\n",
     "            put_facts(g, static_cast<int>(keys[g] & 0xFFFF), next, m, asize, ncols, col, "
     "fact, ub);\n        }\n    }\n    PH(1)\n}\n"),
    ("    if (j >= m || c >= ncols) return;\n",
     "    if (j >= m || c >= ncols) return;\n    PH_MARK\n"),
    ("        __stcs(reinterpret_cast<float4*>(row + l * ncols), make_float4(v[0], v[1], v[2], "
     "v[3]));\n    }\n}\n",
     "        __stcs(reinterpret_cast<float4*>(row + l * ncols), make_float4(v[0], v[1], v[2], "
     "v[3]));\n    }\n    PH(2)\n}\n"),
]


def instrumented(csrc: Path) -> tuple[str, bool]:
    src = (csrc / "css_mc.cu").read_text()
    new = "css_mc_coeff_rank" in src
    for anchor, repl in NEW if new else OLD:
        if src.count(anchor) != 1:
            raise RuntimeError(f"css_mc.cu changed: {anchor!r} found {src.count(anchor)} times")
        src = src.replace(anchor, repl)
    who = "#define PH_WHO " + ("((threadIdx.x & 31) == 0)\n" if new else "(threadIdx.x == 0)\n")
    return who + HEAD + src + TAIL + (RANK_ONLY + WRITES if new else ""), new


def main(csrc: Path, out: Path) -> None:
    work = out / "coeff_block"
    if work.exists():
        shutil.rmtree(work)
    shutil.copytree(csrc, work)
    text, new = instrumented(csrc)
    (work / "css_mc.cu").write_text(text)
    lib_path = work / "coeff_block.so"
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{work}", "-shared", "-o",
                           str(lib_path), str(work / "css_mc.cu")], capture_output=True,
                          text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stderr[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()
    print(f"{card}; {csrc} ({'a column ranked once' if new else '32-column groups'})",
          flush=True)
    key = rng.fold_in(rng.prng_key(5), 2)
    k0w, k1w = (int(v) for v in key.tolist())
    nk, chunk = 16, 256
    cs = kperm.chunk_stride(chunk)
    ncols = nk * cs
    for a, b in ((70, 58), (110, 90)):
        m = a + b
        between, ca, cb = kperm._coeff_constants(a, b)
        for gen, bitgen in enumerate(("mix", "threefry")):
            out_t = torch.empty((m * m, ncols), dtype=torch.float32, device=dev)
            words = ctypes.c_int64(0)
            form = lib.css_mc_coeff_form(m, ctypes.c_int64(ncols), ctypes.byref(words))
            scratch = (torch.empty(max(words.value, 1), dtype=torch.int32, device=dev)
                       if (new or form == 2) else None)
            sp = ctypes.c_void_p(None if scratch is None else scratch.data_ptr())
            args = [ctypes.c_uint32(k0w), ctypes.c_uint32(k1w), 0, nk, chunk, cs, m, a, gen,
                    ctypes.c_float(between), ctypes.c_float(ca), ctypes.c_float(cb), sp,
                    ctypes.c_void_p(out_t.data_ptr()), ctypes.c_void_p(None)]
            rc = lib.css_mc_coeff_block(*args)
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"css_mc_coeff_block failed: CUDA error {rc}")
            want = kperm.coeff_range_plain(key, 0, nk, m, a, b, chunk, dev, bitgen)
            same = torch.equal(out_t.view(torch.int32), want.view(torch.int32))
            del want
            lib.ph_reset()

            def timed(fn, reps=5):
                fn()
                torch.cuda.synchronize()
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(reps):
                    fn()
                e.record()
                torch.cuda.synchronize()
                return s.elapsed_time(e) / reps

            lib.ph_reset()
            ms = timed(lambda: lib.css_mc_coeff_block(*args))   # noqa: B023
            cyc = (ctypes.c_ulonglong * 4)()
            lib.ph_read(cyc)
            c = np.array(cyc[:3], dtype=np.float64)
            extra = ""
            if new:
                rank_ms = timed(lambda: lib.coeff_rank_only(  # noqa: B023
                    ctypes.c_uint32(k0w), ctypes.c_uint32(k1w), 0, nk, chunk, cs, m, a, gen, sp))
                # the write pass alone, by streaming stores and by bulk copies
                f32 = ctypes.c_float
                wargs = (m, ctypes.c_int64(ncols), f32(between), f32(ca), f32(cb), sp)
                bulk = torch.empty_like(out_t)
                write_ms = timed(lambda: lib.coeff_write_only(  # noqa: B023
                    *wargs, ctypes.c_void_p(out_t.data_ptr())))  # noqa: B023
                bulk_ms = timed(lambda: lib.coeff_write_bulk_only(  # noqa: B023
                    *wargs, ctypes.c_void_p(bulk.data_ptr())))  # noqa: B023
                torch.cuda.synchronize()
                same_bulk = torch.equal(bulk.view(torch.int32), out_t.view(torch.int32))
                del bulk
                extra = (f"; the ranking pass alone {rank_ms:.4f} ms, the write pass alone "
                         f"{write_ms:.4f} ms by st.global.cs, {bulk_ms:.4f} ms by cp.async.bulk "
                         f"(the same bits: {same_bulk})")
            unit = "warp-cycles" if new else "block-cycles"
            print(f"m = {m} {bitgen}: M [{m * m}, {ncols}] bit-equal to the plain version "
                  f"{same}; {ms:.4f} ms{extra}; {unit}: " + ", ".join(
                      f"{k} {x / 6:,.0f} ({100 * x / c.sum():.1f} %)"
                      for k, x in zip(PHASES, c)) + " (summed over the launches, / 6)",
                  flush=True)
            del out_t, scratch


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
