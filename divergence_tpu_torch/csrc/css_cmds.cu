// K5: CMDS scoring of every window of a chromosome in one launch:
// fill-averages + discard rule, double centring, top-2 eigenpairs, dust
// clamp, X = Q sqrt(L), pairwise distances, the CSS score.
//
// Replaces divergence_tpu/kernels/css.py: fill_averages, cmds, calc_dist,
// css_from_dist and _score_pipeline (mds=0), and kernels/linalg.py:
// top2_eig with its TPU routes jacobi_eigh, jacobi_eigh_lanes and
// jacobi_eigh_lanes_chunked (lane-major layout and chunking are TPU
// workarounds).  Plain torch version: divergence_tpu_torch/kernels/css.py
// css_cmds_plain, whose eigensolver is torch.linalg.eigh (the JAX
// package's CPU route, LAPACK); kernels/linalg.py top2_eig_tridiag mirrors
// this kernel's eigensolver step for step on the CPU, for the tests.
//
// One warp per window, kWarps windows per block, each warp with its own
// shared-memory slab (m <= 64), and no block-wide barrier:
//   1. fill: cells < 1e-5 are unset; avg = (sum of set cells) / m^2;
//      unset cells (the diagonal included) take avg; the window is
//      discarded when more than m*m/2 cells are unset
//      (reference statistics/css/css.c:337-366);
//   2-4. css_common.cuh's cmds_embed: double centring, Householder
//      reduction to tridiagonal form, the two largest eigenvalues by
//      multisection on Sturm counts, their vectors by inverse iteration,
//      the back-transform, the dust clamp and X = Q sqrt(L) (the subset
//      route of LAPACK's dsyevx; CMDS needs only the top-2 eigenpairs);
//   5. dist_ij = sqrt(dx0^2 + dx1^2), written out for the MC;
//   6. score = mean(dist[:a, a:]) - m * sum_k w_k dist[k][k+1], with
//      w = 1/(a^2(a-1)) on the a-chain, 1/(b^2(b-1)) on the b-chain;
//   7. valid = keep && npos > 0; the score of an invalid window is 0.
// K6 (css_smacof.cu) mode 2 runs the same cmds_embed from one warp.
//
// What bounds it on H100: operations and their latency inside one warp.
// The least work is the tridiagonal reduction, ~(4/3) m^3 flops a window
// (~12 k at m = 21), against D in and dist out (2 m^2 values): 800 k
// windows of m = 21 are ~1e10 flops and ~5.6 GB in float64.  The
// reduction's m - 2 steps are each a warp-wide matrix-vector product and
// rank-2 update (m - k rows, one a lane) and three warp sums; the
// multisection is ~13 (float64) or ~6 (float32) rounds of one Sturm count
// of m divisions per lane; inverse iteration and the back-transform are
// O(m) per step in lanes 0 and 1.  The design runs one window per warp
// (no barriers), keeps everything in shared memory (~6.7 KB a window at
// m = 21 in float64, so ~32 warps an SM), and does ~1/100 of the old
// cyclic Jacobi's work.  What is left is dependent chains, not flops: a
// Sturm count is m divisions one after another (13 of them per lane in
// float64, where a division is a long instruction sequence), the
// reduction's three warp sums per column, and the serial tridiagonal
// solves of lanes 0 and 1 while 30 lanes wait.
#include "css_common.cuh"

namespace {

using namespace cssk;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// Elements of T of one warp's shared memory: scratch, then X [m][2],
// rounded up to keep every warp's slab 16-byte aligned.
__host__ __device__ constexpr int warp_elems(int m) {
    return ((cmds_scratch(m) + 2 * m + 3) / 4) * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
css_cmds(const T* __restrict__ dis, const int64_t* __restrict__ npos_arr,
         int64_t nwin, int asize, int bsize, T wa, T wb, T* __restrict__ scores,
         T* __restrict__ dist_out, uint8_t* __restrict__ valid_out,
         int* __restrict__ steps_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int m = asize + bsize;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
    if (w >= nwin) return;   // warp-uniform; no block-wide barrier follows
    T* S = reinterpret_cast<T*>(smem_raw) + warp * warp_elems(m);
    T* X = S + cmds_scratch(m);                                   // [m][2]
    const T* D = dis + w * m * m;
    const Fill<T> fs = fill_stats_warp(D, m, lane);                // 1
    const int steps = cmds_embed(D, m, fs.avg, S, X);              // 2-4
    score_window_warp(X, asize, bsize, wa, wb, fs.keep && npos_arr[w] > 0,  // 5-7
                      dist_out + w * m * m, scores + w, valid_out + w);
    if (steps_out && lane == 0) steps_out[w] = steps;
}

template <typename T>
int launch_cmds(const T* dis, const int64_t* npos, int64_t nwin, int asize,
                int bsize, double wa, double wb, T* scores, T* dist, uint8_t* valid,
                int* steps, void* stream) {
    const int m = asize + bsize;
    if (m < 2 || m > 64 || asize < 1 || bsize < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (nwin == 0) return 0;
    const size_t smem = static_cast<size_t>(kWarps) * warp_elems(m) * sizeof(T);
    const cudaError_t e = cudaFuncSetAttribute(
        css_cmds<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t blocks = (nwin + kWarps - 1) / kWarps;
    css_cmds<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
        dis, npos, nwin, asize, bsize, static_cast<T>(wa), static_cast<T>(wb), scores,
        dist, valid, steps);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

FET_EXPORT int css_cmds_f64(const double* dis, const int64_t* npos,
                            int64_t nwin, int asize, int bsize,
                            double wa, double wb, double* scores, double* dist,
                            uint8_t* valid, int* steps, void* stream) {
    return launch_cmds<double>(dis, npos, nwin, asize, bsize, wa, wb, scores, dist,
                               valid, steps, stream);
}

FET_EXPORT int css_cmds_f32(const float* dis, const int64_t* npos,
                            int64_t nwin, int asize, int bsize,
                            double wa, double wb, float* scores, float* dist,
                            uint8_t* valid, int* steps, void* stream) {
    return launch_cmds<float>(dis, npos, nwin, asize, bsize, wa, wb, scores, dist,
                              valid, steps, stream);
}
