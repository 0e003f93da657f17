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
// Large panels (css_cmds_block): where kWarps warps' slabs do not fit a
// block's shared memory (float64 from m = 76, float32 from m = 112), one
// block per window runs css_block.cuh's cmds_embed_block: the same steps,
// the matrix as its packed lower triangle (m(m+1)/2 + 19m elements a
// window: float64 in shared memory up to m = 221, float32 up to m = 321),
// the Householder step as two passes by the block's warps (css_block.cuh);
// 512 threads where one block fits an SM, 256 where two do.  Above that
// the slab lives in device memory, one per resident block (a grid of one
// block per SM walks the windows, so the slabs stay in L2); only device
// memory limits m.  Its least work is the same (4/3) m^3 flops a window:
// 10.7 M at m = 200, which is 6.3 ms for 19,997 windows at the float64
// peak.  Each Householder step moves the trailing matrix through shared
// memory about twice (the product reads it, the rank-2 update reads and
// writes its triangle); the product runs rows on groups of threads, the
// update is dealt evenly over all the block's threads, and a step takes
// two barriers.  What bounds this unblocked form is the step's
// instructions and their latency, ~2.2-2.5 k cycles a pass even on a
// short trailing matrix (tests/measure_cmds_block.py): a blocked
// reduction (dsytrd / dlatrd: nb columns at a time, the trailing update a
// rank-2nb product on the tensor cores) would cut that nb-fold; it is not
// this kernel.
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
#include "css_block.cuh"

namespace {

using namespace cssk;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// The block form's threads: 512 where one block an SM fits, 256 where
// two do (the second block's parallel steps then fill the first's serial
// ones: the multisection's Sturm counts, inverse iteration; 256 x 2 took
// 0.56-0.70 of 512 x 1's time on an H100 where two fit, 512 x 1 0.97 of
// 256's where one does: tests/measure_cmds_threads.py).  Both keep the
// larger form's reduction bytes ahead of the slab.
constexpr int kCmdsThreads = 512;
constexpr int kCmdsPairThreads = 256;
constexpr int kCmdsRed = red_bytes<kCmdsThreads>();

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

// Elements of T of one block's slab: cmds_embed_block's scratch, then X
// [m][2], rounded up to keep every slab 16-byte aligned.
__host__ __device__ constexpr int block_elems(int m) {
    return ((cmds_block_scratch(m) + 2 * m + 1) / 2) * 2;
}

// kDevSlab: the slab lives in device memory (gslab), else in shared
// memory, where the compiler then addresses it as shared (one kernel for
// both, its slab pointer generic, took 1.08-1.26x the time on an H100:
// tests/measure_cmds_threads.py).
template <int NT, bool kDevSlab, typename T>
__global__ void __launch_bounds__(NT, NT == kCmdsPairThreads ? 2 : 1)
css_cmds_block(const T* __restrict__ dis, const int64_t* __restrict__ npos_arr,
               int64_t nwin, int asize, int bsize, T wa, T wb, T* __restrict__ scores,
               T* __restrict__ dist_out, uint8_t* __restrict__ valid_out,
               int* __restrict__ steps_out, T* __restrict__ gslab) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int m = asize + bsize;
    void* red = smem_raw;
    T* S = kDevSlab ? gslab + static_cast<int64_t>(blockIdx.x) * block_elems(m)
                    : reinterpret_cast<T*>(smem_raw + kCmdsRed);
    T* X = S + cmds_block_scratch(m);                               // [m][2]
    for (int64_t w = blockIdx.x; w < nwin; w += gridDim.x) {
        const T* D = dis + w * m * m;
        const Fill<T> fs = fill_stats_block<NT>(D, m, red);              // 1
        const int steps = cmds_embed_block<NT>(D, m, fs.avg, S, X, red);  // 2-4
        score_window_block<NT>(X, asize, bsize, wa, wb, fs.keep && npos_arr[w] > 0,  // 5-7
                               dist_out + w * m * m, scores + w, valid_out + w, red);
        if (steps_out && threadIdx.x == 0) steps_out[w] = steps;
        __syncthreads();   // the slab is the next window's
    }
}

// Shared memory of the block form: the reduction scratch, and the slab
// unless it lives in device memory.
template <typename T>
size_t block_smem(int m, bool in_device) {
    return kCmdsRed + (in_device ? 0 : static_cast<size_t>(block_elems(m)) * sizeof(T));
}

// Shared memory of the warp form's kWarps slabs.
template <typename T>
size_t warps_smem(int m) {
    return static_cast<size_t>(kWarps) * warp_elems(m) * sizeof(T);
}

// The form css_cmds takes at panel size m: 0, css_cmds (a warp per
// window), where kWarps warps' slabs fit a block (to m = 75 in float64,
// 111 in float32 on Hopper); 1, css_cmds_block with its slab in shared
// memory (to 221 / 321); 2, css_cmds_block with slabs of *slab_elems
// elements in device memory.  -1 where the device cannot be asked.
template <typename T>
int cmds_form(int m, int64_t* slab_elems) {
    const size_t limit = fetk::smem_optin();
    if (limit == 0) return -1;
    *slab_elems = block_elems(m);
    if (warps_smem<T>(m) <= limit) return 0;
    return block_smem<T>(m, false) <= limit ? 1 : 2;
}

template <int NT, bool kDevSlab, typename T>
int launch_block_nt(size_t smem, const T* dis, const int64_t* npos, int64_t nwin, int asize,
                    int bsize, double wa, double wb, T* scores, T* dist, uint8_t* valid,
                    int* steps, T* gslab, int64_t grid, cudaStream_t stream) {
    const cudaError_t e = cudaFuncSetAttribute(
        css_cmds_block<NT, kDevSlab, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    css_cmds_block<NT, kDevSlab, T><<<static_cast<unsigned>(grid), NT, smem, stream>>>(
        dis, npos, nwin, asize, bsize, static_cast<T>(wa), static_cast<T>(wb), scores, dist,
        valid, steps, gslab);
    return static_cast<int>(cudaGetLastError());
}

// gslab: nslab slabs of block_elems(m) in device memory, or null for the
// slab in shared memory (one block per window; 256 threads where the
// device holds two such blocks an SM, else 512).
template <typename T>
int launch_cmds_block(const T* dis, const int64_t* npos, int64_t nwin, int asize,
                      int bsize, double wa, double wb, T* scores, T* dist, uint8_t* valid,
                      int* steps, T* gslab, int64_t nslab, void* stream) {
    const int m = asize + bsize;
    if (m < 2 || asize < 1 || bsize < 1 || (gslab && nslab < 1)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (nwin == 0) return 0;
    const size_t smem = block_smem<T>(m, gslab != nullptr);
    if (smem > fetk::smem_optin()) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (gslab) {
        return launch_block_nt<kCmdsThreads, true, T>(smem, dis, npos, nwin, asize, bsize, wa,
                                                      wb, scores, dist, valid, steps, gslab,
                                                      nslab < nwin ? nslab : nwin, st);
    }
    cudaError_t e = cudaFuncSetAttribute(css_cmds_block<kCmdsPairThreads, false, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    int per_sm = 0;
    if (e != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, css_cmds_block<kCmdsPairThreads, false, T>, kCmdsPairThreads, smem)) !=
            cudaSuccess) {
        return static_cast<int>(e);
    }
    if (per_sm >= 2) {
        return launch_block_nt<kCmdsPairThreads, false, T>(smem, dis, npos, nwin, asize, bsize,
                                                           wa, wb, scores, dist, valid, steps,
                                                           nullptr, nwin, st);
    }
    return launch_block_nt<kCmdsThreads, false, T>(smem, dis, npos, nwin, asize, bsize, wa, wb,
                                                   scores, dist, valid, steps, nullptr, nwin,
                                                   st);
}

template <typename T>
int launch_cmds(const T* dis, const int64_t* npos, int64_t nwin, int asize,
                int bsize, double wa, double wb, T* scores, T* dist, uint8_t* valid,
                int* steps, void* stream) {
    const int m = asize + bsize;
    const size_t smem = warps_smem<T>(m);
    if (m < 2 || smem > fetk::smem_optin() || asize < 1 || bsize < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (nwin == 0) return 0;
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

FET_EXPORT int css_cmds_form_f64(int m, int64_t* slab_elems) {
    return cmds_form<double>(m, slab_elems);
}

FET_EXPORT int css_cmds_form_f32(int m, int64_t* slab_elems) {
    return cmds_form<float>(m, slab_elems);
}

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

FET_EXPORT int css_cmds_block_f64(const double* dis, const int64_t* npos, int64_t nwin,
                                  int asize, int bsize, double wa, double wb,
                                  double* scores, double* dist, uint8_t* valid, int* steps,
                                  double* gslab, int64_t nslab, void* stream) {
    return launch_cmds_block<double>(dis, npos, nwin, asize, bsize, wa, wb, scores, dist,
                                     valid, steps, gslab, nslab, stream);
}

FET_EXPORT int css_cmds_block_f32(const float* dis, const int64_t* npos, int64_t nwin,
                                  int asize, int bsize, double wa, double wb,
                                  float* scores, float* dist, uint8_t* valid, int* steps,
                                  float* gslab, int64_t nslab, void* stream) {
    return launch_cmds_block<float>(dis, npos, nwin, asize, bsize, wa, wb, scores, dist,
                                    valid, steps, gslab, nslab, stream);
}
