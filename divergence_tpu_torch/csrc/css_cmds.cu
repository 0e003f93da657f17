// K5: CMDS scoring of every window of a chromosome in one launch:
// fill-averages + discard rule, double centring, top-2 eigenpairs, dust
// clamp, X = Q sqrt(L), pairwise distances, the CSS score.
//
// Replaces divergence_tpu/kernels/css.py: fill_averages, cmds, calc_dist,
// css_from_dist and _score_pipeline (mds=0), and kernels/linalg.py:
// top2_eig with its TPU routes jacobi_eigh, jacobi_eigh_lanes and
// jacobi_eigh_lanes_chunked (lane-major layout and chunking are TPU
// workarounds; one block per window needs neither).  Plain torch
// version: divergence_tpu_torch/kernels/css.py css_cmds_plain, whose
// eigensolver is torch.linalg.eigh (the JAX package's CPU route, LAPACK).
//
// One block per window, everything in shared memory (m <= 64).  Steps 1,
// 2-4 and 5-7 are css_common.cuh's fill_stats, cmds_embed and
// score_window, which K6 (css_smacof.cu) shares:
//   1. fill: cells < 1e-5 are unset; avg = (sum of set cells) / m^2;
//      unset cells (the diagonal included) take avg; the window is
//      discarded when more than m*m/2 cells are unset
//      (reference statistics/css/css.c:337-366);
//   2. B = -0.5 (d^2 - (row_i + row_j) + grand), row/grand means of d^2
//      (d^2 is symmetric, so the column means are the row means, and the
//      sum row_i + row_j keeps B exactly symmetric);
//   3. cyclic Jacobi, parallel round-robin order: each round's m/2 pairs
//      are disjoint; one thread per pair computes (c, s) with the
//      overflow-free inner-rotation tangent of linalg.py:61-80
//      (t = sign(d) apq / (|d| + hypot(d, apq)), t = 1 at d == 0), then
//      one thread per (pair, pair) block applies R^T A R to its 2x2
//      block in place, and one per (row, pair) applies V R.  The 2x2
//      update sums its four terms as (diagonal pair) + (cross pair), so
//      the mirrored block gives the same bits and A stays exactly
//      symmetric.  Odd m pads one decoupled zero row / column, which no
//      rotation touches (apq = 0).  Sweeps stop after the first sweep in
//      which every pivot was within eps * ||B||_F (that sweep still
//      rotates, so the result sits at the rounding floor), or after 30;
//   4. the two largest eigenvalues and their vectors; negative values
//      within dust * max(|l1|, 1) become 0 (dust 1e-9 in f64, 1e-5 in
//      f32, css.py:155-160); a truly negative one gives NaN coordinates,
//      as in the reference;
//   5. dist_ij = sqrt(dx0^2 + dx1^2), written out for the MC;
//   6. score = mean(dist[:a, a:]) - m * sum_k w_k dist[k][k+1], with
//      w = 1/(a^2(a-1)) on the a-chain, 1/(b^2(b-1)) on the b-chain;
//   7. valid = keep && npos > 0; the score of an invalid window is 0.
//
// What bounds it on H100: latency.  A window is ~10 sweeps x (m-1)
// rounds, each two barriers apart, over an m x m matrix that lives in
// shared memory; no device-memory traffic beyond D in and dist out
// (2 m^2 values).  Many windows run per SM at once (about 16 KB of
// shared memory per block at m = 21 in f64) to hide the barriers.
#include "css_common.cuh"

namespace {

using namespace cssk;

template <typename T>
__global__ void __launch_bounds__(kThreads)
css_cmds(const T* __restrict__ dis, const int64_t* __restrict__ npos_arr,
         int64_t nwin, int asize, int bsize, const int* __restrict__ pairs,
         T wa, T wb, T* __restrict__ scores, T* __restrict__ dist_out,
         uint8_t* __restrict__ valid_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int m = asize + bsize;
    const int mp = m + (m & 1);
    const int np = mp / 2;
    T* A = reinterpret_cast<T*>(smem_raw);   // [mp][mp]
    T* V = A + mp * mp;                      // [mp][mp]
    T* cs_c = V + mp * mp;                   // [np]
    T* cs_s = cs_c + np;                     // [np]
    T* X = cs_s + np;                        // [m][2]
    T* rowm = X + 2 * m;                     // [m]
    T* red = rowm + m;                       // [32]
    __shared__ int s_flags[3];

    const int64_t w = blockIdx.x;
    const T* D = dis + w * m * m;
    const Fill<T> fs = fill_stats(D, m, red);                       // 1
    cmds_embed(D, m, fs.avg, pairs, A, V, cs_c, cs_s, rowm, red,    // 2-4
               s_flags, X);
    score_window(X, asize, bsize, wa, wb, fs.keep && npos_arr[w] > 0,  // 5-7
                 dist_out + w * m * m, red, scores + w, valid_out + w);
}

template <typename T>
int launch_cmds(const T* dis, const int64_t* npos, int64_t nwin, int asize,
                int bsize, const int* pairs, double wa, double wb, T* scores,
                T* dist, uint8_t* valid, void* stream) {
    if (nwin == 0) return 0;
    const int m = asize + bsize;
    const int mp = m + (m & 1);
    const size_t smem =
        (2 * static_cast<size_t>(mp) * mp + mp + 3 * m + 32) * sizeof(T);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            css_cmds<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    css_cmds<T><<<static_cast<unsigned>(nwin), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
        dis, npos, nwin, asize, bsize, pairs, static_cast<T>(wa),
        static_cast<T>(wb), scores, dist, valid);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

FET_EXPORT int css_cmds_f64(const double* dis, const int64_t* npos,
                            int64_t nwin, int asize, int bsize,
                            const int* pairs, double wa, double wb,
                            double* scores, double* dist, uint8_t* valid,
                            void* stream) {
    return launch_cmds<double>(dis, npos, nwin, asize, bsize, pairs, wa, wb,
                               scores, dist, valid, stream);
}

FET_EXPORT int css_cmds_f32(const float* dis, const int64_t* npos,
                            int64_t nwin, int asize, int bsize,
                            const int* pairs, double wa, double wb,
                            float* scores, float* dist, uint8_t* valid,
                            void* stream) {
    return launch_cmds<float>(dis, npos, nwin, asize, bsize, pairs, wa, wb,
                              scores, dist, valid, stream);
}
