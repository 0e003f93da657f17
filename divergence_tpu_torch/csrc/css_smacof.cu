// K6: SMACOF scoring of every window of a chromosome in one launch
// (run-css --mds smacof and --mds cmds+smacof): fill-averages, the
// restarts' starting configurations, up to max_iters + 1 Guttman
// transforms per restart, the best restart by stress, pairwise distances
// and the CSS score.
//
// Replaces divergence_tpu/kernels/css.py: smacof, _stress, _guttman and
// smacof_runs, as _score_pipeline calls them with mds=1 and mds=2.  Plain
// torch version: divergence_tpu_torch/kernels/css.py css_smacof_plain.
//
// One block per window; the filled dissimilarities F live in shared
// memory, loaded once for every restart:
//   mode 1 — n_init restarts, one warp each.  Restart r starts from
//     x0[j][c] = uniform(fold_in(chrom_key, slot), (r*m + j)*2 + c), the
//     threefry draws of jax.random.uniform(wkey, (n_init, m, 2))
//     (threefry.cuh; rng.smacof_inits);
//   mode 2 — one restart from the CMDS embedding of F (css_common.cuh's
//     cmds_embed, K5's code, run by the block's one warp; the Guttman
//     transform commutes with sign flips of X, so the eigenvector signs
//     do not matter).
// Each warp iterates in shared memory, X and its transform XN [m][2] per
// restart; lane l owns rows l and l + 32:
//   guttman: XN_i = (sum_{j != i, d_ij >= 1e-5} b_ij x_j - (sum b_ij) x_i) / m,
//            b_ij = -F_ij / d_ij, d_ij = ||x_i - x_j|| computed on the fly
//            (no d matrix; css.py:212-221);
//   stress:  sigma = 0.5 sum_ij (||xn_i - xn_j|| - F_ij)^2 over the whole
//            matrix, diagonal included: F's diagonal holds the fill
//            average, so sigma carries the constant 0.5 m avg^2 that the
//            JAX package's _stress carries (css.py:205-209); one
//            xor-butterfly warp sum, so every lane holds the same bits
//            and takes the same branch;
//   stop:    the transform is accepted, and the restart freezes when
//            sigma_prev - sigma <= eps (NaN included) or after
//            max_iters + 1 transforms; a NaN start (mode 2 after a truly
//            negative eigenvalue) never iterates, as JAX's active0 =
//            (sig0 == sig0).  A warp leaves its loop at its own stop;
//            frozen state never changes, so this equals JAX's fixed-trip
//            lax.scan with per-element freezing.
// Then the best restart is numpy's argmin of sigma (the first NaN, else
// the first minimum), and css_common.cuh's score_window writes the
// distances, score and valid flag.  For testing, each window also reports
// its chosen restart and that restart's transform count.
//
// What bounds it on H100: latency of dependent iterations.  A restart is
// up to 301 transforms of about 3 m^2 flops plus m^2 square roots and
// divisions (guttman) and m^2 square roots (stress), with one warp
// reduction per transform and nothing to overlap inside the warp; at
// m = 21 a third of the lanes idle.  The design keeps everything in
// shared memory (no device-memory traffic beyond D in and dist out), runs
// the restarts side by side as independent warps, lets each stop at its
// own convergence, and relies on many windows per SM (a few KB of shared
// memory each) to fill the card.
#include "css_common.cuh"
#include "threefry.cuh"

namespace {

using namespace cssk;

constexpr int kMaxRestarts = 8;   // warps of a mode-1 block

// 0.5 sum_ij (||x_i - x_j|| - F_ij)^2, the same value in every lane.
template <typename T>
__device__ T warp_stress(const T* F, const T* X, int m, int lane) {
    T part = T(0);
    for (int i = lane; i < m; i += 32) {
        const T xi0 = X[2 * i], xi1 = X[2 * i + 1];
        for (int j = 0; j < m; ++j) {
            const T dx0 = xi0 - X[2 * j];
            const T dx1 = xi1 - X[2 * j + 1];
            const T r = t_sqrt(dx0 * dx0 + dx1 * dx1) - F[i * m + j];
            part += r * r;
        }
    }
    return T(0.5) * warp_sum(part);
}

// One Guttman transform XN = B(X) X / m.
template <typename T>
__device__ void warp_guttman(const T* F, const T* X, T* XN, int m, int lane) {
    for (int i = lane; i < m; i += 32) {
        const T xi0 = X[2 * i], xi1 = X[2 * i + 1];
        T rs = T(0), a0 = T(0), a1 = T(0);
        for (int j = 0; j < m; ++j) {
            if (j == i) continue;
            const T xj0 = X[2 * j], xj1 = X[2 * j + 1];
            const T dx0 = xi0 - xj0;
            const T dx1 = xi1 - xj1;
            const T d = t_sqrt(dx0 * dx0 + dx1 * dx1);
            if (d >= T(0.00001)) {
                const T b = -F[i * m + j] / d;
                rs += b;
                a0 += b * xj0;
                a1 += b * xj1;
            }
        }
        XN[2 * i] = (a0 - rs * xi0) / static_cast<T>(m);
        XN[2 * i + 1] = (a1 - rs * xi1) / static_cast<T>(m);
    }
}

// One restart, run by one warp from X; returns its final stress and
// writes its transform count.  X holds the final configuration.
template <typename T>
__device__ T smacof_warp(const T* F, T* X, T* XN, int m, int max_iters,
                         T eps, int lane, int* ntrans) {
    T sig = warp_stress(F, X, m, lane);
    bool active = sig == sig;
    int n = 0;
    for (int it = 0; it <= max_iters && active; ++it) {
        warp_guttman(F, X, XN, m, lane);
        __syncwarp();
        const T s = warp_stress(F, XN, m, lane);
        active = (sig - s) > eps;
        sig = s;
        ++n;
        for (int p = lane; p < 2 * m; p += 32) X[p] = XN[p];
        __syncwarp();
    }
    *ntrans = n;
    return sig;
}

template <typename T>
__global__ void __launch_bounds__(kMaxRestarts * 32)
css_smacof(const T* __restrict__ dis, const int64_t* __restrict__ npos_arr,
           const int64_t* __restrict__ slots, uint2 chrom_key, int asize,
           int bsize, int mode, int nrest, int max_iters, T eps,
           T wa, T wb, T* __restrict__ scores,
           T* __restrict__ dist_out, uint8_t* __restrict__ valid_out,
           int* __restrict__ restart_out, int* __restrict__ ntrans_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int m = asize + bsize;
    const int mm = m * m;
    T* F = reinterpret_cast<T*>(smem_raw);   // [m][m] filled dissimilarities
    T* X = F + mm;                           // [nrest][m][2]
    T* XN = X + nrest * 2 * m;               // [nrest][m][2]
    T* sig = XN + nrest * 2 * m;             // [nrest]
    T* red = sig + nrest;                    // [32]
    T* extra = red + 32;                     // mode 2: CMDS scratch
    __shared__ int s_ntrans[kMaxRestarts];
    __shared__ int s_best;

    const int64_t w = blockIdx.x;
    const T* D = dis + w * mm;
    const Fill<T> fs = fill_stats(D, m, red);
    for (int p = threadIdx.x; p < mm; p += blockDim.x) F[p] = filled(D[p], fs.avg);
    __syncthreads();

    if (mode == 2) {
        // one warp (nrest = 1); F is already filled, filling it again
        // changes nothing
        cmds_embed(F, m, fs.avg, extra, X);
    } else {
        const uint2 wkey = tf::fold_in(chrom_key, static_cast<uint32_t>(slots[w]));
        for (int p = threadIdx.x; p < nrest * 2 * m; p += blockDim.x) {
            X[p] = tf::uniform<T>(wkey, static_cast<uint32_t>(p));
        }
        __syncthreads();
    }

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    if (warp < nrest) {
        int n = 0;
        const T s = smacof_warp(F, X + warp * 2 * m, XN + warp * 2 * m, m,
                                max_iters, eps, lane, &n);
        if (lane == 0) {
            sig[warp] = s;
            s_ntrans[warp] = n;
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        // numpy's argmin: the first NaN, else the first minimum
        int best = 0;
        for (int r = 1; r < nrest && !isnan(sig[best]); ++r) {
            if (isnan(sig[r]) || sig[r] < sig[best]) best = r;
        }
        s_best = best;
        restart_out[w] = best;
        ntrans_out[w] = s_ntrans[best];
    }
    __syncthreads();
    score_window(X + s_best * 2 * m, asize, bsize, wa, wb,
                 fs.keep && npos_arr[w] > 0, dist_out + w * mm, red,
                 scores + w, valid_out + w);
}

template <typename T>
int launch_smacof(const T* dis, const int64_t* npos, const int64_t* slots,
                  int64_t nwin, uint32_t key0, uint32_t key1, int asize,
                  int bsize, int mode, int n_init, int max_iters, double eps,
                  double wa, double wb, T* scores, T* dist,
                  uint8_t* valid, int* restart, int* ntrans, void* stream) {
    if (nwin == 0) return 0;
    const int nrest = mode == 1 ? n_init : 1;
    if ((mode != 1 && mode != 2) || nrest < 1 || nrest > kMaxRestarts ||
        max_iters < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int m = asize + bsize;
    size_t elems = static_cast<size_t>(m) * m + 4 * nrest * m + nrest + 32;
    if (mode == 2) elems += cmds_scratch(m);
    const size_t smem = elems * sizeof(T);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            css_smacof<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int threads = 32 * nrest;   // one warp per restart
    css_smacof<T><<<static_cast<unsigned>(nwin), threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        dis, npos, slots, make_uint2(key0, key1), asize, bsize, mode, nrest,
        max_iters, static_cast<T>(eps), static_cast<T>(wa),
        static_cast<T>(wb), scores, dist, valid, restart, ntrans);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

FET_EXPORT int css_smacof_f64(const double* dis, const int64_t* npos,
                              const int64_t* slots, int64_t nwin,
                              uint32_t key0, uint32_t key1, int asize,
                              int bsize, int mode, int n_init, int max_iters,
                              double eps, double wa,
                              double wb, double* scores, double* dist,
                              uint8_t* valid, int* restart, int* ntrans,
                              void* stream) {
    return launch_smacof<double>(dis, npos, slots, nwin, key0, key1, asize,
                                 bsize, mode, n_init, max_iters, eps,
                                 wa, wb, scores, dist, valid, restart, ntrans,
                                 stream);
}

FET_EXPORT int css_smacof_f32(const float* dis, const int64_t* npos,
                              const int64_t* slots, int64_t nwin,
                              uint32_t key0, uint32_t key1, int asize,
                              int bsize, int mode, int n_init, int max_iters,
                              double eps, double wa,
                              double wb, float* scores, float* dist,
                              uint8_t* valid, int* restart, int* ntrans,
                              void* stream) {
    return launch_smacof<float>(dis, npos, slots, nwin, key0, key1, asize,
                                bsize, mode, n_init, max_iters, eps,
                                wa, wb, scores, dist, valid, restart, ntrans,
                                stream);
}
