// Device functions shared by the CSS scoring kernels, K5 (css_cmds.cu)
// and K6 (css_smacof.cu): one fill-averages, one CMDS embedding (double
// centring + parallel Jacobi + top-2 eigenpairs) and one distance +
// score epilogue, each run by a whole block on one window.
//
//   fill_stats  — cells < 1e-5 are unset; avg = (sum of set cells) / m^2;
//                 the window is discarded when more than m*m/2 cells are
//                 unset (reference statistics/css/css.c:337-366);
//   cmds_embed  — B = -0.5 (f^2 - (row_i + row_j) + grand) of the filled
//                 matrix f, cyclic Jacobi in the round-robin order of
//                 `pairs`, X = Q sqrt(L) of the two largest eigenpairs with
//                 the dust clamp (divergence_tpu/kernels/css.py:133-160);
//   score_window — dist_ij = sqrt(dx0^2 + dx1^2) written out, score =
//                 mean(dist[:a, a:]) - m * sum_k w_k dist[k][k+1], and the
//                 valid flag; an invalid window scores 0.
//
// The Jacobi details (why A stays bit-symmetric, the stop rule) are in
// css_cmds.cu.  Every function calls block_sum or __syncthreads, so every
// thread of the block must call it.
#pragma once

#include <cfloat>

#include "fet_common.cuh"

namespace cssk {

using namespace fetk;

constexpr int kThreads = 128;    // threads of a block that runs cmds_embed
constexpr int kMaxSweeps = 30;

template <typename T>
struct Eps;
template <>
struct Eps<float> {
    static __device__ __forceinline__ float value() { return FLT_EPSILON; }
    static __device__ __forceinline__ float dust() { return 1e-5f; }
};
template <>
struct Eps<double> {
    static __device__ __forceinline__ double value() { return DBL_EPSILON; }
    static __device__ __forceinline__ double dust() { return 1e-9; }
};

__device__ __forceinline__ float t_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double t_abs(double x) { return fabs(x); }

// Sum of v over the block (every thread gets the result).
template <typename T>
__device__ T block_sum(T v, T* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    T total = T(0);
    for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) total += red[k];
    return total;
}

template <typename T>
struct Fill {
    T avg;
    bool keep;
};

template <typename T>
__device__ __forceinline__ T filled(T d, T avg) {
    return d < T(0.00001) ? avg : d;
}

// Fill average and discard rule of the m x m window D.
template <typename T>
__device__ Fill<T> fill_stats(const T* D, int m, T* red) {
    T part = T(0);
    int nun = 0;
    for (int p = threadIdx.x; p < m * m; p += blockDim.x) {
        const T d = D[p];
        if (d < T(0.00001)) {
            ++nun;
        } else {
            part += d;
        }
    }
    const T total = block_sum<T>(part, red);
    const int nunset = static_cast<int>(block_sum<T>(static_cast<T>(nun), red));
    return {total / static_cast<T>(m * m), nunset <= (m * m) / 2};
}

// CMDS embedding X [m][2] of the window D filled with avg.  Shared-memory
// scratch: A, V [mp][mp] (mp = m rounded up to even), cs_c, cs_s [mp/2],
// rowm [m], red [32]; flags: 3 ints of shared memory.  `pairs` is the
// [mp-1][mp/2][2] round-robin table.  Ends with a barrier.
template <typename T>
__device__ void cmds_embed(const T* D, int m, T avg, const int* __restrict__ pairs,
                           T* A, T* V, T* cs_c, T* cs_s, T* rowm, T* red,
                           int* flags, T* X) {
    const int mp = m + (m & 1);
    const int np = mp / 2;
    const T zero = T(0);
    const T one = T(1);
    const T half = T(0.5);

    // f^2 of the filled matrix, row means, double centring
    for (int p = threadIdx.x; p < mp * mp; p += blockDim.x) {
        const int i = p / mp;
        const int j = p - i * mp;
        T v = zero;
        if (i < m && j < m) {
            const T f = filled(D[i * m + j], avg);
            v = f * f;
        }
        A[p] = v;
        V[p] = i == j ? one : zero;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
        T s = zero;
        for (int j = 0; j < m; ++j) s += A[i * mp + j];
        rowm[i] = s / static_cast<T>(m);
    }
    __syncthreads();
    T gpart = zero;
    for (int i = threadIdx.x; i < m; i += blockDim.x) gpart += rowm[i];
    const T grand = block_sum<T>(gpart, red) / static_cast<T>(m);
    T npart = zero;
    for (int p = threadIdx.x; p < m * m; p += blockDim.x) {
        const int i = p / m;
        const int j = p - i * m;
        // (row_i + row_j) keeps B exactly symmetric
        const T b = -half * ((A[i * mp + j] - (rowm[i] + rowm[j])) + grand);
        A[i * mp + j] = b;
        npart += b * b;
    }
    const T tol = Eps<T>::value() * t_sqrt(block_sum<T>(npart, red));

    // cyclic Jacobi, parallel round-robin order
    for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
        if (threadIdx.x == 0) flags[0] = 0;
        __syncthreads();
        for (int r = 0; r < mp - 1; ++r) {
            const int* pr = pairs + r * mp;
            if (threadIdx.x < np) {
                const int p = pr[2 * threadIdx.x];
                const int q = pr[2 * threadIdx.x + 1];
                const T app = A[p * mp + p];
                const T aqq = A[q * mp + q];
                const T apq = A[p * mp + q];
                const bool safe = t_abs(apq) > zero;
                if (t_abs(apq) > tol) flags[0] = 1;
                const T d = half * (aqq - app);
                const T hyp = t_sqrt(d * d + apq * apq);
                const T sgn = d > zero ? one : (d < zero ? -one : zero);
                T t = sgn * apq / (safe ? t_abs(d) + hyp : one);
                if (d == zero) t = safe ? one : zero;
                const T c = one / t_sqrt(one + t * t);
                cs_c[threadIdx.x] = safe ? c : one;
                cs_s[threadIdx.x] = safe ? t * c : zero;
            }
            __syncthreads();
            // A <- R^T A R, one 2x2 block (pair a rows, pair b columns)
            // per item; V <- V R, one (row, pair) per item
            for (int item = threadIdx.x; item < np * np + mp * np;
                 item += blockDim.x) {
                if (item < np * np) {
                    const int a = item / np;
                    const int b = item - a * np;
                    const int pa = pr[2 * a], qa = pr[2 * a + 1];
                    const int pb = pr[2 * b], qb = pr[2 * b + 1];
                    const T ca = cs_c[a], sa = cs_s[a];
                    const T cb = cs_c[b], sb = cs_s[b];
                    const T x00 = A[pa * mp + pb], x01 = A[pa * mp + qb];
                    const T x10 = A[qa * mp + pb], x11 = A[qa * mp + qb];
                    // row coefficients: new row p = c row_p - s row_q,
                    // new row q = s row_p + c row_q (columns alike)
                    const T al[2][2] = {{ca, -sa}, {sa, ca}};
                    const T be[2][2] = {{cb, -sb}, {sb, cb}};
                    T nv[2][2];
                    for (int i = 0; i < 2; ++i) {
                        for (int j = 0; j < 2; ++j) {
                            const T diag = (al[i][0] * be[j][0]) * x00 +
                                           (al[i][1] * be[j][1]) * x11;
                            const T cross = (al[i][0] * be[j][1]) * x01 +
                                            (al[i][1] * be[j][0]) * x10;
                            nv[i][j] = diag + cross;
                        }
                    }
                    A[pa * mp + pb] = nv[0][0];
                    A[pa * mp + qb] = nv[0][1];
                    A[qa * mp + pb] = nv[1][0];
                    A[qa * mp + qb] = nv[1][1];
                } else {
                    const int it = item - np * np;
                    const int i = it / np;
                    const int b = it - i * np;
                    const int pb = pr[2 * b], qb = pr[2 * b + 1];
                    const T c = cs_c[b], s = cs_s[b];
                    const T vp = V[i * mp + pb];
                    const T vq = V[i * mp + qb];
                    V[i * mp + pb] = c * vp - s * vq;
                    V[i * mp + qb] = s * vp + c * vq;
                }
            }
            __syncthreads();
        }
        if (!flags[0]) break;
        __syncthreads();
    }

    // top-2 eigenpairs, dust clamp, X = Q sqrt(L)
    if (threadIdx.x == 0) {
        int i1 = 0;
        for (int i = 1; i < m; ++i) {
            if (A[i * mp + i] > A[i1 * mp + i1]) i1 = i;
        }
        int i2 = i1 == 0 ? 1 : 0;
        for (int i = 0; i < m; ++i) {
            if (i != i1 && A[i * mp + i] > A[i2 * mp + i2]) i2 = i;
        }
        flags[1] = i1;
        flags[2] = i2;
    }
    __syncthreads();
    const T l1 = A[flags[1] * mp + flags[1]];
    const T scale = t_max(t_abs(l1), one);
    for (int p = threadIdx.x; p < 2 * m; p += blockDim.x) {
        const int i = p >> 1;
        const int k = p & 1;
        const int top = flags[1 + k];
        T lam = A[top * mp + top];
        if (lam < zero && lam > -Eps<T>::dust() * scale) lam = zero;
        X[p] = V[i * mp + top] * t_sqrt(lam);
    }
    __syncthreads();
}

// Distances of the embedding X [m][2] (written to dout [m][m]), the CSS
// score and the valid flag of one window.
template <typename T>
__device__ void score_window(const T* X, int asize, int bsize, T wa, T wb,
                             bool valid, T* dout, T* red, T* score_out,
                             uint8_t* valid_out) {
    const int m = asize + bsize;
    T bet = T(0);
    T chain = T(0);
    for (int p = threadIdx.x; p < m * m; p += blockDim.x) {
        const int i = p / m;
        const int j = p - i * m;
        const T dx0 = X[2 * i] - X[2 * j];
        const T dx1 = X[2 * i + 1] - X[2 * j + 1];
        const T d = t_sqrt(dx0 * dx0 + dx1 * dx1);
        dout[p] = d;
        if (i < asize && j >= asize) bet += d;
        if (j == i + 1) {
            if (i < asize - 1) chain += d * wa;
            else if (i >= asize) chain += d * wb;
        }
    }
    const T bsum = block_sum<T>(bet, red);
    const T csum = block_sum<T>(chain, red);
    if (threadIdx.x == 0) {
        const T score =
            bsum / static_cast<T>(asize * bsize) - static_cast<T>(m) * csum;
        *score_out = valid ? score : T(0);
        *valid_out = valid ? 1 : 0;
    }
}

}  // namespace cssk
