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
// One block per window, everything in shared memory (m <= 64):
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
#include <cfloat>

#include "fet_common.cuh"

namespace {

using namespace fetk;

constexpr int kThreads = 128;
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
    __shared__ int s_rotated;
    __shared__ int s_top[2];

    const int64_t w = blockIdx.x;
    const T* D = dis + w * m * m;
    const T zero = T(0);
    const T one = T(1);
    const T half = T(0.5);

    // 1. fill-averages + discard rule
    T part = zero;
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
    const T avg = total / static_cast<T>(m * m);
    const bool keep = nunset <= (m * m) / 2;

    // 2. d^2 of the filled matrix, row means, double centring
    for (int p = threadIdx.x; p < mp * mp; p += blockDim.x) {
        const int i = p / mp;
        const int j = p - i * mp;
        T v = zero;
        if (i < m && j < m) {
            const T d = D[i * m + j];
            const T f = d < T(0.00001) ? avg : d;
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

    // 3. cyclic Jacobi, parallel round-robin order
    for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
        if (threadIdx.x == 0) s_rotated = 0;
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
                if (t_abs(apq) > tol) s_rotated = 1;
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
        if (!s_rotated) break;
        __syncthreads();
    }

    // 4. top-2 eigenpairs, dust clamp, X = Q sqrt(L)
    if (threadIdx.x == 0) {
        int i1 = 0;
        for (int i = 1; i < m; ++i) {
            if (A[i * mp + i] > A[i1 * mp + i1]) i1 = i;
        }
        int i2 = i1 == 0 ? 1 : 0;
        for (int i = 0; i < m; ++i) {
            if (i != i1 && A[i * mp + i] > A[i2 * mp + i2]) i2 = i;
        }
        s_top[0] = i1;
        s_top[1] = i2;
    }
    __syncthreads();
    const T l1 = A[s_top[0] * mp + s_top[0]];
    const T scale = t_max(t_abs(l1), one);
    for (int p = threadIdx.x; p < 2 * m; p += blockDim.x) {
        const int i = p >> 1;
        const int k = p & 1;
        T lam = A[s_top[k] * mp + s_top[k]];
        if (lam < zero && lam > -Eps<T>::dust() * scale) lam = zero;
        X[p] = V[i * mp + s_top[k]] * t_sqrt(lam);
    }
    __syncthreads();

    // 5-6. distances (written out) and the score's two sums
    T* dout = dist_out + w * m * m;
    T bet = zero;
    T chain = zero;
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
        const bool valid = keep && npos_arr[w] > 0;
        scores[w] = valid ? score : zero;
        valid_out[w] = valid ? 1 : 0;
    }
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
