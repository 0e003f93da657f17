// Block-wide forms of css_common.cuh's device functions, for panels too
// large for one warp's shared-memory slab: the large-m kernels of K5
// (css_cmds.cu: css_cmds_block) and K6 (css_smacof.cu: css_smacof_block)
// run one window (K6: one restart) per block of kBlockThreads threads.
//
//   block_reduce — xor-butterfly in each warp, then the warps' results
//                  added in warp order through shared memory: every thread
//                  gets the same bits (so takes the same branch);
//   fill_stats_block, score_window_block — fill_stats_warp and
//                  score_window_warp with the block's threads as lanes;
//   cmds_embed_block — cmds_embed's algorithm step for step (double
//                  centring, Householder reduction, multisection on Sturm
//                  counts, inverse iteration, back-transform, dust clamp,
//                  X = Q sqrt(L)), with these changes of layout:
//     * the symmetric matrix is kept as its packed lower triangle, row i
//       at i(i+1)/2, so a window takes m(m+1)/2 + 19m elements (float64:
//       191 KB at m = 200, in shared memory; the caller puts the slab in
//       device memory where it does not fit);
//     * thread t owns rows t, t + kBlockThreads, ...: each row's sums run
//       in the warp form's order (j ascending), only the sums over rows
//       (sigma, p.v, the back-transform's dot products, the grand mean)
//       go through block_reduce instead of one warp's butterfly;
//     * the multisection runs in warp 0 exactly as in cmds_embed (two
//       half-warps, 16 Sturm counts each a step) and hands the two
//       eigenvalues to the block through shared memory; threads 0 and 1
//       run the inverse iteration as lanes 0 and 1 do.
// With --fmad=false the rank-2 update (v_i w_j) + (w_i v_j) is the same
// value in both triangles, so the packed triangle holds what the warp
// form's full matrix holds.  kernels/linalg.py top2_eig_tridiag runs the
// same steps in torch (with torch's order of sums); the tests hold both
// to LAPACK.
#pragma once

#include "css_common.cuh"

namespace cssk {

constexpr int kBlockThreads = 256;
constexpr int kBlockWarps = kBlockThreads / 32;
// bytes of shared memory a block form keeps for block_reduce and
// broadcasts, ahead of its slab; the reductions use the first
// kBcastOffset, a kernel's own int broadcasts the rest
constexpr int kRedBytes = 4 * kBlockWarps * 8;
constexpr int kBcastOffset = 2 * kBlockWarps * 8;

struct Add {
    template <typename V>
    __device__ __forceinline__ V operator()(V a, V b) const { return a + b; }
};
struct Min {
    template <typename V>
    __device__ __forceinline__ V operator()(V a, V b) const { return t_min(a, b); }
};
struct Max {
    template <typename V>
    __device__ __forceinline__ V operator()(V a, V b) const { return t_max(a, b); }
};

// op of v over the block (every thread must call it); `red` is kRedBytes
// of shared memory.  Starts and ends with __syncthreads.
template <typename V, typename Op>
__device__ __forceinline__ V block_reduce(V v, void* red, Op op) {
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    V* r = static_cast<V*>(red);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
    __syncthreads();
    V s = r[0];
    for (int q = 1; q < kBlockWarps; ++q) s = op(s, r[q]);
    return s;
}

// Two sums at once.
template <typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b, void* red) {
    a = warp_sum(a);
    b = warp_sum(b);
    T* r = static_cast<T*>(red);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
        r[threadIdx.x >> 5] = a;
        r[kBlockWarps + (threadIdx.x >> 5)] = b;
    }
    __syncthreads();
    T sa = r[0], sb = r[kBlockWarps];
    for (int q = 1; q < kBlockWarps; ++q) {
        sa += r[q];
        sb += r[kBlockWarps + q];
    }
    a = sa;
    b = sb;
}

// Element (i, j), j <= i, of a packed lower triangle.
__host__ __device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// Elements of T of cmds_embed_block's scratch: the packed triangle and
// the 17 vectors of m of cmds_embed.
__host__ __device__ constexpr int cmds_block_scratch(int m) { return m * (m + 1) / 2 + 17 * m; }

template <typename T>
__device__ Fill<T> fill_stats_block(const T* D, int m, void* red) {
    T part = T(0);
    int nun = 0;
    for (int p = threadIdx.x; p < m * m; p += kBlockThreads) {
        const T d = D[p];
        if (d < T(0.00001)) {
            ++nun;
        } else {
            part += d;
        }
    }
    const T total = block_reduce(part, red, Add());
    const int nunset = block_reduce(nun, red, Add());
    return {total / static_cast<T>(m * m), nunset <= (m * m) / 2};
}

// cmds_embed by the whole block (see the head of this file): X [m][2]
// written, the multisection steps returned (every thread).  S holds
// cmds_block_scratch(m) elements (shared or device memory).  Ends with
// __syncthreads.
template <typename T>
__device__ int cmds_embed_block(const T* D, int m, T avg, T* S, T* X, void* red) {
    const unsigned full = 0xffffffffu;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    constexpr int NT = kBlockThreads;
    T* A = S;                        // packed lower triangle
    T* dv = A + tri(m, 0);           // diagonal of T
    T* ev = dv + m;                  // off-diagonal of T
    T* e2 = ev + m;                  // its squares
    T* tau = e2 + m;                 // reflector scales
    T* pw = tau + m;                 // row means, then p and w of a reflector
    T* z = pw + m;                   // [2][m] eigenvectors
    T* lu = z + 2 * m;               // [2][5][m] LU factors and pivots
    const T zero = T(0);
    const T one = T(1);
    const T half = T(0.5);
    const T eps = Eps<T>::value();

    // 1. f^2, row means, double centring
    for (int i = tid; i < m; i += NT) {
        T s = zero;
        const T* Di = D + static_cast<int64_t>(i) * m;
        T* Ai = A + tri(i, 0);
        for (int j = 0; j < m; ++j) {
            const T f = filled(Di[j], avg);
            const T v = f * f;
            if (j <= i) Ai[j] = v;
            s += v;
        }
        pw[i] = s / static_cast<T>(m);
    }
    T gpart = zero;
    for (int i = tid; i < m; i += NT) gpart += pw[i];
    const T grand = block_reduce(gpart, red, Add()) / static_cast<T>(m);
    for (int i = tid; i < m; i += NT) {
        const T ri = pw[i];
        T* Ai = A + tri(i, 0);
        for (int j = 0; j <= i; ++j) Ai[j] = -half * ((Ai[j] - (ri + pw[j])) + grand);
    }
    __syncthreads();

    // 2. Householder reduction to tridiagonal form; v_j = A(j, k) below
    // the diagonal of column k
    for (int k = 0; k + 2 < m; ++k) {
        const T alpha = A[tri(k + 1, k)];
        T spart = zero;
        for (int i = k + 2 + tid; i < m; i += NT) {
            const T a = A[tri(i, k)];
            spart += a * a;
        }
        const T sigma = block_reduce(spart, red, Add());
        if (sigma == zero) {   // nothing to annihilate (block-uniform)
            if (tid == 0) {
                tau[k] = zero;
                ev[k] = alpha;
            }
            continue;
        }
        const T beta = -t_copysign(t_sqrt(alpha * alpha + sigma), alpha);
        const T tk = (beta - alpha) / beta;
        const T scal = one / (alpha - beta);
        for (int i = k + 2 + tid; i < m; i += NT) A[tri(i, k)] = A[tri(i, k)] * scal;
        if (tid == 0) {
            tau[k] = tk;
            ev[k] = beta;
        }
        __syncthreads();
        T pv = zero;
        for (int i = k + 1 + tid; i < m; i += NT) {
            // row i of A22 times v, j ascending: A(i, j) for j <= i from
            // row i, A(j, i) for j > i from column i
            const T* Ai = A + tri(i, 0);
            T acc = Ai[k + 1];   // v_{k+1} = 1
            int bj = tri(k + 2, 0);
            int j = k + 2;
            for (; j <= i; ++j) {
                acc += Ai[j] * A[bj + k];
                bj += j + 1;
            }
            for (; j < m; ++j) {
                acc += A[bj + i] * A[bj + k];
                bj += j + 1;
            }
            const T p = tk * acc;
            pw[i] = p;
            pv += p * (i == k + 1 ? one : A[tri(i, k)]);
        }
        const T kk = half * tk * block_reduce(pv, red, Add());
        for (int i = k + 1 + tid; i < m; i += NT) {
            pw[i] = pw[i] - kk * (i == k + 1 ? one : A[tri(i, k)]);
        }
        __syncthreads();
        for (int i = k + 1 + tid; i < m; i += NT) {
            const T vi = i == k + 1 ? one : A[tri(i, k)];
            const T wi = pw[i];
            T* Ai = A + tri(i, 0);
            Ai[k + 1] = Ai[k + 1] - (vi * pw[k + 1] + wi * one);
            int bj = tri(k + 2, 0);
            for (int j = k + 2; j <= i; ++j) {
                Ai[j] = Ai[j] - (vi * pw[j] + wi * A[bj + k]);
                bj += j + 1;
            }
        }
        __syncthreads();
    }
    for (int i = tid; i < m; i += NT) dv[i] = A[tri(i, i)];
    if (tid == 0) ev[m - 2] = A[tri(m - 1, m - 2)];
    __syncthreads();
    for (int i = tid; i + 1 < m; i += NT) e2[i] = ev[i] * ev[i];

    // Gershgorin interval, |T|, pivmin (dstebz)
    T glo = static_cast<T>(INFINITY), ghi = -static_cast<T>(INFINITY), emax = zero;
    for (int i = tid; i < m; i += NT) {
        const T r = (i > 0 ? t_abs(ev[i - 1]) : zero) + (i + 1 < m ? t_abs(ev[i]) : zero);
        glo = t_min(glo, dv[i] - r);
        ghi = t_max(ghi, dv[i] + r);
        if (i + 1 < m) emax = t_max(emax, ev[i] * ev[i]);
    }
    glo = block_reduce(glo, red, Min());
    ghi = block_reduce(ghi, red, Max());
    emax = block_reduce(emax, red, Max());
    const T pivmin = Eps<T>::safmin() * t_max(one, emax);
    const T tnorm = t_max(t_abs(glo), t_abs(ghi));
    const T fudge = T(2.1) * tnorm * eps * static_cast<T>(m);
    glo = glo - fudge - T(4.2) * pivmin;
    ghi = ghi + fudge + T(2.1) * pivmin;
    const T atol = eps * tnorm;
    const T rtol = T(2) * eps;

    // 3. multisection in warp 0: half h finds ascending eigenvalue m - 1 - h
    T* bc = static_cast<T*>(red);
    __syncthreads();   // every thread has read the last reduction
    if (tid < 32) {
        const int h = lane >> 4;
        const int target = m - 1 - h;
        T lo = glo, hi = ghi;
        int steps = 0;
        for (; steps < kEmbedSteps; ++steps) {
            const T width = hi - lo;
            const T tol = t_max(atol, t_max(pivmin, rtol * t_max(t_abs(lo), t_abs(hi))));
            const bool conv = !(width > tol);   // NaN stops too
            if (__all_sync(full, conv)) break;
            const T step = width / T(17);
            const T x = lo + static_cast<T>((lane & 15) + 1) * step;
            const bool above = sturm_count(dv, e2, m, x, pivmin) > target;
            const unsigned bits = (__ballot_sync(full, above) >> (16 * h)) & 0xffffu;
            if (!conv) {
                if (bits) {
                    const int f = __ffs(bits) - 1;
                    const T nlo = f > 0 ? lo + static_cast<T>(f) * step : lo;
                    hi = lo + static_cast<T>(f + 1) * step;
                    lo = nlo;
                } else {
                    lo = lo + T(16) * step;
                }
            }
        }
        const T mid = half * (lo + hi);
        const T m0 = __shfl_sync(full, mid, 0);
        const T m1 = __shfl_sync(full, mid, 16);
        if (lane == 0) {
            bc[0] = m0;
            bc[1] = m1;
            bc[2] = static_cast<T>(steps);
        }
    }
    __syncthreads();
    const T l1 = bc[0];
    const T l2 = bc[1];
    const int steps = static_cast<int>(bc[2]);

    // 4. inverse iteration, thread c for eigenvector c
    const bool close = (l1 - l2) <= T(1e-3) * tnorm;
    const T ptol = t_max(eps * tnorm, Eps<T>::safmin());
    if (tid < 2) {
        T* f = lu + tid * 5 * m;
        tri_factor(dv, ev, m, tid == 0 ? l1 : l2, ptol, f, f + m, f + 2 * m, f + 3 * m,
                   f + 4 * m);
        for (int i = 0; i < m; ++i) z[tid * m + i] = start_entry<T>(i, tid);
    }
    for (int it = 0; it < kInverseIters; ++it) {
        if (tid < 2) {
            const T* f = lu + tid * 5 * m;
            tri_solve(f, f + m, f + 2 * m, f + 3 * m, f + 4 * m, m, z + tid * m);
        }
        __syncthreads();
        if (close && tid == 1) {   // z1 -= (z0 . z1) z0, normalised
            T dot = zero;
            for (int i = 0; i < m; ++i) dot += z[i] * z[m + i];
            T s = zero;
            for (int i = 0; i < m; ++i) {
                z[m + i] = z[m + i] - dot * z[i];
                s += z[m + i] * z[m + i];
            }
            const T inv = one / t_sqrt(s);
            for (int i = 0; i < m; ++i) z[m + i] = z[m + i] * inv;
        }
        __syncthreads();
    }

    // 5. back-transform through the reflectors
    for (int k = m - 3; k >= 0; --k) {
        const T tk = tau[k];
        if (tk == zero) continue;
        T s0 = zero, s1 = zero;
        for (int i = k + 1 + tid; i < m; i += NT) {
            const T vi = i == k + 1 ? one : A[tri(i, k)];
            s0 += vi * z[i];
            s1 += vi * z[m + i];
        }
        block_sum2(s0, s1, red);
        s0 = tk * s0;
        s1 = tk * s1;
        for (int i = k + 1 + tid; i < m; i += NT) {
            const T vi = i == k + 1 ? one : A[tri(i, k)];
            z[i] = z[i] - s0 * vi;
            z[m + i] = z[m + i] - s1 * vi;
        }
        __syncthreads();
    }

    // 6. dust clamp, X = Q sqrt(L)
    const T scale = t_max(t_abs(l1), one);
    T lam0 = l1, lam1 = l2;
    if (lam0 < zero && lam0 > -Eps<T>::dust() * scale) lam0 = zero;
    if (lam1 < zero && lam1 > -Eps<T>::dust() * scale) lam1 = zero;
    const T r0 = t_sqrt(lam0), r1 = t_sqrt(lam1);
    for (int i = tid; i < m; i += NT) {
        X[2 * i] = z[i] * r0;
        X[2 * i + 1] = z[m + i] * r1;
    }
    __syncthreads();
    return steps;
}

// Distances, score and valid flag of one window, by the block.
template <typename T>
__device__ void score_window_block(const T* X, int asize, int bsize, T wa, T wb, bool valid,
                                   T* dout, T* score_out, uint8_t* valid_out, void* red) {
    T bet, chain;
    score_terms(X, asize, asize + bsize, wa, wb, static_cast<int>(threadIdx.x), kBlockThreads,
                dout, bet, chain);
    block_sum2(bet, chain, red);
    if (threadIdx.x == 0) score_store(bet, chain, asize, bsize, valid, score_out, valid_out);
}

}  // namespace cssk
