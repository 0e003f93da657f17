// Device functions shared by the CSS scoring kernels, K5 (css_cmds.cu)
// and K6 (css_smacof.cu): fill-averages, one CMDS embedding run by one
// warp, and the distance + score epilogue.
//
//   fill_stats_warp — cells < 1e-5 are unset; avg = (sum of set cells) / m^2;
//                  the window is discarded when more than m*m/2 cells are
//                  unset (reference statistics/css/css.c:337-366), by
//                  one warp;
//   cmds_embed   — one warp: B = -0.5 (f^2 - (row_i + row_j) + grand) of
//                  the filled matrix f, then the top-2 eigenpairs by the
//                  subset route of LAPACK's dsyevx (dsytrd, dstebz, dstein,
//                  dormtr), X = Q sqrt(L) with the dust clamp
//                  (divergence_tpu/kernels/css.py:133-160);
//   score_window_warp — dist_ij = sqrt(dx0^2 + dx1^2) written out, score =
//                  mean(dist[:a, a:]) - m * sum_k w_k dist[k][k+1], and the
//                  valid flag; an invalid window scores 0; by one warp.
//
// cmds_embed, step by step (lane l owns rows l and l + 32 of the warp's
// shared-memory slab A [m][m | 1]; the odd row stride keeps a column read
// by 32 lanes free of bank conflicts; only __syncwarp, no block barrier):
//   1. f^2, its row means r_i (j in order) and the grand mean; B_ij =
//      -0.5 ((f_ij^2 - (r_i + r_j)) + grand), exactly symmetric;
//   2. Householder reduction to tridiagonal T (dsytd2, lower): for column
//      k, sigma = |A[k+2:, k]|^2 (a warp sum), beta = -sign(alpha)
//      sqrt(alpha^2 + sigma), tau = (beta - alpha) / beta, v = (1,
//      A[k+2:, k] / (alpha - beta)) kept in A's column k; p = tau A22 v
//      (each lane its own row, j in order), w = p - (tau/2)(p.v) v and
//      A22 -= v w' + w v' summed as (v_i w_j) + (w_i v_j), so A22 stays
//      exactly symmetric (both triangles are read).  Warp sums are
//      xor-butterflies: every lane holds the same bits and takes the same
//      branch;
//   3. lambda1, lambda2 by bisection on Sturm counts of T (dstebz,
//      dlaebz's count with pivmin): the two half-warps multisect one
//      eigenvalue each, 16 points per step (an interval shrinks 17x,
//      ~4 bits a step), from the Gershgorin interval to the tolerance
//      dstebz uses by default, max(ulp |T|, 2 ulp max(|lo|, |hi|),
//      pivmin) (13 steps in float64, 6 in float32);
//   4. their vectors by inverse iteration on T (dstein): lane 0 and lane 1
//      each factor T - lambda I (dgttrf, partial pivoting; pivots below
//      eps |T| raised to it, as dlagts does) and solve 3 times from fixed
//      start vectors, normalising each time; when lambda1 - lambda2 <=
//      1e-3 |T| (dstein's cluster test) the second vector is
//      re-orthogonalised against the first after each solve (any
//      orthonormal basis of that plane gives the same distances to
//      rounding, since X = Q sqrt(L));
//   5. back-transform through the reflectors (dormtr): z -= tau (v.z) v,
//      k = m-3 .. 0, both vectors at once;
//   6. dust clamp: a negative lambda within dust * max(|lambda1|, 1)
//      becomes 0 (dust 1e-9 in f64, 1e-5 in f32); a truly negative one
//      gives NaN coordinates, as the reference's sqrt does.
// Eigenvector signs are arbitrary; the distances do not depend on them.
#pragma once

#include <cfloat>

#include "fet_common.cuh"

namespace cssk {

using namespace fetk;

constexpr int kEmbedSteps = 64;   // multisection steps at most (17^64 >> any width)
constexpr int kInverseIters = 3;  // solves of the inverse iteration

template <typename T>
struct Eps;
template <>
struct Eps<float> {
    static __device__ __forceinline__ float value() { return FLT_EPSILON; }
    static __device__ __forceinline__ float safmin() { return FLT_MIN; }
    static __device__ __forceinline__ float dust() { return 1e-5f; }
};
template <>
struct Eps<double> {
    static __device__ __forceinline__ double value() { return DBL_EPSILON; }
    static __device__ __forceinline__ double safmin() { return DBL_MIN; }
    static __device__ __forceinline__ double dust() { return 1e-9; }
};

__device__ __forceinline__ float t_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double t_abs(double x) { return fabs(x); }
__device__ __forceinline__ float t_copysign(float x, float s) { return copysignf(x, s); }
__device__ __forceinline__ double t_copysign(double x, double s) { return copysign(x, s); }

// Sum of v over the warp; every lane gets the same bits.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
    for (int o = 16; o > 0; o >>= 1) v = t_min(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
    for (int o = 16; o > 0; o >>= 1) v = t_max(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
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

// Fill average and discard rule of the m x m window D, by one warp.
template <typename T>
__device__ Fill<T> fill_stats_warp(const T* D, int m, int lane) {
    T part = T(0);
    int nun = 0;
    for (int p = lane; p < m * m; p += 32) {
        const T d = D[p];
        if (d < T(0.00001)) {
            ++nun;
        } else {
            part += d;
        }
    }
    const T total = warp_sum(part);
    const int nunset = warp_sum(nun);
    return {total / static_cast<T>(m * m), nunset <= (m * m) / 2};
}

// Elements of T of cmds_embed's scratch: the slab A [m][m | 1] and 17
// vectors of m (d, e, e^2, tau, p/w, two eigenvectors, and per vector the
// LU factors dd, du, du2, dl and the pivots).
__host__ __device__ constexpr int cmds_scratch(int m) { return m * (m | 1) + 17 * m; }

// Eigenvalues of the tridiagonal T (d, e2 = e^2) below x: dlaebz's count
// of non-positive pivots, a pivot smaller than pivmin taken as -pivmin.
template <typename T>
__device__ __forceinline__ int sturm_count(const T* d, const T* e2, int m, T x, T pivmin) {
    T q = d[0] - x;
    if (t_abs(q) < pivmin) q = -pivmin;
    int n = q <= T(0);
    for (int i = 1; i < m; ++i) {
        q = (d[i] - e2[i - 1] / q) - x;
        if (t_abs(q) < pivmin) q = -pivmin;
        n += q <= T(0);
    }
    return n;
}

// LU factors of T - lam I with partial pivoting (dgttrf): dd, du, du2, dl,
// pv (1.0 where rows i and i+1 were swapped); pivots below ptol in
// magnitude become +-ptol (dlagts' perturbation).  One lane.
template <typename T>
__device__ void tri_factor(const T* d, const T* e, int m, T lam, T ptol, T* dd, T* du,
                           T* du2, T* dl, T* pv) {
    for (int i = 0; i < m; ++i) {
        dd[i] = d[i] - lam;
        du2[i] = T(0);
        pv[i] = T(0);
    }
    for (int i = 0; i + 1 < m; ++i) {
        du[i] = e[i];
        dl[i] = e[i];
    }
    for (int i = 0; i + 1 < m; ++i) {
        if (t_abs(dd[i]) >= t_abs(dl[i])) {
            if (dd[i] != T(0)) {
                const T fact = dl[i] / dd[i];
                dl[i] = fact;
                dd[i + 1] = dd[i + 1] - fact * du[i];
            }
        } else {
            const T fact = dd[i] / dl[i];
            dd[i] = dl[i];
            dl[i] = fact;
            const T temp = du[i];
            du[i] = dd[i + 1];
            dd[i + 1] = temp - fact * dd[i + 1];
            if (i + 2 < m) {
                du2[i] = du[i + 1];
                du[i + 1] = -fact * du[i + 1];
            }
            pv[i] = T(1);
        }
    }
    for (int i = 0; i < m; ++i) {
        if (t_abs(dd[i]) < ptol) dd[i] = dd[i] < T(0) ? -ptol : ptol;
    }
}

// b <- (T - lam I)^-1 b from tri_factor's factors (dgttrs), then b
// scaled to unit 2-norm.  One lane.
template <typename T>
__device__ void tri_solve(const T* dd, const T* du, const T* du2, const T* dl, const T* pv,
                          int m, T* b) {
    for (int i = 0; i + 1 < m; ++i) {
        if (pv[i] == T(0)) {
            b[i + 1] = b[i + 1] - dl[i] * b[i];
        } else {
            const T temp = b[i];
            b[i] = b[i + 1];
            b[i + 1] = temp - dl[i] * b[i];
        }
    }
    b[m - 1] = b[m - 1] / dd[m - 1];
    if (m > 1) b[m - 2] = (b[m - 2] - du[m - 2] * b[m - 1]) / dd[m - 2];
    for (int i = m - 3; i >= 0; --i) {
        b[i] = ((b[i] - du[i] * b[i + 1]) - du2[i] * b[i + 2]) / dd[i];
    }
    T mx = T(0);
    for (int i = 0; i < m; ++i) mx = t_max(mx, t_abs(b[i]));
    if (!(mx > T(0))) return;   // zero (or NaN): nothing to scale
    T s = T(0);
    for (int i = 0; i < m; ++i) {
        b[i] = b[i] / mx;
        s += b[i] * b[i];
    }
    const T inv = T(1) / t_sqrt(s);
    for (int i = 0; i < m; ++i) b[i] = b[i] * inv;
}

// The fixed start vector of inverse iteration c: entries in (-1, 1) from
// an integer hash of (i, c).
template <typename T>
__device__ __forceinline__ T start_entry(int i, int c) {
    uint32_t h = static_cast<uint32_t>(i * 2 + c + 1) * 0x9E3779B9u;
    h ^= h >> 15;
    h *= 0x2C1B3C6Du;
    h ^= h >> 12;
    return static_cast<T>(static_cast<int>(h >> 8) - (1 << 23)) / static_cast<T>(1 << 23);
}

// CMDS embedding X [m][2] of the window D filled with avg, run by one
// warp (every lane must call it); S holds cmds_scratch(m) elements of
// the warp's shared memory.  Returns the multisection steps taken.  Ends
// with __syncwarp.
template <typename T>
__device__ int cmds_embed(const T* D, int m, T avg, T* S, T* X) {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int ld = m | 1;
    T* A = S;                  // [m][ld]
    T* dv = A + m * ld;        // diagonal of T
    T* ev = dv + m;            // off-diagonal of T
    T* e2 = ev + m;            // its squares
    T* tau = e2 + m;           // reflector scales
    T* pw = tau + m;           // row means, then p and w of a reflector
    T* z = pw + m;             // [2][m] eigenvectors
    T* lu = z + 2 * m;         // [2][5][m] LU factors and pivots
    const T zero = T(0);
    const T one = T(1);
    const T half = T(0.5);
    const T eps = Eps<T>::value();

    // 1. f^2, row means, double centring
    for (int i = lane; i < m; i += 32) {
        T s = zero;
        for (int j = 0; j < m; ++j) {
            const T f = filled(D[i * m + j], avg);
            const T v = f * f;
            A[i * ld + j] = v;
            s += v;
        }
        pw[i] = s / static_cast<T>(m);
    }
    __syncwarp();
    T gpart = zero;
    for (int i = lane; i < m; i += 32) gpart += pw[i];
    const T grand = warp_sum(gpart) / static_cast<T>(m);
    for (int i = lane; i < m; i += 32) {
        const T ri = pw[i];
        for (int j = 0; j < m; ++j) {
            // (r_i + r_j) keeps B exactly symmetric
            A[i * ld + j] = -half * ((A[i * ld + j] - (ri + pw[j])) + grand);
        }
    }
    __syncwarp();

    // 2. Householder reduction to tridiagonal form
    for (int k = 0; k + 2 < m; ++k) {
        const T alpha = A[(k + 1) * ld + k];
        T spart = zero;
        for (int i = k + 2 + lane; i < m; i += 32) spart += A[i * ld + k] * A[i * ld + k];
        const T sigma = warp_sum(spart);
        if (sigma == zero) {   // nothing to annihilate (warp-uniform)
            if (lane == 0) {
                tau[k] = zero;
                ev[k] = alpha;
            }
            continue;
        }
        const T beta = -t_copysign(t_sqrt(alpha * alpha + sigma), alpha);
        const T tk = (beta - alpha) / beta;
        const T scal = one / (alpha - beta);
        for (int i = k + 2 + lane; i < m; i += 32) A[i * ld + k] = A[i * ld + k] * scal;
        if (lane == 0) {
            tau[k] = tk;
            ev[k] = beta;
        }
        __syncwarp();
        T pv = zero;
        for (int i = k + 1 + lane; i < m; i += 32) {
            const T* row = A + i * ld;
            T acc = row[k + 1];   // v_{k+1} = 1
            for (int j = k + 2; j < m; ++j) acc += row[j] * A[j * ld + k];
            const T p = tk * acc;
            pw[i] = p;
            pv += p * (i == k + 1 ? one : A[i * ld + k]);
        }
        const T kk = half * tk * warp_sum(pv);
        for (int i = k + 1 + lane; i < m; i += 32) {
            pw[i] = pw[i] - kk * (i == k + 1 ? one : A[i * ld + k]);
        }
        __syncwarp();
        for (int i = k + 1 + lane; i < m; i += 32) {
            const T vi = i == k + 1 ? one : A[i * ld + k];
            const T wi = pw[i];
            T* row = A + i * ld;
            for (int j = k + 1; j < m; ++j) {
                const T vj = j == k + 1 ? one : A[j * ld + k];
                row[j] = row[j] - (vi * pw[j] + wi * vj);
            }
        }
        __syncwarp();
    }
    for (int i = lane; i < m; i += 32) dv[i] = A[i * ld + i];
    if (lane == 0) ev[m - 2] = A[(m - 1) * ld + m - 2];
    __syncwarp();
    for (int i = lane; i + 1 < m; i += 32) e2[i] = ev[i] * ev[i];

    // Gershgorin interval, |T|, pivmin (dstebz)
    T glo = static_cast<T>(INFINITY), ghi = -static_cast<T>(INFINITY), emax = zero;
    for (int i = lane; i < m; i += 32) {
        const T r = (i > 0 ? t_abs(ev[i - 1]) : zero) + (i + 1 < m ? t_abs(ev[i]) : zero);
        glo = t_min(glo, dv[i] - r);
        ghi = t_max(ghi, dv[i] + r);
        if (i + 1 < m) emax = t_max(emax, ev[i] * ev[i]);
    }
    glo = warp_min(glo);
    ghi = warp_max(ghi);
    emax = warp_max(emax);
    __syncwarp();
    const T pivmin = Eps<T>::safmin() * t_max(one, emax);
    const T tnorm = t_max(t_abs(glo), t_abs(ghi));
    const T fudge = T(2.1) * tnorm * eps * static_cast<T>(m);
    glo = glo - fudge - T(4.2) * pivmin;
    ghi = ghi + fudge + T(2.1) * pivmin;
    const T atol = eps * tnorm;
    const T rtol = T(2) * eps;

    // 3. multisection: half h finds ascending eigenvalue m - 1 - h
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
    const T l1 = __shfl_sync(full, mid, 0);
    const T l2 = __shfl_sync(full, mid, 16);

    // 4. inverse iteration, lane c for eigenvector c
    const bool close = (l1 - l2) <= T(1e-3) * tnorm;
    const T ptol = t_max(eps * tnorm, Eps<T>::safmin());
    if (lane < 2) {
        T* f = lu + lane * 5 * m;
        tri_factor(dv, ev, m, lane == 0 ? l1 : l2, ptol, f, f + m, f + 2 * m, f + 3 * m,
                   f + 4 * m);
        for (int i = 0; i < m; ++i) z[lane * m + i] = start_entry<T>(i, lane);
    }
    for (int it = 0; it < kInverseIters; ++it) {
        if (lane < 2) {
            const T* f = lu + lane * 5 * m;
            tri_solve(f, f + m, f + 2 * m, f + 3 * m, f + 4 * m, m, z + lane * m);
        }
        __syncwarp();
        if (close && lane == 1) {   // z1 -= (z0 . z1) z0, normalised
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
        __syncwarp();
    }

    // 5. back-transform through the reflectors
    for (int k = m - 3; k >= 0; --k) {
        const T tk = tau[k];
        if (tk == zero) continue;
        T s0 = zero, s1 = zero;
        for (int i = k + 1 + lane; i < m; i += 32) {
            const T vi = i == k + 1 ? one : A[i * ld + k];
            s0 += vi * z[i];
            s1 += vi * z[m + i];
        }
        s0 = tk * warp_sum(s0);
        s1 = tk * warp_sum(s1);
        for (int i = k + 1 + lane; i < m; i += 32) {
            const T vi = i == k + 1 ? one : A[i * ld + k];
            z[i] = z[i] - s0 * vi;
            z[m + i] = z[m + i] - s1 * vi;
        }
    }

    // 6. dust clamp, X = Q sqrt(L)
    const T scale = t_max(t_abs(l1), one);
    T lam0 = l1, lam1 = l2;
    if (lam0 < zero && lam0 > -Eps<T>::dust() * scale) lam0 = zero;
    if (lam1 < zero && lam1 > -Eps<T>::dust() * scale) lam1 = zero;
    const T r0 = t_sqrt(lam0), r1 = t_sqrt(lam1);
    for (int i = lane; i < m; i += 32) {
        X[2 * i] = z[i] * r0;
        X[2 * i + 1] = z[m + i] * r1;
    }
    __syncwarp();
    return steps;
}

// Distances of the embedding X [m][2] (written to dout [m][m]) and the
// CSS score of one window: the bet and chain partial sums of threads
// tid, tid + nthr, ... (the caller reduces them over its threads).

template <typename T>
__device__ __forceinline__ void score_terms(const T* X, int asize, int m, T wa, T wb,
                                            int tid, int nthr, T* dout, T& bet, T& chain) {
    bet = T(0);
    chain = T(0);
    for (int p = tid; p < m * m; p += nthr) {
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
}

template <typename T>
__device__ __forceinline__ void score_store(T bsum, T csum, int asize, int bsize, bool valid,
                                            T* score_out, uint8_t* valid_out) {
    const T score = bsum / static_cast<T>(asize * bsize) -
                    static_cast<T>(asize + bsize) * csum;
    *score_out = valid ? score : T(0);
    *valid_out = valid ? 1 : 0;
}

// Distances, score and valid flag of one window, by one warp.
template <typename T>
__device__ void score_window_warp(const T* X, int asize, int bsize, T wa, T wb,
                                  bool valid, T* dout, T* score_out, uint8_t* valid_out) {
    const int lane = threadIdx.x & 31;
    T bet, chain;
    score_terms(X, asize, asize + bsize, wa, wb, lane, 32, dout, bet, chain);
    const T bsum = warp_sum(bet);
    const T csum = warp_sum(chain);
    if (lane == 0) score_store(bsum, csum, asize, bsize, valid, score_out, valid_out);
}

}  // namespace cssk
