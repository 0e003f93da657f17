// Block-wide forms of css_common.cuh's device functions, for panels too
// large for one warp's shared-memory slab: the large-m kernels of K5
// (css_cmds.cu: css_cmds_block, 256 or 512 threads a block) and K6
// (css_smacof.cu: css_smacof_block, 256) run one window per block of NT
// threads.
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
//       at i(i+1)/2, so a window takes m(m+1)/2 + 17m elements (float64:
//       187 KB at m = 200, in shared memory; the caller puts the slab in
//       device memory where it does not fit);
//     * the Householder step k is two passes over the trailing matrix
//       (R = m - k - 1 rows) and two barriers:
//         product — p = tau A22 v: row i on G consecutive threads (G the
//           largest power of two, at most 32, with G R <= NT), thread g
//           adding the columns j = k + 1 + g, + G, ... (A(i, j) from row
//           i for j <= i, from column i for j > i) into two accumulators,
//           a log2(G)-step xor tree closing the row; the rows' p_i v_i
//           summed by warp butterflies into per-warp partials;
//         update — A22 -= v w' + w v' (w = p - kk v, formed where it is
//           read: A22 -= v p' + p v' - 2 kk v v', kk from the warps' p.v
//           partials added in warp order, so the w correction needs no
//           pass of its own) over the trailing triangle, its rows paired
//           (r with R - 1 - r: R + 1 elements a pair) and each pair dealt
//           to S = NT / pairs consecutive threads, thread s taking the
//           pair's elements s, s + S, ...: every thread about
//           T / NT of the triangle's T elements;
//       the update also copies the next column to a vector and adds its
//       squares into per-warp partials, so sigma and alpha of step k + 1
//       come from one reduction that needs no barrier of its own (the
//       partials alternate between two slots by step parity);
//     * the grand mean goes through block_reduce instead of one warp's
//       butterfly;
//     * the multisection runs on every thread: half the block brackets
//       each eigenvalue, NT / 2 Sturm counts a step (cmds_embed's two
//       half-warps take 16), with cmds_embed's stopping rule; threads 0
//       and 1 run the inverse iteration as lanes 0 and 1 do, and warps 0
//       and 1 the back-transform of one eigenvector each.
// The sums of the reduction are in another order than cmds_embed's, so
// the block form is held to LAPACK through the plain version (the tests'
// tolerances), not bit for bit to a mirror; kernels/linalg.py
// top2_eig_tridiag runs the same steps in torch (with torch's order of
// sums).
#pragma once

#include "css_common.cuh"

namespace cssk {

// Bytes of shared memory a block form of NT threads keeps for its
// reductions and broadcasts, ahead of its slab: 6 slots of 8 bytes a warp
// (block_reduce and block_sum2 use the first two, cmds_embed_block's p.v
// and sigma partials the next three, a kernel's own broadcasts the last).
template <int NT>
__host__ __device__ constexpr int red_bytes() { return 6 * (NT / 32) * 8; }
template <int NT>
__host__ __device__ constexpr int bcast_offset() { return 5 * (NT / 32) * 8; }

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

// op of v over the block of NT threads (every thread must call it);
// `red` is red_bytes<NT>() of shared memory.  Starts and ends with
// __syncthreads.
template <int NT, typename V, typename Op>
__device__ __forceinline__ V block_reduce(V v, void* red, Op op) {
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    V* r = static_cast<V*>(red);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
    __syncthreads();
    V s = r[0];
    for (int q = 1; q < NT / 32; ++q) s = op(s, r[q]);
    return s;
}

// Two sums at once.
template <int NT, typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b, void* red) {
    constexpr int NW = NT / 32;
    a = warp_sum(a);
    b = warp_sum(b);
    T* r = static_cast<T*>(red);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
        r[threadIdx.x >> 5] = a;
        r[NW + (threadIdx.x >> 5)] = b;
    }
    __syncthreads();
    T sa = r[0], sb = r[NW];
    for (int q = 1; q < NW; ++q) {
        sa += r[q];
        sb += r[NW + q];
    }
    a = sa;
    b = sb;
}

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
    using type = float2;
};
template <>
struct Vec2<double> {
    using type = double2;
};

__device__ __forceinline__ float t_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double t_fma(double a, double b, double c) { return fma(a, b, c); }

// q / d for the block's small operands (0 <= q <= 1024, d >= 1), by a
// float reciprocal: (q + 0.5) / d lies at least 0.5 / d from an integer,
// beyond the reciprocal's and the product's rounding (~2e-7 of it).
__device__ __forceinline__ int small_div(int q, int d) {
    return static_cast<int>((static_cast<float>(q) + 0.5f) * __frcp_rn(static_cast<float>(d)));
}

// Element (i, j), j <= i, of a packed lower triangle.
__host__ __device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// Elements of T of cmds_embed_block's scratch: the packed triangle and
// the 17 vectors of m of cmds_embed.
__host__ __device__ constexpr int cmds_block_scratch(int m) { return m * (m + 1) / 2 + 17 * m; }

template <int NT, typename T>
__device__ Fill<T> fill_stats_block(const T* D, int m, void* red) {
    T part = T(0);
    int nun = 0;
    for (int p = threadIdx.x; p < m * m; p += NT) {
        const T d = D[p];
        if (d < T(0.00001)) {
            ++nun;
        } else {
            part += d;
        }
    }
    const T total = block_reduce<NT>(part, red, Add());
    const int nunset = block_reduce<NT>(nun, red, Add());
    return {total / static_cast<T>(m * m), nunset <= (m * m) / 2};
}


// cmds_embed by the whole block of NT threads (see the head of this
// file): X [m][2] written, the multisection steps returned (every
// thread).  S holds cmds_block_scratch(m) elements (shared or device
// memory), `red` red_bytes<NT>() of shared memory.  Ends with
// __syncthreads.
template <int NT, typename T>
__device__ int cmds_embed_block(const T* D, int m, T avg, T* S, T* X, void* red) {
    constexpr int NW = NT / 32;
    const unsigned full = 0xffffffffu;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    T* A = S;                        // packed lower triangle
    T* dv = A + tri(m, 0);           // diagonal of T
    T* ev = dv + m;                  // off-diagonal of T
    T* e2 = ev + m;                  // its squares
    T* tau = e2 + m;                 // reflector scales
    T* pw = tau + m;                 // row means
    T* z = pw + m;                   // [2][m] eigenvectors
    T* lu = z + 2 * m;               // [2][5][m] LU factors and pivots
    T* col = lu;                     // in step 2: the next column of A
    // in step 2: [m][2] p and v of the reflector, on an even element so
    // a row's pair loads as one 2-vector (S is 16-byte aligned)
    T* pvr = lu + 2 * m + ((tri(m, 0) + 9 * m) & 1);
    T* pvp = static_cast<T*>(red) + 2 * NW;   // [NW] the warps' p.v partials
    T* sgp = pvp + NW;                        // [2][NW] sigma partials by parity
    const T zero = T(0);
    const T one = T(1);
    const T half = T(0.5);
    const T eps = Eps<T>::value();

    // 1. f^2, row means, double centring; column 0 copied, its squares
    // below the subdiagonal summed (step 0's sigma)
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
    const T grand = block_reduce<NT>(gpart, red, Add()) / static_cast<T>(m);
    T spart = zero;
    for (int i = tid; i < m; i += NT) {
        const T ri = pw[i];
        T* Ai = A + tri(i, 0);
        for (int j = 0; j <= i; ++j) Ai[j] = -half * ((Ai[j] - (ri + pw[j])) + grand);
        col[i] = Ai[0];
        if (i >= 2) spart += Ai[0] * Ai[0];
    }
    spart = warp_sum(spart);
    if (lane == 0) sgp[warp] = spart;
    __syncthreads();

    // 2. Householder reduction to tridiagonal form; v_j = A(j, k) below
    // the diagonal of column k
    for (int k = 0; k + 2 < m; ++k) {
        const T* sg = sgp + (k & 1) * NW;
        T* sgn = sgp + ((k + 1) & 1) * NW;
        T sigma = sg[0];
        for (int q = 1; q < NW; ++q) sigma += sg[q];
        const T alpha = col[k + 1];
        const int R = m - k - 1;
        if (sigma == zero) {   // nothing to annihilate (block-uniform)
            if (tid == 0) {
                tau[k] = zero;
                ev[k] = alpha;
            }
            T part = zero;
            for (int i = k + 2 + tid; i < m; i += NT) {
                const T a = A[tri(i, k + 1)];
                col[i] = a;
                if (i >= k + 3) part += a * a;
            }
            part = warp_sum(part);
            if (lane == 0) sgn[warp] = part;
            __syncthreads();
            continue;
        }
        const T beta = -t_copysign(t_sqrt(alpha * alpha + sigma), alpha);
        const T tk = (beta - alpha) / beta;
        const T scal = one / (alpha - beta);
        if (tid == 0) {
            tau[k] = tk;
            ev[k] = beta;
        }

        // product pass: p_i = tk (A22 v)_i, row i on G consecutive threads
        // (G the largest power of two, at most 32, with G R <= NT), thread
        // g of the row adding j = k + 1 + g, + G, ... into two
        // accumulators; the row's threads close it by a log2(G)-step xor
        // tree, and its first thread stores p_i and v_i.  The rows take
        // the column c = A(k + 1.., k) with c_{k+1} = alpha - beta, so v =
        // scal c and p = (tk scal) (A22 c): one multiply a row, not one
        // an element
        using P2 = typename Vec2<T>::type;
        P2* pv2 = reinterpret_cast<P2*>(pvr);
        const int lgG = max(0, min(5, 31 - __clz(small_div(NT, R))));   // G R <= NT
        const int G = 1 << lgG;
        const int gi = tid & (G - 1);
        const T c1 = alpha - beta;
        const T ts = tk * scal;
        T pvw = zero;
        for (int r0 = 0; r0 < R; r0 += NT >> lgG) {   // uniform rounds
            const int i = k + 1 + r0 + (tid >> lgG);
            T acc = zero;
            if (i < m) {
                // the row part (j <= i: A(i, j) contiguous), then the
                // column part (j > i: A(j, i) at tri(j, 0) + i, its offset
                // stepped by adds), two accumulators
                const int ti = tri(i, 0);
                T acc1 = zero;
                int j = k + 1 + gi;
                if (gi == 0) {
                    acc = A[ti + j] * c1;
                    j += G;
                }
                for (; j + G <= i; j += 2 * G) {
                    acc = t_fma(A[ti + j], col[j], acc);
                    acc1 = t_fma(A[ti + j + G], col[j + G], acc1);
                }
                if (j <= i) {
                    acc = t_fma(A[ti + j], col[j], acc);
                    j += G;
                }
                int tj = tri(j, 0) + i;
                int dj = G * j + G * (G + 1) / 2;   // tri(j + G, 0) - tri(j, 0)
                for (; j + G < m; j += 2 * G) {
                    acc = t_fma(A[tj], col[j], acc);
                    tj += dj;
                    dj += G * G;
                    acc1 = t_fma(A[tj], col[j + G], acc1);
                    tj += dj;
                    dj += G * G;
                }
                if (j < m) acc = t_fma(A[tj], col[j], acc);
                acc += acc1;
            }
            for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(full, acc, o);
            if (i < m && gi == 0) {
                const T pi = ts * acc;
                const T vi = i == k + 1 ? one : col[i] * scal;
                pvw += pi * vi;
                pv2[i] = P2{pi, vi};
                if (i >= k + 2) A[tri(i, k)] = vi;
            }
        }
        pvw = warp_sum(pvw);
        if (lane == 0) pvp[warp] = pvw;
        __syncthreads();
        T pv = pvp[0];
        for (int q = 1; q < NW; ++q) pv += pvp[q];
        const T kk = half * tk * pv;

        // update pass: A22 -= v w' + w v' with w = p - kk v, that is
        // A22 -= v p' + p v' - 2 kk v v', over the trailing triangle's rows
        // paired (r, R - 1 - r: R + 1 elements together, the middle row of
        // an odd R alone), each pair on S consecutive threads (S = NT /
        // pairs), thread s taking the pair's elements s, s + S, ...: no
        // thread more than ceil((R + 1) / S) elements, two at a time, loads
        // first; the next column copied and its sigma partials
        const int H = (R + 1) / 2;
        const int S = H < NT ? small_div(NT, H) : 1;
        const int gt = small_div(tid, S), si = tid - gt * S, per = small_div(NT, S);
        const T kk2 = kk + kk;
        T part = zero;
        for (int g0 = 0; g0 < H; g0 += per) {
            const int g = g0 + gt;
            if (gt >= per || g >= H) continue;
            const int ra = g, rb = R - 1 - g;
            // the pair's elements c = si, si + S, ...: row ra holds c in
            // [0, ra], row rb (unless it is ra) c - ra - 1 for c in
            // [ra + 1, R]
            for (int h = 0; h < (rb == ra ? 1 : 2); ++h) {
                const int r = h ? rb : ra;
                const int i = k + 1 + r;
                const P2 pr = pv2[i];
                const T ci = kk2 * pr.y;
                T* Ar = A + tri(i, k + 1);
                int cj = h == 0 ? si
                                : (si > ra ? si : si + small_div(ra + S - si, S) * S) - ra - 1;
                for (; cj <= r; cj += 2 * S) {
                    const int cj1 = cj + S <= r ? cj + S : cj;
                    const P2 q0 = pv2[k + 1 + cj], q1 = pv2[k + 1 + cj1];
                    const T a0 = Ar[cj], a1 = Ar[cj1];
                    const T n0 = t_fma(ci, q0.y, t_fma(-pr.x, q0.y, t_fma(-pr.y, q0.x, a0)));
                    const T n1 = t_fma(ci, q1.y, t_fma(-pr.x, q1.y, t_fma(-pr.y, q1.x, a1)));
                    Ar[cj] = n0;
                    if (cj1 != cj) Ar[cj1] = n1;
                    if (cj == 0 && r >= 1) {   // column k + 1: the next step's
                        col[i] = n0;
                        if (r >= 2) part += n0 * n0;
                    }
                }
            }
        }
        part = warp_sum(part);
        if (lane == 0) sgn[warp] = part;
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
    glo = block_reduce<NT>(glo, red, Min());
    ghi = block_reduce<NT>(ghi, red, Max());
    emax = block_reduce<NT>(emax, red, Max());
    const T pivmin = Eps<T>::safmin() * t_max(one, emax);
    const T tnorm = t_max(t_abs(glo), t_abs(ghi));
    const T fudge = T(2.1) * tnorm * eps * static_cast<T>(m);
    glo = glo - fudge - T(4.2) * pivmin;
    ghi = ghi + fudge + T(2.1) * pivmin;
    const T atol = eps * tnorm;
    const T rtol = T(2) * eps;

    // 3. multisection by the whole block: the first NT / 2 threads find
    // ascending eigenvalue m - 1, the others m - 2, each step splitting
    // the interval into NT / 2 + 1 parts by one Sturm count a thread (so
    // ~7 steps in float64 where one warp's 17 parts took ~13); the warps'
    // ballots meet in shared memory, two barriers a step
    constexpr int HALF = NT / 2;
    unsigned* bits = reinterpret_cast<unsigned*>(static_cast<T*>(red) + 2 * NW);   // [2][NW]
    const int h = tid >= HALF;
    const int pt = tid - h * HALF;   // this thread's point of its half
    T* bc = static_cast<T*>(red);
    __syncthreads();   // every thread has read the last reduction
    T lo = glo, hi = ghi;
    int steps = 0;
    for (; steps < kEmbedSteps; ++steps) {
        // each half's interval is the same in all its threads, so `mine`
        // is uniform within a half; the block stops when both are done
        const T width = hi - lo;
        const T tol = t_max(atol, t_max(pivmin, rtol * t_max(t_abs(lo), t_abs(hi))));
        const bool mine = !(width > tol);   // NaN stops too
        const int done = __syncthreads_count(mine);
        if (done == NT) break;
        const T step = width / static_cast<T>(HALF + 1);
        const T x = lo + static_cast<T>(pt + 1) * step;
        const bool above = sturm_count(dv, e2, m, x, pivmin) > m - 1 - h;
        unsigned* slot = bits + (steps & 1) * NW;
        const unsigned ball = __ballot_sync(full, above);
        if (lane == 0) slot[warp] = ball;
        __syncthreads();
        if (!mine) {
            // the first of this half's points above the target, if any
            int f = -1;
            for (int q = h * (NW / 2); q < (h + 1) * (NW / 2); ++q) {
                const unsigned bq = slot[q];
                if (bq) {
                    f = (q - h * (NW / 2)) * 32 + __ffs(bq) - 1;
                    break;
                }
            }
            if (f >= 0) {
                const T nlo = f > 0 ? lo + static_cast<T>(f) * step : lo;
                hi = lo + static_cast<T>(f + 1) * step;
                lo = nlo;
            } else {
                lo = lo + static_cast<T>(HALF) * step;
            }
        }
    }
    const T mid = half * (lo + hi);
    if (tid == 0) bc[0] = mid;
    if (tid == HALF) bc[1] = mid;
    __syncthreads();
    const T l1 = bc[0];
    const T l2 = bc[1];

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

    // 5. back-transform through the reflectors, warp c for eigenvector c
    // (no block barrier a reflector)
    if (warp < 2) {
        T* zc = z + warp * m;
        for (int k = m - 3; k >= 0; --k) {
            const T tk = tau[k];
            if (tk == zero) continue;
            T s = zero;
            for (int i = k + 1 + lane; i < m; i += 32) {
                s += (i == k + 1 ? one : A[tri(i, k)]) * zc[i];
            }
            s = tk * warp_sum(s);
            for (int i = k + 1 + lane; i < m; i += 32) {
                zc[i] = zc[i] - s * (i == k + 1 ? one : A[tri(i, k)]);
            }
            __syncwarp();
        }
    }
    __syncthreads();

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
template <int NT, typename T>
__device__ void score_window_block(const T* X, int asize, int bsize, T wa, T wb, bool valid,
                                   T* dout, T* score_out, uint8_t* valid_out, void* red) {
    T bet, chain;
    score_terms(X, asize, asize + bsize, wa, wb, static_cast<int>(threadIdx.x), NT, dout, bet,
                chain);
    block_sum2<NT>(bet, chain, red);
    if (threadIdx.x == 0) score_store(bet, chain, asize, bsize, valid, score_out, valid_out);
}

}  // namespace cssk
