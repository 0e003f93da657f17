// Permutation draws, ranks and scores shared by the CSS Monte-Carlo
// kernels: K7 (css_mc.cu), K8 (css_mc_window.cu), K9 (css_mc_power.cu) and
// K11 (css_perm_chunk.cu).
//
// A permutation of chunk k is drawn from the chunk key fold_in(key, k)
// (threefry.cuh) as m words, and individual j's rank is its position in
// the stable ascending order of those words (divergence_tpu/kernels/
// perm.py:_ranks):
//   bitgen 0, mix:      x_j = mix32(mix32(key.x ^ c) + key.y), c = K*m + j
//                       (perm.py:_mix32, _mix_bits);
//   bitgen 1, threefry: the float32 uniform(key, (chunk, m))[K, j], held as
//                       its 23 mantissa bits (b0 ^ b1) >> 9 of
//                       threefry2x32(key, (0, K*m + j)).  The float
//                       u = 1.m - 1 is monotone in those bits, so equal
//                       floats are equal words and tie on the index.
//   r_j = #{l : x_l < x_j, or x_l == x_j and l < j}.
//
// Scores of one permutation against D (row-major m x m float32, in shared
// memory):
//   score_f32  — the float32 products D[j][l] * C[j][l] of perm.py:
//                _scores_from_ranks, C[j][l] = bet - chain with
//                bet = u_j && !u_l ? 1/(ab) : 0, chain = r_l == r_j + 1 ?
//                cw(r_j) : 0, u_j = r_j < a, added one after another in
//                row-major (j, l) order from 0 — the twin's order
//                (kernels/perm.py:_scores_from_ranks), so the two agree bit
//                for bit;
//   score_f64  — native/mc_native.cpp:272-294 step for step, in float64:
//                row totals over the smaller group, between = rt -
//                2 within, the a- and b-chains over rank-adjacent pairs,
//                s = between inv_ab - m (wa chain_a + wb chain_b).
// Build with --fmad=false: every product is rounded before its sum, as in
// the plain versions.
//
// tile_product — the shared stream's product for a tile of kTW windows and
// one column K of M per thread (K7's inner loop, also K9's): acc[w] =
// sum_e D[w][e] M[e][K] as float32 FMAs in e order.
#pragma once

#include <cstdint>

#include "threefry.cuh"

namespace permk {

constexpr int kMaxM = 64;
constexpr int kMix = 0;
constexpr int kThreefry = 1;
constexpr int kTW = 32;          // windows per tile (shared stream)
constexpr int kTC = 256;         // columns per pass = threads per block
constexpr int kE = 64;           // D entries staged per step

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x = (x ^ (x >> 16)) * 0x7FEB352Du;
    x = (x ^ (x >> 15)) * 0x846CA68Bu;
    return x ^ (x >> 16);
}

// The m draws of permutation K of the chunk keyed by `key`.
__device__ __forceinline__ void draw(uint2 key, uint32_t K, int m, int bitgen,
                                     uint32_t* x) {
    for (int j = 0; j < m; ++j) {
        const uint32_t c = K * static_cast<uint32_t>(m) + static_cast<uint32_t>(j);
        if (bitgen == kMix) {
            x[j] = mix32(mix32(key.x ^ c) + key.y);
        } else {
            const uint2 b = tf::threefry2x32(key, 0u, c);
            x[j] = (b.x ^ b.y) >> 9;
        }
    }
}

// r[j] = rank of individual j; ord[r[j]] = j.
__device__ __forceinline__ void rank(const uint32_t* x, int m, int* r, int* ord) {
    for (int j = 0; j < m; ++j) {
        const uint32_t xj = x[j];
        int rj = 0;
        for (int l = 0; l < m; ++l) {
            rj += (xj > x[l]) || (xj == x[l] && j > l);
        }
        r[j] = rj;
        ord[rj] = j;
    }
}

// The float32 constants of a coefficient: 1/(ab) and the chain weights
// (a+b) w_a, (a+b) w_b, rounded as the JAX package rounds them.
struct CoeffConst {
    float between, ca, cb;
};

__device__ __forceinline__ float score_f32(const float* D, const int* r, int m,
                                           int asize, CoeffConst c) {
    float acc = 0.0f;
    for (int j = 0; j < m; ++j) {
        const int rj = r[j];
        const bool uj = rj < asize;
        const float cw = rj < asize - 1 ? c.ca
                         : (rj >= asize && rj < m - 1 ? c.cb : 0.0f);
        const float* row = D + j * m;
        for (int l = 0; l < m; ++l) {
            const int rl = r[l];
            const float bet = uj && !(rl < asize) ? c.between : 0.0f;
            const float chain = rl == rj + 1 ? cw : 0.0f;
            acc = __fadd_rn(acc, __fmul_rn(row[l], __fsub_rn(bet, chain)));
        }
    }
    return acc;
}

// The float64 weights of mc_native: wa, wb and 1/(ab).
struct NativeConst {
    double wa, wb, inv_ab;
};

// rowtot[j] = sum_l D[j][l] in float64, l in order (mc_native.cpp:172-178).
__device__ __forceinline__ double row_total(const float* D, int m, int j) {
    double acc = 0.0;
    for (int l = 0; l < m; ++l) acc = __dadd_rn(acc, static_cast<double>(D[j * m + l]));
    return acc;
}

__device__ __forceinline__ double score_f64(const float* D, const double* rowtot,
                                            const int* ord, int m, int asize,
                                            NativeConst c) {
    const int bsize = m - asize;
    const bool use_b = bsize <= asize;
    const int g_lo = use_b ? asize : 0;
    const int g_hi = use_b ? m : asize;
    double rt = 0.0, within = 0.0;
    for (int p = g_lo; p < g_hi; ++p) {
        const int j = ord[p];
        rt = __dadd_rn(rt, rowtot[j]);
        const float* row = D + j * m;
        double acc = 0.0;
        for (int q = p + 1; q < g_hi; ++q) {
            acc = __dadd_rn(acc, static_cast<double>(row[ord[q]]));
        }
        within = __dadd_rn(within, acc);
    }
    const double between = __dsub_rn(rt, __dmul_rn(2.0, within));
    double chain_a = 0.0, chain_b = 0.0;
    for (int p = 0; p + 1 < asize; ++p) {
        chain_a = __dadd_rn(chain_a, static_cast<double>(D[ord[p] * m + ord[p + 1]]));
    }
    for (int p = asize; p + 1 < m; ++p) {
        chain_b = __dadd_rn(chain_b, static_cast<double>(D[ord[p] * m + ord[p + 1]]));
    }
    const double chains = __dadd_rn(__dmul_rn(c.wa, chain_a), __dmul_rn(c.wb, chain_b));
    return __dsub_rn(__dmul_rn(between, c.inv_ab),
                     __dmul_rn(static_cast<double>(m), chains));
}

// acc[w] = sum_e D[s_row[w]][e] * Mk[e][K] for the kTW windows of a tile
// (a row < 0 is a missing window: D = 0); M holds ncols columns.  Every
// thread of the kTC-thread block must call it (it stages D in Ds).
__device__ __forceinline__ void tile_product(const float* __restrict__ dist,
                                             const int64_t* s_row, int mm,
                                             const float* __restrict__ Mk,
                                             int64_t ncols, int K, bool in_chunk,
                                             float (&Ds)[kE][kTW], float (&acc)[kTW]) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int w = 0; w < kTW; ++w) acc[w] = 0.0f;
    for (int e0 = 0; e0 < mm; e0 += kE) {
        const int elen = min(kE, mm - e0);
        __syncthreads();   // the previous step has read Ds
        for (int i = tid; i < kE * kTW; i += kTC) {
            const int e = i / kTW;
            const int w = i - e * kTW;
            const int64_t row = s_row[w];
            Ds[e][w] = (e < elen && row >= 0) ? dist[row * mm + e0 + e] : 0.0f;
        }
        __syncthreads();
        for (int e = 0; e < elen; ++e) {
            const float mv = in_chunk ? Mk[static_cast<int64_t>(e0 + e) * ncols + K] : 0.0f;
            const float4* d4 = reinterpret_cast<const float4*>(&Ds[e][0]);
#pragma unroll
            for (int q = 0; q < kTW / 4; ++q) {
                const float4 d = d4[q];
                acc[4 * q + 0] = __fmaf_rn(d.x, mv, acc[4 * q + 0]);
                acc[4 * q + 1] = __fmaf_rn(d.y, mv, acc[4 * q + 1]);
                acc[4 * q + 2] = __fmaf_rn(d.z, mv, acc[4 * q + 2]);
                acc[4 * q + 3] = __fmaf_rn(d.w, mv, acc[4 * q + 3]);
            }
        }
    }
}

}  // namespace permk
