// Permutation draws, ranks and scores shared by the CSS Monte-Carlo
// kernels: K7 (css_mc.cu), K8 and K11 (css_mc_window.cu) and K9
// (css_mc_power.cu).
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
// draw / rank run loops to a runtime m (K7's css_mc_coeff); draw_unrolled
// / rank_unrolled do the same draws and compares for m up to a
// compile-time bound, so K8's, K9's and K11's x and r stay in registers
// (m <= 32; up to 24 with one compare per pair).
//
// Scores of one permutation against D (row-major m x m float32, in shared
// memory).  The plain score (kernels/perm.py:_scores_from_ranks) adds the
// float32 products D[j][l] * C[j][l], C[j][l] = bet - chain with bet = u_j
// && !u_l ? 1/(ab) : 0, chain = r_l == r_j + 1 ? cw(r_j) : 0, u_j = r_j <
// a, one after another in row-major (j, l) order from 0:
//   score_f32_nonzero — the same sum over the a*b + m - 2 nonzero terms
//                only, in the same order (K8, K9, K11; see its note for
//                why the hits and power sums are the same);
//   score_f64  — native/mc_native.cpp:272-294 step for step, in float64:
//                row totals over the smaller group, between = rt -
//                2 within, the a- and b-chains over rank-adjacent pairs,
//                s = between inv_ab - m (wa chain_a + wb chain_b).
// Build with --fmad=false: every product is rounded before its sum, as in
// the plain versions.
//
// tile_gemm — the shared stream's product D_flat [B, m^2] @ M [m^2, ldm]
// for one tile of kTW windows x kTC columns (K7's css_mc_shared and K9's
// power_shared): acc = sum_e D[w][e] M[e][c] as float32 FMAs in e order
// from 0, so every score equals the one-column-per-thread loop it
// replaced bit for bit.  A SIMT GEMM tile (no tensor cores, no TF32):
//   256 threads, each an 8 x 8 register tile: windows ty*4 + {0..3} and
//     64 + ty*4 + {0..3}, columns tx*4 + {0..3} and 64 + tx*4 + {0..3}
//     (ty = tid / 16, tx = tid % 16), so each depth step reads 2 float4 of D
//     and 2 of M from shared memory for 64 FMAs;
//   the depth m^2 in slabs of kE, staged by cp.async in a kStages ring with
//     one barrier per slab: M as 16-byte copies of 4 columns (ldm is a
//     multiple of 4), D as 4-byte copies gathered through the tile's row
//     index and stored transposed, [kE][kTW + kDPad];
//   the ragged edges (windows past the tile's rows, columns at or past
//     climit, depth past m^2) are zero-filled by the copies, and a zero
//     product leaves a sum unchanged.
#pragma once

#include <cstdint>

#include "threefry.cuh"

namespace permk {

constexpr int kMaxM = 64;
constexpr int kMix = 0;
constexpr int kThreefry = 1;
constexpr int kTW = 128;         // windows per tile (shared stream)
constexpr int kTC = 128;         // columns per tile
constexpr int kThreads = 256;    // 16 x 16 threads of 8 x 8 scores
constexpr int kE = 16;           // depth per staged slab
constexpr int kStages = 3;       // cp.async ring
constexpr int kDPad = 4;         // keeps D's rows 16-byte aligned, halves bank conflicts
constexpr int kWordBits = 32;    // a chunk's columns are padded to whole hit words

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x = (x ^ (x >> 16)) * 0x7FEB352Du;
    x = (x ^ (x >> 15)) * 0x846CA68Bu;
    return x ^ (x >> 16);
}

// Draw c = K*m + j of the chunk keyed by `key`.
__device__ __forceinline__ uint32_t draw_one(uint2 key, uint32_t c, int bitgen) {
    if (bitgen == kMix) return mix32(mix32(key.x ^ c) + key.y);
    const uint2 b = tf::threefry2x32(key, 0u, c);
    return (b.x ^ b.y) >> 9;
}

// Individual l precedes individual j in the stable ascending order.
__device__ __forceinline__ int precedes(uint32_t xl, uint32_t xj, int l, int j) {
    return (xj > xl) || (xj == xl && j > l);
}

// The m draws of permutation K of the chunk keyed by `key`.
__device__ __forceinline__ void draw(uint2 key, uint32_t K, int m, int bitgen,
                                     uint32_t* x) {
    for (int j = 0; j < m; ++j) {
        x[j] = draw_one(key, K * static_cast<uint32_t>(m) + static_cast<uint32_t>(j), bitgen);
    }
}

// r[j] = rank of individual j; ord[r[j]] = j.
__device__ __forceinline__ void rank(const uint32_t* x, int m, int* r, int* ord) {
    for (int j = 0; j < m; ++j) {
        const uint32_t xj = x[j];
        int rj = 0;
        for (int l = 0; l < m; ++l) rj += precedes(x[l], xj, l, j);
        r[j] = rj;
        ord[rj] = j;
    }
}

// draw and rank for m <= MB, a compile-time bound: the loops unroll in
// full (each stops at m by a warp-uniform branch), so x and r are indexed
// by constants and live in registers.  For MB > 32 only the inner loops
// unroll (4096 compares of code would not fit the instruction cache), so
// x and r go to local memory there.  The same draws and compares as
// draw / rank, so the same ranks.
template <int MB>
__device__ __forceinline__ void draw_unrolled(uint2 key, uint32_t K, int m, int bitgen,
                                              uint32_t (&x)[MB]) {
    const uint32_t base = K * static_cast<uint32_t>(m);
    if (bitgen == kMix) {
#pragma unroll
        for (int j = 0; j < MB; ++j) {
            if (j >= m) break;
            x[j] = draw_one(key, base + static_cast<uint32_t>(j), kMix);
        }
    } else {
#pragma unroll
        for (int j = 0; j < MB; ++j) {
            if (j >= m) break;
            x[j] = draw_one(key, base + static_cast<uint32_t>(j), kThreefry);
        }
    }
}

template <int MB>
__device__ __forceinline__ int rank_of(const uint32_t (&x)[MB], int m, int j) {
    const uint32_t xj = x[j];
    int rj = 0;
#pragma unroll
    for (int l = 0; l < MB; ++l) {
        if (l >= m) break;
        rj += precedes(x[l], xj, l, j);
    }
    return rj;
}

template <int MB>
__device__ __forceinline__ void rank_unrolled(const uint32_t (&x)[MB], int m, int (&r)[MB]) {
    if constexpr (MB <= 24) {
        // one compare per pair: l < j precedes j iff x_l <= x_j
#pragma unroll
        for (int j = 0; j < MB; ++j) {
            if (j >= m) break;
            r[j] = 0;
        }
#pragma unroll
        for (int j = 1; j < MB; ++j) {
            if (j >= m) break;
#pragma unroll
            for (int l = 0; l < j; ++l) {
                const bool c = x[l] <= x[j];
                r[j] += c;
                r[l] += !c;
            }
        }
    } else if constexpr (MB <= 32) {
        // one rank at a time: the pairwise form's live ranks would spill
#pragma unroll
        for (int j = 0; j < MB; ++j) {
            if (j >= m) break;
            r[j] = rank_of(x, m, j);
        }
    } else {
        for (int j = 0; j < m; ++j) r[j] = rank_of(x, m, j);
    }
}

// The float32 constants of a coefficient: 1/(ab) and the chain weights
// (a+b) w_a, (a+b) w_b, rounded as the JAX package rounds them.
struct CoeffConst {
    float between, ca, cb;
};

// The plain score over its nonzero terms only, in the same row-major (j,
// l) order.  Row j of an a-group individual (r_j < a) holds the b-group
// columns (coefficient 1/(ab)) and, when r_j < a - 1, its rank successor
// in the a-group (-(a+b) w_a); row j of a b-group individual holds only
// its rank successor when r_j < m - 1 (-(a+b) w_b).  Those are the
// a*b + m - 2 nonzero coefficients (C[j][l] = bet - chain never has both
// parts: bet needs r_l >= a, a nonzero chain r_l = r_j + 1 < a), and their
// values are exact (1/(ab) - 0, 0 - cw).  For finite D each skipped
// product is a zero, and adding a zero leaves the sum unchanged but for
// the sign of a zero sum, which a >= compare does not see: the hits equal
// the plain score's, and so do the power sums (+0 + -0 is +0, and a power
// sum that starts at +0 is never -0).  Non-finite D differs (Inf or NaN
// times a zero coefficient is NaN in the plain score), so the caller gives
// a window with any non-finite entry no hits and NaN power sums, as the
// plain score does (NaN anywhere poisons every sum, and an Inf of a
// symmetric D meets a zero coefficient at (j, l) or (l, j) in every
// permutation, as the diagonal always does).
// The products are the window's, rounded once: pb = D * 1/(ab), pa =
// D * -(a+b) w_a, pc = D * -(a+b) w_b (the same bits as the plain score's
// D[j][l] * C[j][l] for those coefficients), so a term is one load and
// one add.  The tables are lane-interleaved shared memory: rk[j * 32] =
// r_j, ord[p * 32] = the individual at rank p, bl[s * 32] = the s-th
// b-group individual in index order; bmask has bit l set for the
// b-group.  The b-group list goes to registers once (MB a compile-time
// bound on m), so a row's loads depend on no other load and issue ahead
// of its chain of adds; the successor of an a-group row enters that chain
// after the b-group columns below it (their count, a popcount of bmask).
template <int MB>
__device__ __forceinline__ float score_f32_nonzero(const float* pb, const float* pa,
                                                   const float* pc, int m, int asize,
                                                   const uint8_t* rk, const uint8_t* ord,
                                                   const uint8_t* bl, uint64_t bmask) {
    const int bsize = m - asize;
    int blr[MB];
#pragma unroll
    for (int s = 0; s < MB; ++s) {
        if (s >= bsize) break;
        blr[s] = bl[s * 32];
    }
    float acc = 0.0f;
    for (int j = 0; j < m; ++j) {
        const int rj = rk[j * 32];
        if (rj < asize) {
            const float* row = pb + j * m;
            const bool has_star = rj < asize - 1;
            const int star = has_star ? ord[(rj + 1) * 32] : 0;
            const float sterm = pa[j * m + star];
            const int p = has_star ? __popcll(bmask & ((1ull << star) - 1ull)) : -1;
#pragma unroll
            for (int s = 0; s < MB; ++s) {
                if (s >= bsize) break;
                if (s == p) acc = __fadd_rn(acc, sterm);
                acc = __fadd_rn(acc, row[blr[s]]);
            }
            if (p == bsize) acc = __fadd_rn(acc, sterm);
        } else if (rj < m - 1) {
            acc = __fadd_rn(acc, pc[j * m + ord[(rj + 1) * 32]]);
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

// ord(p) = the individual at rank p (score_f64: a table of uint8 in the
// small forms; the large-panel body's column of its tables,
// css_perm_block.cuh); D's rows ld floats apart.
template <typename OrdAt>
__device__ __forceinline__ double score_f64_at(const float* D, int ld, const double* rowtot,
                                               OrdAt ord, int m, int asize, NativeConst c) {
    const int bsize = m - asize;
    const bool use_b = bsize <= asize;
    const int g_lo = use_b ? asize : 0;
    const int g_hi = use_b ? m : asize;
    double rt = 0.0, within = 0.0;
    for (int p = g_lo; p < g_hi; ++p) {
        const int j = ord(p);
        rt = __dadd_rn(rt, rowtot[j]);
        const float* row = D + j * ld;
        double acc = 0.0;
        for (int q = p + 1; q < g_hi; ++q) {
            acc = __dadd_rn(acc, static_cast<double>(row[ord(q)]));
        }
        within = __dadd_rn(within, acc);
    }
    const double between = __dsub_rn(rt, __dmul_rn(2.0, within));
    double chain_a = 0.0, chain_b = 0.0;
    for (int p = 0; p + 1 < asize; ++p) {
        chain_a = __dadd_rn(chain_a, static_cast<double>(D[ord(p) * ld + ord(p + 1)]));
    }
    for (int p = asize; p + 1 < m; ++p) {
        chain_b = __dadd_rn(chain_b, static_cast<double>(D[ord(p) * ld + ord(p + 1)]));
    }
    const double chains = __dadd_rn(__dmul_rn(c.wa, chain_a), __dmul_rn(c.wb, chain_b));
    return __dsub_rn(__dmul_rn(between, c.inv_ab),
                     __dmul_rn(static_cast<double>(m), chains));
}

// score_f64_at over ord[p * stride].
template <typename Ord>
__device__ __forceinline__ double score_f64(const float* D, const double* rowtot,
                                            const Ord* ord, int stride, int m,
                                            int asize, NativeConst c) {
    return score_f64_at(D, m, rowtot, [ord, stride](int p) { return int(ord[p * stride]); }, m,
                        asize, c);
}

// ---------------------------------------------------------------- tile_gemm

// The shared memory of one tile: the staged slabs and the tile's D rows
// (50,944 bytes: dynamic shared memory, see set_tile_smem).
struct TileSmem {
    __align__(16) float D[kStages][kE][kTW + kDPad];
    __align__(16) float M[kStages][kE][kTC];
    int64_t row[kTW];    // D row of each window of the tile; < 0: none
};

__device__ __forceinline__ TileSmem& tile_smem() {
    extern __shared__ __align__(16) unsigned char tile_smem_raw[];
    return *reinterpret_cast<TileSmem*>(tile_smem_raw);
}

// Let `kernel` take a TileSmem of dynamic shared memory (above 48 KB).
template <typename Kernel>
inline cudaError_t set_tile_smem(Kernel kernel) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(sizeof(TileSmem)));
}

// Fill sm.row for the tile of windows [base, base + kTW): active[a] (or a
// itself when active is null) for a < n, else -1; then a barrier.
__device__ __forceinline__ void load_tile_rows(TileSmem& sm, const int64_t* active,
                                               int64_t base, int64_t n) {
    if (threadIdx.x < kTW) {
        const int64_t a = base + threadIdx.x;
        sm.row[threadIdx.x] = a < n ? (active ? active[a] : a) : -1;
    }
    __syncthreads();
}

// Window and column of register (i, j) within the tile.
__device__ __forceinline__ int tile_window(int i) {
    return (threadIdx.x / 16) * 4 + (i & 3) + 64 * (i >> 2);
}
__device__ __forceinline__ int tile_column(int j) {
    return (threadIdx.x % 16) * 4 + (j & 3) + 64 * (j >> 2);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage depth slab `slab` into ring slot `st`.
__device__ __forceinline__ void stage_slab(const float* __restrict__ dist, int mm,
                                           const float* __restrict__ M, int64_t ldm,
                                           int64_t c0, int64_t climit, TileSmem& sm,
                                           int slab, int st) {
    const int tid = threadIdx.x;
    const int e0 = slab * kE;
    // D: kTW x kE floats, 16 consecutive threads on one row's kE entries
#pragma unroll
    for (int i = 0; i < kE * kTW / kThreads; ++i) {
        const int idx = tid + kThreads * i;
        const int e = idx % kE;
        const int w = idx / kE;
        const int64_t row = sm.row[w];
        const bool valid = row >= 0 && e0 + e < mm;
        const float* src = valid ? dist + row * mm + e0 + e : dist;
        cp_async4(&sm.D[st][e][w], src, valid);
    }
    // M: kE x kTC floats, a warp on 128 consecutive columns of one row
#pragma unroll
    for (int i = 0; i < kE * kTC / 4 / kThreads; ++i) {
        const int idx = tid + kThreads * i;
        const int e = idx / (kTC / 4);
        const int c = 4 * (idx % (kTC / 4));
        const bool valid = e0 + e < mm && c0 + c < climit;
        const float* src = valid ? M + static_cast<int64_t>(e0 + e) * ldm + c0 + c : M;
        cp_async16(&sm.M[st][e][c], src, valid);
    }
}

// acc[i][j] = sum_e D[row(tile_window(i))][e] * M[e][c0 + tile_column(j)]
// for columns below climit (0 elsewhere and for windows without a row).
// sm.row must hold the tile's rows and be visible to every thread; every
// thread of the kThreads-thread block must call it.  On return the ring is
// drained and free for reuse.
__device__ __forceinline__ void tile_gemm(const float* __restrict__ dist, int mm,
                                          const float* __restrict__ M, int64_t ldm,
                                          int64_t c0, int64_t climit, TileSmem& sm,
                                          float (&acc)[8][8]) {
    const int ty4 = (threadIdx.x / 16) * 4;
    const int tx4 = (threadIdx.x % 16) * 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
    const int nslab = (mm + kE - 1) / kE;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nslab) stage_slab(dist, mm, M, ldm, c0, climit, sm, s, s);
        cp_async_commit();
    }
    for (int t = 0; t < nslab; ++t) {
        cp_async_wait<kStages - 2>();   // this thread's copies of slab t landed
        __syncthreads();                // everyone's did; slab t - 1 is consumed
        const int next = t + kStages - 1;
        if (next < nslab) stage_slab(dist, mm, M, ldm, c0, climit, sm, next, next % kStages);
        cp_async_commit();
        const int st = t % kStages;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
            const float4 a0 = *reinterpret_cast<const float4*>(&sm.D[st][e][ty4]);
            const float4 a1 = *reinterpret_cast<const float4*>(&sm.D[st][e][ty4 + 64]);
            const float4 b0 = *reinterpret_cast<const float4*>(&sm.M[st][e][tx4]);
            const float4 b1 = *reinterpret_cast<const float4*>(&sm.M[st][e][tx4 + 64]);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();
}

}  // namespace permk
