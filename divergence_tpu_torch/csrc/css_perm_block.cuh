// The large-panel permutation body shared by K8 and K11 (css_mc_window.cu)
// and K9's window stream (css_mc_power.cu): panels past permk::kMaxM,
// whose draws, ranks and b-group lists the small forms hold in registers
// (x[MB], r[MB], blr[MB]), in uint8 tables and in a 64-bit b-group mask.
//
// One permutation a lane, as in the small forms; a warp takes a word (32
// consecutive permutations) at a time, and every warp runs on its own
// tables, so no block barrier is needed.  The tables are lane-interleaved
// ([k][32]: lane i's entry k at k * 32 + i, so a warp's access to one k
// is 32 consecutive entries and no two lanes share a bank word):
//   x   [m][32] uint32, the lane's m draws (css_perm_common.cuh draw_one);
//   rk  [m][32] uint16, its ranks r_j = #{l : x_l < x_j, or x_l == x_j
//       and l < j} (perm.py:_ranks), counted from x a block of kRankBlock
//       individuals at a time (their draws in registers, one pass over
//       the lane's column of x per block): m^2 compares, as K7's block
//       form and the small forms do;
//   ord [m][32] uint16, the rank order (the float64 form only);
//   rowtot [m] double, the window's row totals (the float64 form only).
// 16-bit entries, so any m up to 65,535 ranks; the tables live in a
// block's shared memory where at least one warp's fit (css_mc_window_form:
// m <= 1,210 on an H100 in float32, 880 in float64), else in device
// scratch, one slab a warp of a bounded grid.
//
// The float32 score (score_scan) reads D itself, row-major from device
// memory: row j of every lane's permutation is the same row, and the warp
// walks its columns l = 0 .. m-1 together, so every read of D is one
// address for the warp (a broadcast from L1, whatever m).  Lane i forms
// C[j][l] = bet - chain from its own ranks r_j, r_l exactly as score_f32
// does (bet = u_j && !u_l ? 1/(ab) : 0, chain = r_l == r_j + 1 ? cw(r_j)
// : 0, one float32 subtraction) and the product with the same __fmul_rn:
//   kNonzero = false — every product added, row-major from 0: score_f32
//     step for step (K9's sums, null_power_sums_plain's scores);
//   kNonzero = true — zero coefficients skipped: the a*b + m - 2 nonzero
//     terms in row-major order, score_f32_nonzero's sum bit for bit (the
//     star term falls at its own column, which is its place among the
//     b-group columns by index) (K8, K11).
// So the hits and sums equal the small forms' and the plain versions' as
// those do.  The float64 form is score_f64 (mc_native's order over the
// rank order) on the 16-bit rank order; its reads of D follow the
// permutation (a gather from L1 / L2).
//
// What bounds it on H100: instruction issue.  Per permutation a lane
// does m draws, m^2 rank compares and m^2 score steps (a table load, the
// coefficient's compares and selects, a product and an add), about
// 14 m^2 operations: 560 k at m = 200, against the nonzero terms' 2 (a*b
// + m - 2) ~ 20 k that bound the work.  The walk over every column keeps
// the warp converged and D's reads uniform; a walk over each lane's own
// b-group (the small forms' loop) would gather D from 32 rows of
// addresses and diverge.
#pragma once

#include <cstdint>

#include "css_perm_common.cuh"
#include "fet_common.cuh"

namespace permb {

constexpr int kMaxWarps = 8;          // warps a block, where the tables fit
constexpr int kRankBlock = 8;         // individuals a lane ranks per pass
constexpr int kDeviceBlocksPerSm = 4; // the device-scratch form's grid
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// Bytes of one warp's tables: x, rk (and ord, rowtot for the float64 form).
__host__ __device__ constexpr size_t warp_bytes(int m, bool f64) {
    return align16(size_t(m) * 32 * 4) + align16(size_t(m) * 32 * 2) +
           (f64 ? align16(size_t(m) * 32 * 2) + align16(size_t(m) * 8) : 0);
}

struct Tables {
    uint32_t* x;
    uint16_t* rk;
    uint16_t* ord;
    double* rowtot;
};

__device__ __forceinline__ Tables carve(unsigned char* base, int m, bool f64) {
    Tables t;
    t.x = reinterpret_cast<uint32_t*>(base);
    t.rk = reinterpret_cast<uint16_t*>(base + align16(size_t(m) * 32 * 4));
    unsigned char* p = reinterpret_cast<unsigned char*>(t.rk) + align16(size_t(m) * 32 * 2);
    t.ord = f64 ? reinterpret_cast<uint16_t*>(p) : nullptr;
    t.rowtot = f64 ? reinterpret_cast<double*>(p + align16(size_t(m) * 32 * 2)) : nullptr;
    return t;
}

// Where a launch's tables go: 1, a block's shared memory, *warps warps a
// block (as many as fit, at most kMaxWarps); 2, device scratch (no warp's
// tables fit).  Either way *blocks and *bytes are the grid and scratch of
// the device-scratch form (kMaxWarps warps a block), which a launch given
// scratch takes at any m.  Negative where the device cannot be asked.
inline int table_form(int m, bool f64, int* warps, int64_t* blocks, int64_t* bytes) {
    const size_t wb = warp_bytes(m, f64);
    const size_t limit = fetk::smem_optin();
    int dev = 0, sms = 0;
    if (limit == 0 || cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
        return -1;
    }
    *blocks = static_cast<int64_t>(sms) * kDeviceBlocksPerSm;
    *bytes = static_cast<int64_t>(*blocks * kMaxWarps * wb);
    const size_t fit = limit / wb;
    *warps = fit < size_t(kMaxWarps) ? static_cast<int>(fit) : kMaxWarps;
    return fit >= 1 ? 1 : 2;
}

// This warp's tables: in the block's shared memory, or its slab of the
// device scratch when gscratch is not null.
__device__ __forceinline__ Tables warp_tables(unsigned char* smem, unsigned char* gscratch,
                                              int m, bool f64) {
    const int warp = threadIdx.x >> 5;
    const size_t wb = warp_bytes(m, f64);
    unsigned char* base =
        gscratch ? gscratch + (size_t(blockIdx.x) * (blockDim.x >> 5) + warp) * wb
                 : smem + size_t(warp) * wb;
    return carve(base, m, f64);
}

// Draw permutation K of the chunk keyed by `key` and rank it: this lane's
// column of t.x and t.rk (and t.ord for the float64 form).  Each lane
// touches only its own column, so no barrier is needed.
__device__ __forceinline__ void draw_rank(const Tables& t, uint2 key, uint32_t K, int m,
                                          int bitgen, bool f64, int lane) {
    const uint32_t base = K * static_cast<uint32_t>(m);
    if (bitgen == permk::kMix) {
        for (int j = 0; j < m; ++j) {
            t.x[j * 32 + lane] = permk::draw_one(key, base + uint32_t(j), permk::kMix);
        }
    } else {
        for (int j = 0; j < m; ++j) {
            t.x[j * 32 + lane] = permk::draw_one(key, base + uint32_t(j), permk::kThreefry);
        }
    }
    for (int j0 = 0; j0 < m; j0 += kRankBlock) {
        uint32_t xj[kRankBlock];
        int r[kRankBlock];
#pragma unroll
        for (int s = 0; s < kRankBlock; ++s) {
            xj[s] = j0 + s < m ? t.x[(j0 + s) * 32 + lane] : 0u;
            r[s] = 0;
        }
        for (int l = 0; l < m; ++l) {
            const uint32_t xl = t.x[l * 32 + lane];
#pragma unroll
            for (int s = 0; s < kRankBlock; ++s) r[s] += permk::precedes(xl, xj[s], l, j0 + s);
        }
#pragma unroll
        for (int s = 0; s < kRankBlock; ++s) {
            if (j0 + s < m) {
                t.rk[(j0 + s) * 32 + lane] = static_cast<uint16_t>(r[s]);
                if (f64) t.ord[r[s] * 32 + lane] = static_cast<uint16_t>(j0 + s);
            }
        }
    }
}

// The float32 score of this lane's ranks against D (row-major m x m in
// device memory), every column of every row in row-major order: score_f32
// (kNonzero false) or score_f32_nonzero (kNonzero true) bit for bit.
template <bool kNonzero>
__device__ __forceinline__ float score_scan(const float* __restrict__ D, const uint16_t* rk,
                                            int m, int asize, permk::CoeffConst c, int lane) {
    float acc = 0.0f;
    for (int j = 0; j < m; ++j) {
        const int rj = rk[j * 32 + lane];
        const bool uj = rj < asize;
        const float cw = rj < asize - 1 ? c.ca : (rj >= asize && rj < m - 1 ? c.cb : 0.0f);
        const float* row = D + static_cast<size_t>(j) * m;
#pragma unroll 4
        for (int l = 0; l < m; ++l) {
            const int rl = rk[l * 32 + lane];
            const float bet = uj && !(rl < asize) ? c.between : 0.0f;
            const float chain = rl == rj + 1 ? cw : 0.0f;
            const float coef = __fsub_rn(bet, chain);
            const float d = __ldg(row + l);
            if (!kNonzero || coef != 0.0f) acc = __fadd_rn(acc, __fmul_rn(d, coef));
        }
    }
    return acc;
}

// Whether any of D's m^2 entries is not finite, by the 32 lanes of a warp
// (every lane gets the answer).
__device__ __forceinline__ bool warp_nonfinite(const float* __restrict__ D, int mm, int lane) {
    bool bad = false;
    for (int i = lane; i < mm; i += 32) bad |= !isfinite(__ldg(D + i));
    return __any_sync(kFull, bad) != 0;
}

// t.rowtot[j] = mc_native's row totals of D, by the 32 lanes of a warp.
__device__ __forceinline__ void warp_row_totals(const Tables& t, const float* D, int m,
                                                int lane) {
    for (int j = lane; j < m; j += 32) t.rowtot[j] = permk::row_total(D, m, j);
    __syncwarp();
}

}  // namespace permb
