// K7: the shared-stream permutation Monte-Carlo of CSS significance.
//
// Replaces divergence_tpu/kernels/perm.py: _shared_coeff,
// _shared_perm_scores and mc_significance (stream="shared"), run there
// inside _mc_stage1_all / _mc_stage2_all.  Plain torch versions:
// divergence_tpu_torch/kernels/perm.py shared_coeff_plain,
// hit_words_plain and scan_plain (the range loop: mc_shared).
//
// The host runs the chunks in ranges; for each range three launches:
//
// css_mc_coeff — the coefficient matrix M [m*m, nk*cstride] of the range's
// nk chunks, chunk kk in columns [kk*cstride, kk*cstride + chunk), the
// columns up to cstride (a multiple of 32) zero; one thread per column:
//   key_k = fold_in(mc_key, k) (threefry, threefry.cuh);
//   the m draws of column K and their ranks r_j, mix or threefry
//   (css_perm_common.cuh; perm.py:_mix_bits, _ranks);
//   M[j*m + l][col] = (u_j && !u_l ? 1/(ab) : 0) - (r_l == r_j + 1 ? cw(r_j) : 0)
// with u_j = r_j < a and cw = (a+b) w_a on the a-chain, (a+b) w_b on the
// b-chain.  The three float32 constants come from the host, rounded as
// the JAX package rounds them, and the one subtraction is the JAX one, so
// M is bit-equal to _shared_coeff.  Each thread writes one column, so a
// warp writes 32 consecutive floats of a row.
//
// css_mc_shared (kernel css_mc_shared_tile) — the range's product for
// every active window and its hit-mask epilogue, over a 2-D grid of
// (window tile, column tile), window tiles varying fastest so the blocks
// in flight share one column tile of M in L2:
//   scores = D_flat[active] @ M, float32 FMAs in depth order
//     (permk::tile_gemm, 128 x 128 tiles, shared with K9);
//   hit = score >= observed (float32), for columns K < chunk with
//     offset + K < runs;
//   hits packed into words [nact, nk, cstride / 32] of uint32, bit b of
//     word q of chunk kk = column K = 32 q + b, by OR-shuffles over the 8
//     threads that hold a word's 32 columns.  A word never spans two
//     chunks, and a column tile holds whole words.
//
// css_mc_scan — the adaptive stop, one thread per active window, through
// the range's chunks in order with the update of perm.py:362-380: need =
// threshold - hits; the chunk's hits by popcount word after word, and
// where they reach need the column of the need-th set bit (pos);
// reached -> hits = threshold, n = offset + pos + 1, done; else hits +=
// chunk hits, n = offset + counted.  A done window stays frozen, so the
// results equal the single-pass loop's.  (hits, n, done) live in device
// memory between ranges; the host compacts the active windows after each.
//
// What bounds it on H100: the float32 FMA rate in css_mc_shared.  A
// range costs nact x nk*chunk x m^2 FMAs; each thread does 64 FMAs per 4 float4
// shared-memory reads, the copies of the next slabs in flight meanwhile.
// 16 k windows x 200 k permutations at m = 21 is 1.4e12 FMAs, ~42 ms at
// the 67 TFLOP/s float32 peak.  Windows that stop inside a range still
// pay for the rest of it: the host keeps the first range short and grows
// later ones (perm.py:range_chunks).  The hit words are 1/32 of the
// scores' bytes; the scan reads them once.
#include "css_perm_common.cuh"
#include "fet_common.cuh"
#include "threefry.cuh"

namespace {

using permk::kMaxM;
using permk::kTC;
using permk::kThreads;
using permk::kTW;
using permk::kWordBits;

constexpr int kCoeffThreads = 128;
constexpr int kScanThreads = 128;
constexpr int64_t kMaxGridY = 65535;

__global__ void __launch_bounds__(kCoeffThreads)
css_mc_coeff(uint2 mc_key, int k0, int nk, int chunk, int cstride, int m, int asize,
             int bitgen, float between, float ca, float cb,
             float* __restrict__ out) {
    const int64_t ncols = static_cast<int64_t>(nk) * cstride;
    const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (col >= ncols) return;
    const int mm = m * m;
    const int kc = k0 + static_cast<int>(col / cstride);
    const uint32_t K = static_cast<uint32_t>(col % cstride);
    if (K >= static_cast<uint32_t>(chunk)) {
        for (int e = 0; e < mm; ++e) out[static_cast<int64_t>(e) * ncols + col] = 0.0f;
        return;
    }
    const uint2 key = tf::fold_in(mc_key, static_cast<uint32_t>(kc));
    uint32_t x[kMaxM];
    int r[kMaxM];
    int ord[kMaxM];
    permk::draw(key, K, m, bitgen, x);
    permk::rank(x, m, r, ord);
    for (int j = 0; j < m; ++j) {
        const bool uj = r[j] < asize;
        const float cw = r[j] < asize - 1 ? ca
                         : (r[j] >= asize && r[j] < m - 1 ? cb : 0.0f);
        for (int l = 0; l < m; ++l) {
            const float bet = uj && !(r[l] < asize) ? between : 0.0f;
            const float chain = r[l] == r[j] + 1 ? cw : 0.0f;
            out[static_cast<int64_t>(j * m + l) * ncols + col] = bet - chain;
        }
    }
}

__global__ void __launch_bounds__(kThreads, 2)
css_mc_shared_tile(const float* __restrict__ dist, int mm,
                   const int64_t* __restrict__ active, int64_t nact,
                   const float* __restrict__ obs, const float* __restrict__ M, int64_t ldm,
                   int64_t tile0, int k0, int chunk, int cstride, int runs,
                   uint32_t* __restrict__ words) {
    permk::TileSmem& sm = permk::tile_smem();
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kTW;
    const int64_t c0 = (tile0 + blockIdx.y) * kTC;
    permk::load_tile_rows(sm, active, base, nact);
    float acc[8][8];
    permk::tile_gemm(dist, mm, M, ldm, c0, ldm, sm, acc);

    uint32_t counted = 0;   // bit j: this thread's column j counts
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int64_t c = c0 + permk::tile_column(j);
        const int64_t kk = c / cstride;
        const int64_t K = c - kk * cstride;
        if (c < ldm && K < chunk && (k0 + kk) * chunk + K < runs) counted |= 1u << j;
    }
    const int tx = threadIdx.x % 16;
    const int64_t nwords = ldm / kWordBits;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int w = permk::tile_window(i);
        const int64_t row = sm.row[w];
        const float o = row >= 0 ? obs[row] : 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            uint32_t nib = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int j = 4 * h + q;
                if (((counted >> j) & 1u) && acc[i][j] >= o) nib |= 1u << q;
            }
            // 8 threads (tx & 7 = 0..7) hold a word's 32 columns, 4 each
            uint32_t word = nib << (4 * (tx & 7));
            word |= __shfl_xor_sync(0xffffffffu, word, 1);
            word |= __shfl_xor_sync(0xffffffffu, word, 2);
            word |= __shfl_xor_sync(0xffffffffu, word, 4);
            const int64_t col = c0 + 64 * h + kWordBits * (tx >> 3);
            if ((tx & 7) == 0 && row >= 0 && col < ldm) {
                words[(base + w) * nwords + col / kWordBits] = word;
            }
        }
    }
}

__global__ void __launch_bounds__(kScanThreads)
css_mc_scan(const uint32_t* __restrict__ words, const int64_t* __restrict__ active,
            int64_t nact, int k0, int nk, int chunk, int wpc, int runs, int threshold,
            int* __restrict__ hits_g, int* __restrict__ nsc_g,
            uint8_t* __restrict__ done_g) {
    const int64_t a = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (a >= nact) return;
    const int64_t row = active[a];
    if (done_g[row]) return;
    int hits = hits_g[row];
    int nsc = nsc_g[row];
    bool done = false;
    const uint32_t* wp = words + a * static_cast<int64_t>(nk) * wpc;
    for (int kk = 0; kk < nk && !done; ++kk) {
        const int64_t offset = static_cast<int64_t>(k0 + kk) * chunk;
        const int need = threshold - hits;
        int cum = 0;
        int pos = need <= 0 ? 0 : -1;   // argmax of an all-true cum >= need
        for (int q = 0; q < wpc && pos < 0; ++q) {
            uint32_t b = wp[kk * wpc + q];
            const int c = __popc(b);
            if (cum + c >= need) {
                for (int r = need - cum; r > 1; --r) b &= b - 1;
                pos = q * kWordBits + __ffs(b) - 1;
            } else {
                cum += c;
            }
        }
        if (pos >= 0) {
            hits = threshold;
            nsc = static_cast<int>(offset) + pos + 1;
            done = true;
        } else {
            const int64_t left = static_cast<int64_t>(runs) - offset;
            hits += cum;
            nsc = static_cast<int>(offset + (left < chunk ? left : chunk));
        }
    }
    hits_g[row] = hits;
    nsc_g[row] = nsc;
    done_g[row] = static_cast<uint8_t>(done);
}

}  // namespace

FET_EXPORT int css_mc_coeff(uint32_t key0, uint32_t key1, int k0, int nk,
                            int chunk, int cstride, int m, int asize, int bitgen,
                            float between, float ca, float cb, float* out,
                            void* stream) {
    if (m > kMaxM || bitgen < 0 || bitgen > 1 || chunk <= 0 || cstride < chunk) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t ncols = static_cast<int64_t>(nk) * cstride;
    if (ncols == 0) return 0;
    const unsigned blocks =
        static_cast<unsigned>((ncols + kCoeffThreads - 1) / kCoeffThreads);
    css_mc_coeff<<<blocks, kCoeffThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        make_uint2(key0, key1), k0, nk, chunk, cstride, m, asize, bitgen, between, ca,
        cb, out);
    return static_cast<int>(cudaGetLastError());
}

FET_EXPORT int css_mc_shared(const float* dist, int m, const int64_t* active,
                             int64_t nact, const float* obs, const float* M, int k0,
                             int nk, int chunk, int cstride, int runs, uint32_t* words,
                             void* stream) {
    if (chunk <= 0 || cstride < chunk || cstride % kWordBits != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t ldm = static_cast<int64_t>(nk) * cstride;
    if (nact == 0 || ldm == 0) return 0;
    const cudaError_t attr = permk::set_tile_smem(css_mc_shared_tile);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int64_t wtiles = (nact + kTW - 1) / kTW;
    const int64_t ctiles = (ldm + kTC - 1) / kTC;
    for (int64_t t0 = 0; t0 < ctiles; t0 += kMaxGridY) {
        const dim3 grid(static_cast<unsigned>(wtiles),
                        static_cast<unsigned>(ctiles - t0 < kMaxGridY ? ctiles - t0 : kMaxGridY));
        css_mc_shared_tile<<<grid, kThreads, sizeof(permk::TileSmem),
                             static_cast<cudaStream_t>(stream)>>>(
            dist, m * m, active, nact, obs, M, ldm, t0, k0, chunk, cstride, runs, words);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

FET_EXPORT int css_mc_scan(const uint32_t* words, const int64_t* active, int64_t nact,
                           int k0, int nk, int chunk, int cstride, int runs,
                           int threshold, int* hits, int* nsc, uint8_t* done,
                           void* stream) {
    if (chunk <= 0 || cstride < chunk || cstride % kWordBits != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (nact == 0 || nk == 0) return 0;
    const unsigned blocks = static_cast<unsigned>((nact + kScanThreads - 1) / kScanThreads);
    css_mc_scan<<<blocks, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        words, active, nact, k0, nk, chunk, cstride / kWordBits, runs, threshold, hits,
        nsc, done);
    return static_cast<int>(cudaGetLastError());
}
