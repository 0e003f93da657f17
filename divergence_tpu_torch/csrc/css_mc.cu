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
// css_mc_coeff_block (kernel css_mc_coeff_groups) — the same M for
// panels past permk::kMaxM (whose per-thread x / r / ord arrays K8, K9
// and K11's register designs size):
// one block of kCoeffBlockThreads threads per (group of 32 columns, slab
// of M's rows).  A group lies in one chunk (cstride is a multiple of 32).
// The block draws the group's 32 m words into shared memory [m][32],
// ranks them there (thread e: column e % 32, individual e / 32, m
// compares), and writes its rows of M a warp per row, lane = column, so
// each store is 32 consecutive floats.  Slabs of rows split one group's
// m^2 rows over several blocks (each ranks the group again: 32 m^2
// compares, against 32 m^2 stores) so that a range of a few chunks
// still fills the card.  Where 256 m bytes of draws and ranks exceed a
// block's shared memory (m > 908) they go to device scratch, one per
// block.  The same draws, ranks, constants and subtraction: bit-equal to
// css_mc_coeff and _shared_coeff.
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
#include <algorithm>

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

constexpr int kCoeffBlockThreads = 256;
constexpr int kGroup = 32;                  // columns a block draws and ranks
constexpr int kCoeffBlocksPerSm = 4;        // blocks the row slabs aim at

__global__ void __launch_bounds__(kCoeffBlockThreads)
css_mc_coeff_groups(uint2 mc_key, int k0, int chunk, int cstride, int m, int asize,
                   int bitgen, float between, float ca, float cb, int64_t ncols,
                   int rows_per_slab, uint32_t* __restrict__ gscratch,
                   float* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int64_t blk = static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    uint32_t* xs = gscratch ? gscratch + blk * 2 * kGroup * m
                            : reinterpret_cast<uint32_t*>(smem_raw);   // [m][32] draws
    int* rs = reinterpret_cast<int*>(xs + kGroup * m);                 // [m][32] ranks
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int mm = m * m;
    const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kGroup;
    const int kc = k0 + static_cast<int>(c0 / cstride);
    const uint32_t K0 = static_cast<uint32_t>(c0 % cstride);
    const uint2 key = tf::fold_in(mc_key, static_cast<uint32_t>(kc));
    for (int e = tid; e < kGroup * m; e += kCoeffBlockThreads) {
        const uint32_t K = K0 + static_cast<uint32_t>(e & (kGroup - 1));
        const int j = e / kGroup;
        xs[e] = K < static_cast<uint32_t>(chunk)
                    ? permk::draw_one(key, K * static_cast<uint32_t>(m) + static_cast<uint32_t>(j),
                                      bitgen)
                    : 0u;
    }
    __syncthreads();
    for (int e = tid; e < kGroup * m; e += kCoeffBlockThreads) {
        const int q = e & (kGroup - 1);
        const int j = e / kGroup;
        const uint32_t xj = xs[e];
        int rj = 0;
        for (int l = 0; l < m; ++l) rj += permk::precedes(xs[l * kGroup + q], xj, l, j);
        rs[e] = rj;
    }
    __syncthreads();
    const bool valid = K0 + static_cast<uint32_t>(lane) < static_cast<uint32_t>(chunk);
    const int e0 = static_cast<int>(blockIdx.y) * rows_per_slab;
    const int e1 = min(mm, e0 + rows_per_slab);
    for (int e = e0 + warp; e < e1; e += kCoeffBlockThreads / 32) {
        float v = 0.0f;
        if (valid) {
            const int j = e / m;
            const int l = e - j * m;
            const int rj = rs[j * kGroup + lane];
            const int rl = rs[l * kGroup + lane];
            const bool uj = rj < asize;
            const float cw = rj < asize - 1 ? ca : (rj >= asize && rj < m - 1 ? cb : 0.0f);
            const float bet = uj && !(rl < asize) ? between : 0.0f;
            const float chain = rl == rj + 1 ? cw : 0.0f;
            v = bet - chain;
        }
        out[static_cast<int64_t>(e) * ncols + c0 + lane] = v;
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

namespace {

// css_mc_coeff_groups' grid for ncols columns: 32-column groups by slabs
// of *rows rows of M, the m^2 rows cut so that groups times slabs reach
// kCoeffBlocksPerSm blocks an SM (each slab at least 32 rows).
int coeff_grid(int m, int64_t ncols, int* rows, dim3* grid) {
    int device = 0, sms = 0;
    cudaError_t e;
    if ((e = cudaGetDevice(&device)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess) {
        return static_cast<int>(e);
    }
    const int64_t mm = static_cast<int64_t>(m) * m;
    const int64_t groups = std::max<int64_t>(1, ncols / kGroup);
    int64_t slabs = (static_cast<int64_t>(kCoeffBlocksPerSm) * sms + groups - 1) / groups;
    slabs = std::min((mm + 31) / 32, std::max<int64_t>(1, slabs));
    *rows = static_cast<int>((mm + slabs - 1) / slabs);
    slabs = (mm + *rows - 1) / *rows;
    if (groups > 0x7fffffff || slabs > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
    *grid = dim3(static_cast<unsigned>(groups), static_cast<unsigned>(slabs));
    return 0;
}

// Shared memory of a group's draws and ranks, 2 * 32 * m words.
size_t coeff_group_bytes(int m) { return static_cast<size_t>(2) * kGroup * m * 4; }

}  // namespace

// The form K7's coefficients take at panel size m for ncols columns: 0,
// css_mc_coeff (a column a thread, m <= kMaxM); 1, css_mc_coeff_block
// with a group's draws and ranks in shared memory (to m = 908 on Hopper);
// 2, css_mc_coeff_block with them in a device scratch of *scratch_words
// words.  Negative where the device cannot be asked.
FET_EXPORT int css_mc_coeff_form(int m, int64_t ncols, int64_t* scratch_words) {
    *scratch_words = 0;
    if (m <= kMaxM) return 0;
    const size_t limit = fetk::smem_optin();
    if (limit == 0) return -1;
    if (coeff_group_bytes(m) <= limit) return 1;
    int rows;
    dim3 grid;
    const int rc = coeff_grid(m, ncols, &rows, &grid);
    if (rc != 0) return -rc;
    *scratch_words = static_cast<int64_t>(grid.x) * grid.y * 2 * kGroup * m;
    return 2;
}

// The large-panel coefficients (m > kMaxM), on coeff_grid's grid;
// gscratch, when not null, holds 2 * 32 * m words for each of its blocks
// (css_mc_coeff_form's form 2).
FET_EXPORT int css_mc_coeff_block(uint32_t key0, uint32_t key1, int k0, int nk,
                                  int chunk, int cstride, int m, int asize, int bitgen,
                                  float between, float ca, float cb, uint32_t* gscratch,
                                  float* out, void* stream) {
    if (m < 1 || bitgen < 0 || bitgen > 1 || chunk <= 0 || cstride < chunk ||
        cstride % kGroup != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t ncols = static_cast<int64_t>(nk) * cstride;
    if (ncols == 0) return 0;
    const size_t smem = gscratch ? 0 : coeff_group_bytes(m);
    if (smem > fetk::smem_optin()) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            css_mc_coeff_groups, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    int rows;
    dim3 grid;
    const int rc = coeff_grid(m, ncols, &rows, &grid);
    if (rc != 0) return rc;
    css_mc_coeff_groups<<<grid, kCoeffBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        make_uint2(key0, key1), k0, chunk, cstride, m, asize, bitgen, between, ca, cb, ncols,
        rows, gscratch, out);
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
