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
// css_mc_coeff_block — the same M for panels past permk::kMaxM (whose
// per-thread x / r / ord arrays K8, K9 and K11's register designs size),
// in two passes over a table of per-individual facts in device scratch:
//   css_mc_coeff_rank, a warp a column: the bitonic sort of the column's
//     m keys (x_j << 16) | j (css_perm_block.cuh: in registers to 256
//     keys, else in the warp's slab of shared memory), whose slot g holds
//     the individual of rank g (the stable ascending order of
//     permk::precedes); for each individual j the fact word succ_j |
//     cls_j << 16 (succ_j the individual in the next slot, 0xffff for
//     none; cls_j 1 on the a-chain, 2 on the b-chain, else 0) and the
//     byte u_j, each [m][ncols].  No column is ranked twice.
//   css_mc_coeff_write, a block per (128 columns, 8 rows j), a warp per j,
//     4 adjacent columns a lane: the lane reads its 4 facts of j once,
//     then walks l = 0 .. m-1 reading the 4 bytes u_l and storing
//     M[j*m + l][c .. c+3] as one float4 with st.global.cs (__stcs: the
//     whole M is written once and read later, so it need not stay in L2).
//     A warp's store is 512 contiguous bytes of a row; no division a row.
//   Padding columns (K >= chunk) get u = 0 and no successor, so they come
//   out +0.0 as bet - chain = 0.0f - 0.0f.
// The same draws, ranks, constants and subtraction (bet - chain, bet from
// u_j && !u_l, chain where l == succ_j, i.e. r_l == r_j + 1): bit-equal to
// css_mc_coeff and _shared_coeff.  What bounds it: M's bytes (m^2 x
// ncols x 4); the table is 5 m ncols bytes and a column's sort
// O(m log^2 m) compare-exchanges.
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

#include "css_perm_block.cuh"
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

constexpr int kRankWarps = 8;         // columns a ranking block takes, a warp each
constexpr int kWriteWarps = 8;        // rows j a writing block takes, a warp each
constexpr int kWriteCols = 128;       // columns a writing block takes, 4 a lane
constexpr uint32_t kNoSucc = 0xffffu; // a fact word's successor field: none
constexpr int kMaxCoeffM = 65534;     // successors and the sort's indices fit 16 bits
constexpr unsigned kFullMask = 0xffffffffu;

// Column col's facts from the individual idx of rank g and the individual
// `next` of rank g + 1 (meaningless where g + 1 = m).
__device__ __forceinline__ void put_facts(int g, int idx, int next, int m, int asize,
                                          int64_t ncols, int64_t col, uint32_t* fact,
                                          uint8_t* ub) {
    const uint32_t succ = g + 1 < m ? static_cast<uint32_t>(next) : kNoSucc;
    const uint32_t cls = g < asize - 1 ? 1u : (g >= asize && g < m - 1 ? 2u : 0u);
    fact[idx * ncols + col] = succ | (cls << 16);
    ub[idx * ncols + col] = static_cast<uint8_t>(g < asize);
}

// The column's m keys (x_j << 16) | j sorted in the warp's registers, E a
// lane (permb::sort_registers): slot g holds the individual of rank g.
template <int E, int LOGE>
__device__ __forceinline__ void rank_column(uint2 key, uint32_t K, int m, int asize, int bitgen,
                                            int64_t ncols, int64_t col, uint32_t* fact,
                                            uint8_t* ub, int lane) {
    uint64_t k[E];
    const uint32_t base = K * static_cast<uint32_t>(m);
#pragma unroll
    for (int e = 0; e < E; ++e) k[e] = permb::draw_key(key, base, lane * E + e, m, bitgen);
    permb::sort_registers<E, LOGE>(k, lane);
    const int next0 = __shfl_down_sync(kFullMask, static_cast<int>(k[0] & 0xFFFF), 1);
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int g = lane * E + e;
        const int next = e + 1 < E ? static_cast<int>(k[e + 1 < E ? e + 1 : e] & 0xFFFF) : next0;
        if (g < m) put_facts(g, static_cast<int>(k[e] & 0xFFFF), next, m, asize, ncols, col, fact, ub);
    }
}

__global__ void __launch_bounds__(kRankWarps * 32)
css_mc_coeff_rank(uint2 mc_key, int k0, int chunk, int cstride, int m, int asize, int bitgen,
                  int64_t ncols, uint32_t* __restrict__ fact, uint8_t* __restrict__ ub) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t col = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
    if (col >= ncols) return;
    const uint32_t K = static_cast<uint32_t>(col % cstride);
    if (K >= static_cast<uint32_t>(chunk)) {
        for (int j = lane; j < m; j += 32) {
            fact[j * ncols + col] = kNoSucc;
            ub[j * ncols + col] = 0;
        }
        return;
    }
    const uint2 key = tf::fold_in(mc_key, static_cast<uint32_t>(k0 + col / cstride));
    const int p = permb::sort_keys(m);
    if (p <= 128) {
        rank_column<4, 2>(key, K, m, asize, bitgen, ncols, col, fact, ub, lane);
    } else if (p <= permb::kRegSortKeys) {
        rank_column<8, 3>(key, K, m, asize, bitgen, ncols, col, fact, ub, lane);
    } else {   // the keys in the warp's slab of shared memory
        uint64_t* keys = reinterpret_cast<uint64_t*>(smem_raw) + static_cast<size_t>(warp) * p;
        const uint32_t base = K * static_cast<uint32_t>(m);
        for (int g = lane; g < p; g += 32) keys[g] = permb::draw_key(key, base, g, m, bitgen);
        permb::sort_memory(keys, p, lane);
        for (int g = lane; g < m; g += 32) {
            const int next = g + 1 < m ? static_cast<int>(keys[g + 1] & 0xFFFF) : 0;
            put_facts(g, static_cast<int>(keys[g] & 0xFFFF), next, m, asize, ncols, col, fact, ub);
        }
    }
}

__global__ void __launch_bounds__(kWriteWarps * 32)
css_mc_coeff_write(int m, int64_t ncols, float between, float ca, float cb,
                   const uint32_t* __restrict__ fact, const uint8_t* __restrict__ ub,
                   float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int j = blockIdx.y * kWriteWarps + (threadIdx.x >> 5);
    const int64_t c = static_cast<int64_t>(blockIdx.x) * kWriteCols + 4 * lane;
    if (j >= m || c >= ncols) return;
    const int64_t jc = j * ncols + c;
    const uint4 f = *reinterpret_cast<const uint4*>(fact + jc);
    const uint32_t uj = *reinterpret_cast<const uint32_t*>(ub + jc);
    const uint32_t fq[4] = {f.x, f.y, f.z, f.w};
    float bet[4], cw[4];
    int succ[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        bet[q] = (uj >> (8 * q)) & 0xffu ? between : 0.0f;   // u_j && !u_l: between
        const uint32_t cls = fq[q] >> 16;
        cw[q] = cls == 1u ? ca : (cls == 2u ? cb : 0.0f);
        succ[q] = static_cast<int>(fq[q] & 0xffffu);
    }
    float* row = out + static_cast<int64_t>(j) * m * ncols + c;
    const uint8_t* ul_p = ub + c;
#pragma unroll 4
    for (int l = 0; l < m; ++l) {
        const uint32_t ul = __ldg(reinterpret_cast<const uint32_t*>(ul_p + l * ncols));
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float b = (ul >> (8 * q)) & 0xffu ? 0.0f : bet[q];
            const float chain = l == succ[q] ? cw[q] : 0.0f;
            v[q] = b - chain;
        }
        __stcs(reinterpret_cast<float4*>(row + l * ncols), make_float4(v[0], v[1], v[2], v[3]));
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

// Words of css_mc_coeff_block's scratch: the fact words [m][ncols], then
// the bytes u [m][ncols].
int64_t coeff_scratch_words(int m, int64_t ncols) {
    const int64_t e = static_cast<int64_t>(m) * ncols;
    return e + (e + 3) / 4;
}

// Shared memory a ranking warp takes: its key slab where the sort leaves
// the registers (p > kRegSortKeys keys).
size_t rank_warp_bytes(int m) {
    const int p = permb::sort_keys(m);
    return p > permb::kRegSortKeys ? static_cast<size_t>(p) * 8 : 0;
}

// Columns a ranking block takes: kRankWarps while their key slabs fit a
// block's shared memory, 0 where one does not.
int rank_warps(int m) {
    const size_t bytes = rank_warp_bytes(m);
    if (bytes == 0) return kRankWarps;
    const size_t fit = fetk::smem_optin() / bytes;
    return static_cast<int>(fit < kRankWarps ? fit : kRankWarps);
}

}  // namespace

// The form K7's coefficients take at panel size m for ncols columns: 0,
// css_mc_coeff (a column a thread, m <= kMaxM); 1, css_mc_coeff_block,
// with *scratch_words words of device scratch for its table of facts.
// Negative: the device cannot be asked (-1) or m is past kMaxCoeffM or a
// column's draws and ranks do not fit a block's shared memory (-2).
FET_EXPORT int css_mc_coeff_form(int m, int64_t ncols, int64_t* scratch_words) {
    *scratch_words = 0;
    if (m <= kMaxM) return 0;
    if (fetk::smem_optin() == 0) return -1;
    if (m > kMaxCoeffM || rank_warps(m) < 1) return -2;
    *scratch_words = coeff_scratch_words(m, ncols);
    return 1;
}

// The large-panel coefficients (m > kMaxM): css_mc_coeff_rank, then
// css_mc_coeff_write; gscratch holds css_mc_coeff_form's scratch words.
FET_EXPORT int css_mc_coeff_block(uint32_t key0, uint32_t key1, int k0, int nk,
                                  int chunk, int cstride, int m, int asize, int bitgen,
                                  float between, float ca, float cb, uint32_t* gscratch,
                                  float* out, void* stream) {
    if (m < 1 || m > kMaxCoeffM || bitgen < 0 || bitgen > 1 || chunk <= 0 ||
        cstride < chunk || cstride % kWordBits != 0 || gscratch == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t ncols = static_cast<int64_t>(nk) * cstride;
    if (ncols == 0) return 0;
    const int warps = rank_warps(m);
    if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = warps * rank_warp_bytes(m);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            css_mc_coeff_rank, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int64_t ytiles = (m + kWriteWarps - 1) / kWriteWarps;
    const int64_t xtiles = (ncols + kWriteCols - 1) / kWriteCols;
    const int64_t rblocks = (ncols + warps - 1) / warps;
    if (ytiles > kMaxGridY || xtiles > 0x7fffffff || rblocks > 0x7fffffff) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    uint32_t* fact = gscratch;
    uint8_t* ub = reinterpret_cast<uint8_t*>(gscratch + static_cast<int64_t>(m) * ncols);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    css_mc_coeff_rank<<<static_cast<unsigned>(rblocks), warps * 32, smem, st>>>(
        make_uint2(key0, key1), k0, chunk, cstride, m, asize, bitgen, ncols, fact, ub);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    css_mc_coeff_write<<<dim3(static_cast<unsigned>(xtiles), static_cast<unsigned>(ytiles)),
                         kWriteWarps * 32, 0, st>>>(m, ncols, between, ca, cb, fact, ub, out);
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
