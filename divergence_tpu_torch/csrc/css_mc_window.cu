// K8: the per-window-stream permutation Monte-Carlo of CSS significance,
// and K11: one fixed chunk of it per window, the sharded step's MC.
//
// Replaces divergence_tpu/kernels/perm.py: mc_significance with
// stream="window" (_ranks, _scores_from_ranks, _perm_scores and its
// _perm_scores_mlast layout, _fold_chunk, _mix32/_mix_bits), as
// _mc_stage1_all / _mc_stage2_all run it, and in its float64 form
// native/mc_native.cpp:mc_native (perm_backend="native").  Plain torch
// versions: divergence_tpu_torch/kernels/perm.py mc_window_hit_words_plain
// (a range's hits) with mc_scan_plain, and the whole loops
// mc_significance (stream="window") and mc_native_plain.
//
// The host runs the chunks in ranges, as K7 does (perm.py: mc_window,
// range_chunks); for each range two launches:
//
// css_mc_window (kernel window_hits) — the hit words [nact, nk, cstride/32]
// of every running window over the range's nk chunks, K7's layout: bit b
// of word q of chunk kk is permutation K = 32 q + b of chunk k0 + kk, set
// where it counts (K < chunk, (k0 + kk)*chunk + K < runs) and scores >=
// the observed score.  The grid spans (window, slice of kWordsPerBlock
// words), so every range fills the card whatever the number of windows:
//   a block stages its window's D once in shared memory (the float64
//   form, with the row totals) or its products with the three nonzero
//   coefficients (the float32 form: the rounded products score_f32
//   forms), computes fold_in(wkey, k) once for each chunk of its slice,
//   and flags a D with a non-finite entry;
//   a warp takes one word, 32 consecutive permutations of one chunk: lane
//   i draws permutation K = 32 q + i (mix or threefry, css_perm_common.cuh
//   draw_unrolled), ranks it (rank_unrolled), and scores it: the float32
//   form over its a*b + m - 2 nonzero terms in the twin's row-major order
//   (score_f32_nonzero: the same hits as adding every product; a flagged
//   window has none, as in the twin, where Inf or NaN times a zero
//   coefficient is NaN), the float64 form in mc_native's order over the
//   rank order (score_f64) against the float32 observed score widened;
//   one ballot is the word.
//   The kernel is instantiated for m <= 8, 16, 24, 32 and 64; at m <= 32
//   the draws and ranks are indexed by constants and stay in registers,
//   and the ranks, the rank order and the b-group list live in
//   lane-interleaved shared memory ([k][32] bytes per warp), from where
//   the score reads them by data.
// css_mc_window_block (kernel window_hits_block) — the same words past
// kMaxM, on the large-panel body of css_perm_block.cuh (draws and 16-bit
// ranks in per-warp tables in shared memory or device scratch, the score
// a walk over every column of D's rows in row-major order): a warp task
// is a window's slice of kBlockSliceWords words; the float32 form adds
// score_f32_nonzero's terms in its order and the float64 form runs
// score_f64 on the 16-bit rank order, so the words equal the small
// forms' and the plain versions' as theirs do.  css_mc_window_form says
// which form and scratch a panel size takes on the device.
// css_mc_scan (css_mc.cu, K7's) then applies the stop rule of
// perm.py:362-380 word by word, and the host compacts the running
// windows: (p, n, hits) equal the single-pass loop's.
//
// What bounds it on H100: instruction issue (D is read once per block).
// Per permutation a lane does m draws (two mix32, ~12 integer operations
// each, or one threefry-2x32, ~70), m(m-1) rank compares and adds, and
// a*b + m - 2 float32 multiply-adds (the float64 form about C(g, 2) + g +
// m float64 adds, g the smaller group): at m = 21 some 1,500 operations
// a permutation in mix.  The score's rows diverge: in each row j some
// lanes hold an a-group individual, so the warp runs that row's b-group
// loop (b + 1 steps) in nearly every row, about twice the terms a lane
// needs; and the b-group list, star term and row loads take ~128
// registers, so 16 warps share an SM.  The range loop keeps every SM busy
// (the old kernel ran one warp per window to its stop, 997 warps on 132
// SMs), and a window that stops inside a range pays for the rest of it:
// range_chunks bounds that waste.
//
// K11 — css_perm_chunk (kernel perm_chunk) replaces
// divergence_tpu/kernels/perm.py: permutation_chunk (_perm_scores on
// keys used as given, then the counted / cumsum / argmax epilogue); plain
// torch version: kernels/perm.py permutation_chunk_plain.  It is one chunk
// of K8's float32 stream with the window's key used as given (no chunk
// fold) and K < limit counted, on K8's device body (stage_entry, perm_hit):
// the same draws, ranks, nonzero-term scores and non-finite flag, so its
// hits are K8's first chunk's when given fold_in(wkey, 0).  A chunk is
// only wpc = ceil(chunk/32) words (4 at the step's 128), so a block takes
// wpb windows (perm_chunk_windows: two words a warp, within 48 KB of
// products) and stages each window once for all of its words; its warps
// walk the (window, word) pairs, one ballot a word into shared memory.
// Then one thread a window folds its words in permutation order:
// chunk_hits (the whole chunk, no early exit), reached = chunk_hits >=
// need, and pos, the 0-based index of the need-th hit picked from its word
// by __ffs, or 0 where it never comes (the all-false argmax of
// perm.py:420) or need <= 0 (the first index meets cum >= need).
// css_perm_chunk_block (kernel perm_chunk_block) is K11 past kMaxM on
// window_hits_block's body: a warp a window, its words in order, the
// epilogue folded word by word as the words come.
#include <algorithm>
#include <type_traits>

#include "css_perm_block.cuh"
#include "css_perm_common.cuh"
#include "fet_common.cuh"
#include "threefry.cuh"

namespace {

using permk::kMaxM;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWordsPerBlock = 64;   // 8 words (256 permutations) a warp

// Bytes of a block's shared memory: the window's matrices (float64 form:
// D; float32 form: its three products pb, pa, pc), each padded to 16
// bytes, the row totals, the chunk keys, and per warp the ranks, the rank
// order and the b-group list.
__host__ __device__ constexpr int d_floats(int m) { return (m * m + 3) & ~3; }
__host__ __device__ constexpr int rowtot_doubles(int m) { return (m + 1) & ~1; }
__host__ __device__ constexpr int mat_floats(int m, bool f64) {
    return (f64 ? 1 : 3) * d_floats(m);
}
__host__ __device__ constexpr size_t smem_bytes(int m, int mb, bool f64) {
    return sizeof(float) * mat_floats(m, f64) + sizeof(double) * rowtot_doubles(m) +
           sizeof(uint2) * kWordsPerBlock + 3 * static_cast<size_t>(kWarps) * mb * 32;
}

// The lane-interleaved tables of one permutation (css_perm_common.cuh
// score_f32_nonzero): rk[j * 32] = r_j, ord[p * 32] = the individual at
// rank p, bl[s * 32] = the s-th b-group individual (rank >= a) in index
// order; returns the b-group's bit mask.
template <int MB>
__device__ __forceinline__ uint64_t rank_tables(const int (&r)[MB], int m, int asize,
                                                uint8_t* rk, uint8_t* ord, uint8_t* bl) {
    int nb = 0;
    uint64_t bmask = 0;
    if constexpr (MB <= 32) {
#pragma unroll
        for (int j = 0; j < MB; ++j) {
            if (j >= m) break;
            rk[j * 32] = static_cast<uint8_t>(r[j]);
            ord[r[j] * 32] = static_cast<uint8_t>(j);
            if (r[j] >= asize) {
                bl[32 * nb++] = static_cast<uint8_t>(j);
                bmask |= 1ull << j;
            }
        }
    } else {
        for (int j = 0; j < m; ++j) {
            rk[j * 32] = static_cast<uint8_t>(r[j]);
            ord[r[j] * 32] = static_cast<uint8_t>(j);
            if (r[j] >= asize) {
                bl[32 * nb++] = static_cast<uint8_t>(j);
                bmask |= 1ull << j;
            }
        }
    }
    return bmask;
}

// Stage entry i of a window's D into its matrices (the float64 form: D;
// the float32 form: its products with the three nonzero coefficients, dm
// floats apart); true where the entry is not finite.
template <bool kF64>
__device__ __forceinline__ bool stage_entry(float d, int i, float* mats, int dm,
                                            permk::CoeffConst cc) {
    if (kF64) {
        mats[i] = d;
    } else {
        mats[i] = __fmul_rn(d, cc.between);
        mats[dm + i] = __fmul_rn(d, -cc.ca);
        mats[2 * dm + i] = __fmul_rn(d, -cc.cb);
    }
    return !isfinite(d);
}

// Whether permutation K of the chunk keyed by ckey scores >= the observed
// score o32: this lane's draws and ranks in registers, its tables in the
// warp's lane-interleaved slabs, the score over the staged matrices.
template <int MB, bool kF64>
__device__ __forceinline__ bool perm_hit(uint2 ckey, int K, int m, int asize, int bitgen,
                                         const float* mats, const double* rowtot,
                                         uint8_t* rk, uint8_t* ord, uint8_t* bl,
                                         permk::NativeConst nc, float o32) {
    uint32_t x[MB];
    int r[MB];
    permk::draw_unrolled<MB>(ckey, static_cast<uint32_t>(K), m, bitgen, x);
    permk::rank_unrolled<MB>(x, m, r);
    const uint64_t bmask = rank_tables<MB>(r, m, asize, rk, ord, bl);
    if constexpr (kF64) {
        return permk::score_f64(mats, rowtot, ord, 32, m, asize, nc) >=
               static_cast<double>(o32);
    } else {
        const int dm = d_floats(m);
        return permk::score_f32_nonzero<MB>(mats, mats + dm, mats + 2 * dm, m, asize, rk,
                                            ord, bl, bmask) >= o32;
    }
}

template <int MB, bool kF64>
__global__ void __launch_bounds__(kThreads, 2)
window_hits(const float* __restrict__ dist, const float* __restrict__ obs,
            const int64_t* __restrict__ wkeys, const int64_t* __restrict__ active,
            int m, int asize, int k0, int nk, int chunk, int wpc, int runs, int slices,
            int bitgen, permk::CoeffConst cc, permk::NativeConst nc,
            uint32_t* __restrict__ words) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int mm = m * m;
    float* mats = reinterpret_cast<float*>(smem_raw);
    double* rowtot = reinterpret_cast<double*>(mats + mat_floats(m, kF64));
    uint2* ckeys = reinterpret_cast<uint2*>(rowtot + rowtot_doubles(m));
    uint8_t* ord_all = reinterpret_cast<uint8_t*>(ckeys + kWordsPerBlock);
    uint8_t* bl_all = ord_all + kWarps * MB * 32;
    uint8_t* rk_all = bl_all + kWarps * MB * 32;

    const int64_t a = blockIdx.x / slices;
    const int slice = static_cast<int>(blockIdx.x - a * slices);
    const int64_t row = active[a];
    const int q0 = slice * kWordsPerBlock;
    const int q1 = min(q0 + kWordsPerBlock, nk * wpc);
    const int kk0 = q0 / wpc;
    const int nck = (q1 - 1) / wpc - kk0 + 1;

    bool bad = false;
    for (int i = threadIdx.x; i < mm; i += kThreads) {
        bad |= stage_entry<kF64>(dist[row * mm + i], i, mats, d_floats(m), cc);
    }
    const uint2 wkey = make_uint2(static_cast<uint32_t>(wkeys[2 * row]),
                                  static_cast<uint32_t>(wkeys[2 * row + 1]));
    for (int t = threadIdx.x; t < nck; t += kThreads) {
        ckeys[t] = tf::fold_in(wkey, static_cast<uint32_t>(k0 + kk0 + t));
    }
    const bool flagged = __syncthreads_or(bad) != 0;
    if (kF64) {
        for (int j = threadIdx.x; j < m; j += kThreads) {
            rowtot[j] = permk::row_total(mats, m, j);
        }
        __syncthreads();
    }

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    uint8_t* ord = ord_all + warp * MB * 32 + lane;
    uint8_t* bl = bl_all + warp * MB * 32 + lane;
    uint8_t* rk = rk_all + warp * MB * 32 + lane;
    const float o32 = obs[row];
    for (int q = q0 + warp; q < q1; q += kWarps) {
        const int kk = q / wpc;
        const int qq = q - kk * wpc;
        const int K = qq * 32 + lane;
        const int64_t g = static_cast<int64_t>(k0 + kk) * chunk + K;
        bool hit = false;
        if (K < chunk && g < runs && (kF64 || !flagged)) {
            hit = perm_hit<MB, kF64>(ckeys[kk - kk0], K, m, asize, bitgen, mats, rowtot, rk,
                                     ord, bl, nc, o32);
        }
        const uint32_t b = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) words[(a * nk + kk) * wpc + qq] = b;
    }
}

// K11: one chunk of wpc words per window, the window's key used as given,
// wpb windows a block (perm_chunk_windows), then the stop epilogue.
template <int MB>
__global__ void __launch_bounds__(kThreads, 2)
perm_chunk(const float* __restrict__ dist, const float* __restrict__ obs,
           const int* __restrict__ need, const int64_t* __restrict__ keys, int64_t B,
           int m, int asize, int wpc, int limit, int wpb, int bitgen, permk::CoeffConst cc,
           int* __restrict__ hits_out, uint8_t* __restrict__ reached_out,
           int* __restrict__ pos_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int mm = m * m;
    const int dm = d_floats(m);
    float* mats = reinterpret_cast<float*>(smem_raw);                  // [wpb][3][dm]
    uint32_t* cwords = reinterpret_cast<uint32_t*>(mats + wpb * mat_floats(m, false));
    int* flag = reinterpret_cast<int*>(cwords + wpb * wpc);            // [wpb]
    uint8_t* ord_all = reinterpret_cast<uint8_t*>(flag + wpb);
    uint8_t* bl_all = ord_all + kWarps * MB * 32;
    uint8_t* rk_all = bl_all + kWarps * MB * 32;

    const int64_t w0 = static_cast<int64_t>(blockIdx.x) * wpb;
    const int nw = static_cast<int>(min(static_cast<int64_t>(wpb), B - w0));
    for (int s = threadIdx.x; s < nw; s += kThreads) flag[s] = 0;
    __syncthreads();
    const float* src = dist + w0 * mm;   // the block's windows are contiguous
    for (int i = threadIdx.x; i < nw * mm; i += kThreads) {
        const int s = i / mm;
        if (stage_entry<false>(src[i], i - s * mm, mats + s * mat_floats(m, false), dm, cc)) {
            flag[s] = 1;
        }
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    uint8_t* ord = ord_all + warp * MB * 32 + lane;
    uint8_t* bl = bl_all + warp * MB * 32 + lane;
    uint8_t* rk = rk_all + warp * MB * 32 + lane;
    for (int q = warp; q < nw * wpc; q += kWarps) {
        const int s = q / wpc;
        const int K = (q - s * wpc) * 32 + lane;
        const int64_t w = w0 + s;
        bool hit = false;
        if (K < limit && !flag[s]) {
            const uint2 key = make_uint2(static_cast<uint32_t>(keys[2 * w]),
                                         static_cast<uint32_t>(keys[2 * w + 1]));
            hit = perm_hit<MB, false>(key, K, m, asize, bitgen,
                                      mats + s * mat_floats(m, false), nullptr, rk, ord, bl,
                                      permk::NativeConst{}, obs[w]);
        }
        const uint32_t b = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) cwords[q] = b;
    }
    __syncthreads();

    // the stop epilogue, one thread a window: the words in permutation
    // order, the need-th hit's index picked from its word by __ffs
    if (threadIdx.x < nw) {
        const int s = threadIdx.x;
        const int64_t w = w0 + s;
        const int nd = need[w];
        int hits = 0;
        int pos = 0;
        bool found = nd <= 0;
        for (int qq = 0; qq < wpc; ++qq) {
            uint32_t b = cwords[s * wpc + qq];
            const int c = __popc(b);
            if (!found && hits + c >= nd) {
                for (int k = nd - hits; k > 1; --k) b &= b - 1;
                pos = qq * 32 + __ffs(b) - 1;
                found = true;
            }
            hits += c;
        }
        hits_out[w] = hits;
        reached_out[w] = hits >= nd;
        pos_out[w] = pos;
    }
}

// ------------------------------------------------- the large-panel form

// Words a warp takes per task in window_hits_block (a window's slice).
constexpr int kBlockSliceWords = 8;

// K8 past kMaxM (css_perm_block.cuh): the same hit words, every warp on
// its own tables over (active window, slice of kBlockSliceWords words)
// tasks, grid-strided.  A task flags a non-finite D (float32 forms) or
// sums its row totals (float64), then scores its words in order, the
// chunk key folded once a chunk.
template <bool kF64>
__global__ void __launch_bounds__(permb::kMaxWarps * 32)
window_hits_block(const float* __restrict__ dist, const float* __restrict__ obs,
                  const int64_t* __restrict__ wkeys, const int64_t* __restrict__ active,
                  int64_t nact, int m, int asize, int k0, int nk, int chunk, int wpc,
                  int runs, int bitgen, permk::CoeffConst cc, permk::NativeConst nc,
                  unsigned char* gscratch, uint32_t* __restrict__ words) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31;
    const permb::Tables t = permb::warp_tables(smem_raw, gscratch, m, kF64);
    const int mm = m * m;
    const int nwords = nk * wpc;
    const int slices = (nwords + kBlockSliceWords - 1) / kBlockSliceWords;
    const int64_t ntasks = nact * slices;
    const int64_t wpb = blockDim.x >> 5;
    for (int64_t task = blockIdx.x * wpb + (threadIdx.x >> 5); task < ntasks;
         task += static_cast<int64_t>(gridDim.x) * wpb) {
        const int64_t a = task / slices;
        const int slice = static_cast<int>(task - a * slices);
        const int64_t row = active[a];
        const float* D = dist + row * mm;
        bool flagged = false;
        if (kF64) {
            permb::warp_row_totals(t, D, m, lane);
        } else {
            flagged = permb::warp_nonfinite(D, mm, lane);
        }
        const uint2 wkey = make_uint2(static_cast<uint32_t>(wkeys[2 * row]),
                                      static_cast<uint32_t>(wkeys[2 * row + 1]));
        const float o32 = obs[row];
        const int q1 = min((slice + 1) * kBlockSliceWords, nwords);
        int kc = -1;
        uint2 ckey = wkey;
        for (int q = slice * kBlockSliceWords; q < q1; ++q) {
            const int kk = q / wpc;
            const int qq = q - kk * wpc;
            if (kk != kc) {
                ckey = tf::fold_in(wkey, static_cast<uint32_t>(k0 + kk));
                kc = kk;
            }
            const int K = qq * 32 + lane;
            const int64_t g = static_cast<int64_t>(k0 + kk) * chunk + K;
            const bool counts = K < chunk && g < runs;
            bool hit = false;
            if (__any_sync(permb::kFull, counts) && (kF64 || !flagged)) {
                permb::draw_rank(t, ckey, static_cast<uint32_t>(K), m, bitgen, kF64, lane);
                if (kF64) {
                    hit = counts && permk::score_f64(D, t.rowtot, t.ord + lane, 32, m, asize,
                                                     nc) >= static_cast<double>(o32);
                } else {
                    hit = counts &&
                          permb::score_scan<true>(D, t.rk, m, asize, cc, lane) >= o32;
                }
            }
            const uint32_t b = __ballot_sync(permb::kFull, hit);
            if (lane == 0) words[(a * nk + kk) * wpc + qq] = b;
        }
        __syncwarp();   // the next task rewrites rowtot
    }
}

// K11 past kMaxM: a warp a window (grid-strided), its wpc words in order,
// each word's hits folded into the stop epilogue as it comes (the small
// form's fold over its words in shared memory, the same order).
__global__ void __launch_bounds__(permb::kMaxWarps * 32)
perm_chunk_block(const float* __restrict__ dist, const float* __restrict__ obs,
                 const int* __restrict__ need, const int64_t* __restrict__ keys, int64_t B,
                 int m, int asize, int wpc, int limit, int bitgen, permk::CoeffConst cc,
                 unsigned char* gscratch, int* __restrict__ hits_out,
                 uint8_t* __restrict__ reached_out, int* __restrict__ pos_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31;
    const permb::Tables t = permb::warp_tables(smem_raw, gscratch, m, false);
    const int mm = m * m;
    const int64_t wpb = blockDim.x >> 5;
    for (int64_t w = blockIdx.x * wpb + (threadIdx.x >> 5); w < B;
         w += static_cast<int64_t>(gridDim.x) * wpb) {
        const float* D = dist + w * mm;
        const bool flagged = permb::warp_nonfinite(D, mm, lane);
        const uint2 key = make_uint2(static_cast<uint32_t>(keys[2 * w]),
                                     static_cast<uint32_t>(keys[2 * w + 1]));
        const float o32 = obs[w];
        const int nd = need[w];
        int hits = 0;
        int pos = 0;
        bool found = nd <= 0;
        for (int qq = 0; qq < wpc; ++qq) {
            const int K = qq * 32 + lane;
            const bool counts = K < limit;
            bool hit = false;
            if (__any_sync(permb::kFull, counts) && !flagged) {
                permb::draw_rank(t, key, static_cast<uint32_t>(K), m, bitgen, false, lane);
                hit = counts && permb::score_scan<true>(D, t.rk, m, asize, cc, lane) >= o32;
            }
            uint32_t b = __ballot_sync(permb::kFull, hit);
            const int c = __popc(b);
            if (!found && hits + c >= nd) {
                for (int k = nd - hits; k > 1; --k) b &= b - 1;
                pos = qq * 32 + __ffs(b) - 1;
                found = true;
            }
            hits += c;
        }
        if (lane == 0) {
            hits_out[w] = hits;
            reached_out[w] = hits >= nd;
            pos_out[w] = pos;
        }
    }
}

// The grid, block and shared memory of a large-panel launch over `tasks`
// warp tasks (permb::table_form): its tables in device scratch where
// gscratch is given (at any m), else in shared memory, which must hold
// one warp's.
template <typename Kernel>
int block_config(Kernel kernel, int m, bool f64, const void* gscratch, int64_t tasks,
                 unsigned* grid, int* threads, size_t* smem) {
    int warps;
    int64_t blocks, bytes;
    const int form = permb::table_form(m, f64, &warps, &blocks, &bytes);
    if (form < 0 || (form == 2 && gscratch == nullptr)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (gscratch) {
        warps = permb::kMaxWarps;
        *smem = 0;
        *grid = static_cast<unsigned>(std::min((tasks + warps - 1) / warps, blocks));
    } else {
        *smem = static_cast<size_t>(warps) * permb::warp_bytes(m, f64);
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
        if (e != cudaSuccess) return static_cast<int>(e);
        *grid = static_cast<unsigned>(
            std::min<int64_t>((tasks + warps - 1) / warps, 0x7fffffff));
    }
    *threads = warps * 32;
    return 0;
}

template <int MB, bool kF64>
int launch_hits(const float* dist, const float* obs, const int64_t* wkeys,
                const int64_t* active, int64_t nact, int m, int asize, int k0, int nk,
                int chunk, int wpc, int runs, int bitgen, permk::CoeffConst cc,
                permk::NativeConst nc, uint32_t* words, cudaStream_t s) {
    const size_t smem = smem_bytes(m, MB, kF64);
    const cudaError_t attr = cudaFuncSetAttribute(
        window_hits<MB, kF64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int slices = (nk * wpc + kWordsPerBlock - 1) / kWordsPerBlock;
    const int64_t blocks = nact * slices;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
    window_hits<MB, kF64><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        dist, obs, wkeys, active, m, asize, k0, nk, chunk, wpc, runs, slices, bitgen, cc,
        nc, words);
    return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, MB>) for the unrolled bucket MB of m.
template <typename F>
int by_bucket(int m, F&& f) {
    if (m <= 8) return f(std::integral_constant<int, 8>{});
    if (m <= 16) return f(std::integral_constant<int, 16>{});
    if (m <= 24) return f(std::integral_constant<int, 24>{});
    if (m <= 32) return f(std::integral_constant<int, 32>{});
    return f(std::integral_constant<int, kMaxM>{});
}

// Windows a K11 block takes: two words a warp where the chunk is short
// (4 windows at 128 permutations), as many as keep their products within
// 48 KB, at least one.
int perm_chunk_windows(int m, int wpc) {
    const int by_words = std::max(1, 2 * kWarps / wpc);
    const int by_smem =
        std::max(1, 49152 / static_cast<int>(sizeof(float) * mat_floats(m, false)));
    return std::min(by_words, by_smem);
}

template <int MB>
int launch_perm_chunk(const float* dist, const float* obs, const int* need,
                      const int64_t* keys, int64_t B, int m, int asize, int chunk, int limit,
                      int bitgen, permk::CoeffConst cc, int* hits, uint8_t* reached,
                      int* pos, cudaStream_t s) {
    const int wpc = (chunk + permk::kWordBits - 1) / permk::kWordBits;
    const int wpb = perm_chunk_windows(m, wpc);
    const size_t smem = sizeof(float) * wpb * mat_floats(m, false) +
                        sizeof(uint32_t) * wpb * wpc + sizeof(int) * wpb +
                        3 * static_cast<size_t>(kWarps) * MB * 32;
    const cudaError_t attr = cudaFuncSetAttribute(
        perm_chunk<MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int64_t blocks = (B + wpb - 1) / wpb;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
    perm_chunk<MB><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        dist, obs, need, keys, B, m, asize, wpc, limit, wpb, bitgen, cc, hits, reached, pos);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

FET_EXPORT int css_mc_window(const float* dist, const float* obs, const int64_t* wkeys,
                             const int64_t* active, int64_t nact, int m, int asize,
                             int k0, int nk, int chunk, int cstride, int runs, int bitgen,
                             int f64, float between, float ca, float cb, double wa,
                             double wb, double inv_ab, uint32_t* words, void* stream) {
    if (m > kMaxM || m < 2 || asize < 1 || asize >= m || chunk <= 0 || cstride < chunk ||
        cstride % permk::kWordBits != 0 || bitgen < 0 || bitgen > 1 ||
        (f64 && bitgen != 0)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (nact == 0 || nk == 0) return 0;
    const permk::CoeffConst cc{between, ca, cb};
    const permk::NativeConst nc{wa, wb, inv_ab};
    const int wpc = cstride / permk::kWordBits;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return by_bucket(m, [&](auto mb) {
        constexpr int MB = decltype(mb)::value;
        return f64 ? launch_hits<MB, true>(dist, obs, wkeys, active, nact, m, asize, k0, nk,
                                           chunk, wpc, runs, bitgen, cc, nc, words, s)
                   : launch_hits<MB, false>(dist, obs, wkeys, active, nact, m, asize, k0, nk,
                                            chunk, wpc, runs, bitgen, cc, nc, words, s);
    });
}

FET_EXPORT int css_perm_chunk(const float* dist, const float* obs, const int* need,
                              const int64_t* keys, int64_t B, int m, int asize, int chunk,
                              int limit, int bitgen, float between, float ca, float cb,
                              int* hits, uint8_t* reached, int* pos, void* stream) {
    if (m > kMaxM || m < 2 || asize < 1 || asize >= m || chunk <= 0 || bitgen < 0 ||
        bitgen > 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (B == 0) return 0;
    const permk::CoeffConst cc{between, ca, cb};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return by_bucket(m, [&](auto mb) {
        return launch_perm_chunk<decltype(mb)::value>(dist, obs, need, keys, B, m, asize,
                                                      chunk, std::min(limit, chunk), bitgen, cc,
                                                      hits, reached, pos, s);
    });
}

// The form K8 (f64: its float64 form), K11 and K9's window stream take at
// panel size m (their float32 tables are one layout): 0, the register
// forms (m <= kMaxM); 1, the large-panel form with its tables in a
// block's shared memory; 2, the same with them in device scratch.  For
// forms 1 and 2, *scratch_bytes is the scratch that a launch with its
// tables in device memory takes (form 2 must be given it; form 1 may
// be).  Negative where the device cannot be asked.
FET_EXPORT int css_mc_window_form(int m, int f64, int64_t* scratch_bytes) {
    *scratch_bytes = 0;
    if (m <= kMaxM) return 0;
    int warps;
    int64_t blocks;
    return permb::table_form(m, f64 != 0, &warps, &blocks, scratch_bytes);
}

// K8's large-panel form (any m >= 2): css_mc_window's arguments, then
// gscratch (null: the tables in shared memory; else css_mc_window_form's
// scratch bytes).
FET_EXPORT int css_mc_window_block(const float* dist, const float* obs, const int64_t* wkeys,
                                   const int64_t* active, int64_t nact, int m, int asize,
                                   int k0, int nk, int chunk, int cstride, int runs,
                                   int bitgen, int f64, float between, float ca, float cb,
                                   double wa, double wb, double inv_ab, void* gscratch,
                                   uint32_t* words, void* stream) {
    if (m < 2 || m > 65535 || asize < 1 || asize >= m || chunk <= 0 || cstride < chunk ||
        cstride % permk::kWordBits != 0 || bitgen < 0 || bitgen > 1 ||
        (f64 && bitgen != 0)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (nact == 0 || nk == 0) return 0;
    const int wpc = cstride / permk::kWordBits;
    const int64_t slices = (static_cast<int64_t>(nk) * wpc + kBlockSliceWords - 1) /
                           kBlockSliceWords;
    const permk::CoeffConst cc{between, ca, cb};
    const permk::NativeConst nc{wa, wb, inv_ab};
    unsigned char* gs = static_cast<unsigned char*>(gscratch);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    unsigned grid;
    int threads;
    size_t smem;
    int rc;
    if (f64) {
        rc = block_config(window_hits_block<true>, m, true, gs, nact * slices, &grid,
                          &threads, &smem);
        if (rc != 0) return rc;
        window_hits_block<true><<<grid, threads, smem, s>>>(
            dist, obs, wkeys, active, nact, m, asize, k0, nk, chunk, wpc, runs, bitgen, cc,
            nc, gs, words);
    } else {
        rc = block_config(window_hits_block<false>, m, false, gs, nact * slices, &grid,
                          &threads, &smem);
        if (rc != 0) return rc;
        window_hits_block<false><<<grid, threads, smem, s>>>(
            dist, obs, wkeys, active, nact, m, asize, k0, nk, chunk, wpc, runs, bitgen, cc,
            nc, gs, words);
    }
    return static_cast<int>(cudaGetLastError());
}

// K11's large-panel form (any m >= 2): css_perm_chunk's arguments to cb,
// then gscratch (as css_mc_window_block's).
FET_EXPORT int css_perm_chunk_block(const float* dist, const float* obs, const int* need,
                                    const int64_t* keys, int64_t B, int m, int asize,
                                    int chunk, int limit, int bitgen, float between,
                                    float ca, float cb, void* gscratch, int* hits,
                                    uint8_t* reached, int* pos, void* stream) {
    if (m < 2 || m > 65535 || asize < 1 || asize >= m || chunk <= 0 || bitgen < 0 ||
        bitgen > 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (B == 0) return 0;
    unsigned char* gs = static_cast<unsigned char*>(gscratch);
    unsigned grid;
    int threads;
    size_t smem;
    const int rc = block_config(perm_chunk_block, m, false, gs, B, &grid, &threads, &smem);
    if (rc != 0) return rc;
    const int wpc = (chunk + permk::kWordBits - 1) / permk::kWordBits;
    perm_chunk_block<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        dist, obs, need, keys, B, m, asize, wpc, std::min(limit, chunk), bitgen,
        permk::CoeffConst{between, ca, cb}, gs, hits, reached, pos);
    return static_cast<int>(cudaGetLastError());
}
