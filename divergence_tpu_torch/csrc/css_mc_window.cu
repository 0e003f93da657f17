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
//   coefficients (the float32 form: the rounded products the plain score
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
// kMaxM, on the large-panel body of css_perm_block.cuh: a block takes an
// active window's slice of words at a time (its D staged in the block's
// shared memory in the shared and split forms), a warp ranks a word's 32
// permutations by a bitonic sort of their (draw, index) keys and each
// lane scores its own: the float32 form over its a*b + m - 2 nonzero
// terms in score_f32_nonzero's order, the float64 form score_f64 over
// the rank order, so the words equal the small forms' and the plain
// versions' as theirs do.  css_mc_window_form says which form and scratch
// a panel size takes on the device.
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
// window_hits_block's body: a block a window, its warps a word each a
// round, the epilogue folded by one thread round by round in word order.
//
// K9's window stream to kMaxM — css_mc_power_window (kernel power_sums)
// replaces divergence_tpu/kernels/perm.py:_null_power_sums (stream=
// "window"); plain torch version: kernels/perm.py null_power_sums_plain,
// its sum order mirrored by window_power_order.  On K8's device body
// (stage_entry, perm_score: the same draws, ranks, nonzero-term scores and
// non-finite flag): a block a (window, chunk) task, the chunk key folded
// once, its warps the chunk's words, each lane the float64 s, s^2, s^3 of
// its permutations in word order, then the xor tree and the warps in warp
// order (no atomics: the same bits call to call).
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

// The float32 score of permutation K of the chunk keyed by ckey: this
// lane's draws and ranks in registers, its tables in the warp's
// lane-interleaved slabs, the nonzero terms over the staged products.
template <int MB>
__device__ __forceinline__ float perm_score(uint2 ckey, int K, int m, int asize, int bitgen,
                                            const float* mats, uint8_t* rk, uint8_t* ord,
                                            uint8_t* bl) {
    uint32_t x[MB];
    int r[MB];
    permk::draw_unrolled<MB>(ckey, static_cast<uint32_t>(K), m, bitgen, x);
    permk::rank_unrolled<MB>(x, m, r);
    const uint64_t bmask = rank_tables<MB>(r, m, asize, rk, ord, bl);
    const int dm = d_floats(m);
    return permk::score_f32_nonzero<MB>(mats, mats + dm, mats + 2 * dm, m, asize, rk, ord, bl,
                                        bmask);
}

// Whether permutation K of the chunk keyed by ckey scores >= the observed
// score o32 (the float64 form: score_f64 over the rank order).
template <int MB, bool kF64>
__device__ __forceinline__ bool perm_hit(uint2 ckey, int K, int m, int asize, int bitgen,
                                         const float* mats, const double* rowtot,
                                         uint8_t* rk, uint8_t* ord, uint8_t* bl,
                                         permk::NativeConst nc, float o32) {
    if constexpr (kF64) {
        uint32_t x[MB];
        int r[MB];
        permk::draw_unrolled<MB>(ckey, static_cast<uint32_t>(K), m, bitgen, x);
        permk::rank_unrolled<MB>(x, m, r);
        rank_tables<MB>(r, m, asize, rk, ord, bl);
        return permk::score_f64(mats, rowtot, ord, 32, m, asize, nc) >=
               static_cast<double>(o32);
    } else {
        return perm_score<MB>(ckey, K, m, asize, bitgen, mats, rk, ord, bl) >= o32;
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

// K9's window stream (css_mc_power_window): the float64 power sums of a
// window's chunks on this body.  A block takes window w's chunks [kk0,
// kk0 + nck) (cpb a block, power_chunks_per_block), stages its products
// once and folds each chunk key once; for each chunk warp q takes the
// chunk's words q, q + kWarps, ..., lane i summing the powers of its
// permutations in word order; the xor tree adds a warp's lanes, and the
// warps' sums go through shared memory to be added in warp order (the
// order kernels/perm.py:window_power_order mirrors).  A flagged window
// gets NaN sums, as the plain score's NaN products give it.
template <int MB>
__global__ void __launch_bounds__(kThreads, 2)
power_sums(const float* __restrict__ dist, const int64_t* __restrict__ wkeys, int64_t B, int m,
           int asize, int k0, int nk, int chunk, int wpc, int cpb, int groups, int bitgen,
           permk::CoeffConst cc, double* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int mm = m * m;
    float* mats = reinterpret_cast<float*>(smem_raw);
    uint2* ckeys = reinterpret_cast<uint2*>(mats + mat_floats(m, false));
    double* sums = reinterpret_cast<double*>(ckeys + ((cpb + 1) & ~1));   // [cpb][kWarps][3]
    uint8_t* ord_all = reinterpret_cast<uint8_t*>(sums + 3 * kWarps * cpb);
    uint8_t* bl_all = ord_all + kWarps * MB * 32;
    uint8_t* rk_all = bl_all + kWarps * MB * 32;

    const int64_t w = blockIdx.x / groups;
    const int kk0 = static_cast<int>(blockIdx.x - w * groups) * cpb;
    const int nck = min(cpb, nk - kk0);
    bool bad = false;
    for (int i = threadIdx.x; i < mm; i += kThreads) {
        bad |= stage_entry<false>(dist[w * mm + i], i, mats, d_floats(m), cc);
    }
    const uint2 wkey = make_uint2(static_cast<uint32_t>(wkeys[2 * w]),
                                  static_cast<uint32_t>(wkeys[2 * w + 1]));
    for (int t = threadIdx.x; t < nck; t += kThreads) {
        ckeys[t] = tf::fold_in(wkey, static_cast<uint32_t>(k0 + kk0 + t));
    }
    const bool flagged = __syncthreads_or(bad) != 0;

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    uint8_t* ord = ord_all + warp * MB * 32 + lane;
    uint8_t* bl = bl_all + warp * MB * 32 + lane;
    uint8_t* rk = rk_all + warp * MB * 32 + lane;
    for (int c = 0; c < nck; ++c) {
        double p[3] = {0.0, 0.0, 0.0};
        for (int q = warp; q < wpc && !flagged; q += kWarps) {
            const int K = q * 32 + lane;
            if (K < chunk) {
                const double v =
                    static_cast<double>(perm_score<MB>(ckeys[c], K, m, asize, bitgen, mats, rk,
                                                       ord, bl));
                const double v2 = __dmul_rn(v, v);
                p[0] = __dadd_rn(p[0], v);
                p[1] = __dadd_rn(p[1], v2);
                p[2] = __dadd_rn(p[2], __dmul_rn(v2, v));
            }
        }
#pragma unroll
        for (int e = 0; e < 3; ++e) {
            for (int o = 16; o > 0; o >>= 1) {
                p[e] = __dadd_rn(p[e], __shfl_xor_sync(0xffffffffu, p[e], o));
            }
            if (lane == 0) sums[(c * kWarps + warp) * 3 + e] = p[e];
        }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < 3 * nck; t += kThreads) {
        const int c = t / 3;
        const int e = t - 3 * c;
        double acc = 0.0;
        for (int r = 0; r < kWarps; ++r) acc = __dadd_rn(acc, sums[(c * kWarps + r) * 3 + e]);
        out[(static_cast<int64_t>(kk0 + c) * 3 + e) * B + w] =
            flagged ? __longlong_as_double(0x7ff8000000000000LL) : acc;
    }
}

// ------------------------------------------------- the large-panel form

// K8 past kMaxM (css_perm_block.cuh): the same hit words.  A block task is
// an active window's slice of `slice` words (its warps' kWordsPerWarp
// words each): the block stages the window (and flags a non-finite D in
// the float32 forms), then each warp ranks a word's 32 permutations and
// scores them, a lane each, the chunk key folded once a word.
template <int kForm, bool kF64>
__global__ void __launch_bounds__(permb::kMaxWarps * 32, 1)
window_hits_block(const float* __restrict__ dist, const float* __restrict__ obs,
                  const int64_t* __restrict__ wkeys, const int64_t* __restrict__ active,
                  int64_t nact, int m, int asize, int k0, int nk, int chunk, int wpc,
                  int runs, int bitgen, int slice, permk::CoeffConst cc, permk::NativeConst nc,
                  unsigned char* gscratch, uint32_t* __restrict__ words) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    const permb::Block blk = permb::carve_block<kForm>(smem_raw, gscratch, m, kF64);
    const permb::Warp w = permb::carve_warp<kForm>(blk, m, kF64);
    const permb::Rows rw = permb::rows_of<kForm>(m, asize);
    const int nwords = nk * wpc;
    const int slices = (nwords + slice - 1) / slice;
    const int64_t ntasks = nact * slices;
    for (int64_t task = blockIdx.x; task < ntasks; task += gridDim.x) {
        const int64_t a = task / slices;
        const int q0 = static_cast<int>(task - a * slices) * slice;
        const int64_t row = active[a];
        const float* D = dist + row * int64_t(m) * m;
        const bool flagged = permb::stage_window<kForm, kF64>(blk, D, m);
        const float* mat = permb::window_mat<kForm>(blk, D);
        const int ld = permb::window_ld<kForm>(m);
        const uint2 wkey = make_uint2(static_cast<uint32_t>(wkeys[2 * row]),
                                      static_cast<uint32_t>(wkeys[2 * row + 1]));
        const float o32 = obs[row];
        const int q1 = min(q0 + slice, nwords);
        for (int q = q0 + (threadIdx.x >> 5); q < q1; q += nwarps) {
            const int kk = q / wpc;
            const int qq = q - kk * wpc;
            const int K = qq * 32 + lane;
            const bool counts = K < chunk && static_cast<int64_t>(k0 + kk) * chunk + K < runs;
            bool hit = false;
            if (__any_sync(permb::kFull, counts) && (kF64 || !flagged)) {
                const uint2 ck = tf::fold_in(wkey, static_cast<uint32_t>(k0 + kk));
                permb::rank_word<kForm, kF64>(w, rw, ck, qq, m, asize, bitgen, lane);
                if (counts) {
                    if (kF64) {
                        hit = permb::walk_f64<kForm>(w.cols, blk, mat, ld, m, asize, nc, lane) >=
                              static_cast<double>(o32);
                    } else {
                        hit = permb::walk_f32<kForm>(w.cols, rw, mat, ld, m, asize, cc,
                                                     lane) >= o32;
                    }
                }
            }
            const uint32_t b = __ballot_sync(permb::kFull, hit);
            if (lane == 0) words[(a * nk + kk) * wpc + qq] = b;
        }
        __syncthreads();   // the next task restages the block's window
    }
}

// K11 past kMaxM: a block task is a window; its warps take the chunk's
// words a round at a time (word q0 + warp), and after each round thread 0
// folds the round's words into the stop epilogue in permutation order
// (the small form's fold over its words, the same order).
template <int kForm>
__global__ void __launch_bounds__(permb::kMaxWarps * 32, 1)
perm_chunk_block(const float* __restrict__ dist, const float* __restrict__ obs,
                 const int* __restrict__ need, const int64_t* __restrict__ keys, int64_t B,
                 int m, int asize, int wpc, int limit, int bitgen, permk::CoeffConst cc,
                 unsigned char* gscratch, int* __restrict__ hits_out,
                 uint8_t* __restrict__ reached_out, int* __restrict__ pos_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const permb::Block blk = permb::carve_block<kForm>(smem_raw, gscratch, m, false);
    const permb::Warp w = permb::carve_warp<kForm>(blk, m, false);
    const permb::Rows rw = permb::rows_of<kForm>(m, asize);
    uint32_t* round_words = reinterpret_cast<uint32_t*>(blk.area);   // [nwarps]
    for (int64_t win = blockIdx.x; win < B; win += gridDim.x) {
        const float* D = dist + win * int64_t(m) * m;
        const bool flagged = permb::stage_window<kForm, false>(blk, D, m);
        const float* mat = permb::window_mat<kForm>(blk, D);
        const int ld = permb::window_ld<kForm>(m);
        const uint2 key = make_uint2(static_cast<uint32_t>(keys[2 * win]),
                                     static_cast<uint32_t>(keys[2 * win + 1]));
        const float o32 = obs[win];
        const int nd = need[win];
        int hits = 0;
        int pos = 0;
        bool found = nd <= 0;
        for (int q0 = 0; q0 < wpc; q0 += nwarps) {
            const int qq = q0 + warp;
            if (qq < wpc) {
                const int K = qq * 32 + lane;
                const bool counts = K < limit;
                bool hit = false;
                if (__any_sync(permb::kFull, counts) && !flagged) {
                    permb::rank_word<kForm, false>(w, rw, key, qq, m, asize, bitgen, lane);
                    if (counts) {
                        hit = permb::walk_f32<kForm>(w.cols, rw, mat, ld, m, asize, cc,
                                                     lane) >= o32;
                    }
                }
                const uint32_t b = __ballot_sync(permb::kFull, hit);
                if (lane == 0) round_words[warp] = b;
            }
            __syncthreads();
            if (threadIdx.x == 0) {
                for (int r = 0; r < nwarps && q0 + r < wpc; ++r) {
                    uint32_t b = round_words[r];
                    const int c = __popc(b);
                    if (!found && hits + c >= nd) {
                        for (int k = nd - hits; k > 1; --k) b &= b - 1;
                        pos = (q0 + r) * 32 + __ffs(b) - 1;
                        found = true;
                    }
                    hits += c;
                }
            }
            __syncthreads();
        }
        if (threadIdx.x == 0) {
            hits_out[win] = hits;
            reached_out[win] = hits >= nd;
            pos_out[win] = pos;
        }
    }
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

// Chunks a K9 block takes: one, so a call on few windows (approx mode's
// escalation rounds) still spreads over the card.
constexpr int kPowerChunksPerBlock = 1;

int power_chunks_per_block(int nk) { return std::min(nk, kPowerChunksPerBlock); }

template <int MB>
int launch_power(const float* dist, const int64_t* wkeys, int64_t B, int m, int asize, int k0,
                 int nk, int chunk, int bitgen, permk::CoeffConst cc, double* out,
                 cudaStream_t s) {
    const int wpc = (chunk + permk::kWordBits - 1) / permk::kWordBits;
    const int cpb = power_chunks_per_block(nk);
    const int groups = (nk + cpb - 1) / cpb;
    const size_t smem = sizeof(float) * mat_floats(m, false) + sizeof(uint2) * ((cpb + 1) & ~1) +
                        sizeof(double) * 3 * kWarps * cpb + 3 * static_cast<size_t>(kWarps) * MB * 32;
    const cudaError_t attr = cudaFuncSetAttribute(
        power_sums<MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int64_t blocks = B * groups;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
    power_sums<MB><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        dist, wkeys, B, m, asize, k0, nk, chunk, wpc, cpb, groups, bitgen, cc, out);
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

// K9's window stream to kMaxM: out[(kk*3 + q)*B + w], the sums of s^(q+1)
// over chunk k0 + kk's float32 scores of window w, widened to float64.
FET_EXPORT int css_mc_power_window(const float* dist, const int64_t* wkeys, int64_t B, int m,
                                   int asize, int k0, int nk, int chunk, int bitgen,
                                   float between, float ca, float cb, double* out,
                                   void* stream) {
    if (m > kMaxM || m < 2 || asize < 1 || asize >= m || chunk <= 0 || bitgen < 0 ||
        bitgen > 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (B == 0 || nk == 0) return 0;
    const permk::CoeffConst cc{between, ca, cb};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return by_bucket(m, [&](auto mb) {
        return launch_power<decltype(mb)::value>(dist, wkeys, B, m, asize, k0, nk, chunk, bitgen,
                                                 cc, out, s);
    });
}

// The form K8 (f64: its float64 form), K11 and K9's window stream take at
// panel size m (their float32 tables are one layout): 0, the register
// forms (m <= kMaxM); else the large-panel body's (permb::form_of): 1,
// shared (the window's D and the warps' 8-bit tables in a block's shared
// memory); 2, split (D there, the tables in device scratch); 3, device (D
// in place, 16-bit tables in device scratch).  Past kMaxM *scratch_bytes
// is the scratch a launch in forms 2 and 3 must be given (form 1 must be
// given none).  Negative where the device cannot be asked.
FET_EXPORT int css_mc_window_form(int m, int f64, int64_t* scratch_bytes) {
    *scratch_bytes = 0;
    if (m <= kMaxM) return 0;
    int64_t blocks;
    return permb::form_of(m, f64 != 0, &blocks, scratch_bytes);
}

// K8's large-panel form (any m >= 2): css_mc_window's arguments, then
// gscratch (null: the shared form, which must be the form of m; else
// css_mc_window_form's scratch bytes).
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
    const permk::CoeffConst cc{between, ca, cb};
    const permk::NativeConst nc{wa, wb, inv_ab};
    unsigned char* gs = static_cast<unsigned char*>(gscratch);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto run = [&](auto shared, auto split, auto device) {
        const decltype(shared) kernels[3] = {shared, split, device};
        permb::Launch L;
        const int rc = permb::plan_launch(kernels, m, f64 != 0, gs != nullptr, permb::kMaxWarps,
                                          &L);
        if (rc != 0) return rc;
        // a task: a window's slice of kWordsPerWarp words for each warp
        const int slice = (L.threads / 32) * permb::kWordsPerWarp;
        const int64_t tasks = nact * ((static_cast<int64_t>(nk) * wpc + slice - 1) / slice);
        kernels[L.form - 1]<<<L.grid_for(tasks), L.threads, L.smem, s>>>(
            dist, obs, wkeys, active, nact, m, asize, k0, nk, chunk, wpc, runs, bitgen, slice,
            cc, nc, gs, words);
        return static_cast<int>(cudaGetLastError());
    };
    return f64 ? run(window_hits_block<permb::kShared, true>,
                     window_hits_block<permb::kSplit, true>,
                     window_hits_block<permb::kDevice, true>)
               : run(window_hits_block<permb::kShared, false>,
                     window_hits_block<permb::kSplit, false>,
                     window_hits_block<permb::kDevice, false>);
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
    const int wpc = (chunk + permk::kWordBits - 1) / permk::kWordBits;
    decltype(&perm_chunk_block<permb::kShared>) const kernels[3] = {
        perm_chunk_block<permb::kShared>, perm_chunk_block<permb::kSplit>,
        perm_chunk_block<permb::kDevice>};
    permb::Launch L;
    const int rc = permb::plan_launch(kernels, m, false, gs != nullptr, wpc, &L);
    if (rc != 0) return rc;
    kernels[L.form - 1]<<<L.grid_for(B), L.threads, L.smem, static_cast<cudaStream_t>(stream)>>>(
        dist, obs, need, keys, B, m, asize, wpc, std::min(limit, chunk), bitgen,
        permk::CoeffConst{between, ca, cb}, gs, hits, reached, pos);
    return static_cast<int>(cudaGetLastError());
}
