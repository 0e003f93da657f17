// The large-panel permutation body shared by K8 and K11 (css_mc_window.cu)
// and K9's window stream (css_mc_power.cu): panels past permk::kMaxM,
// whose draws, ranks and b-group lists the small forms hold in registers.
//
// A block works one window at a time (a task: K8 a window's slice of hit
// words, K11 a window, K9 a window's chunk), and each of its warps takes
// one word, 32 consecutive permutations, at a time.  For a word the warp:
//
// 1. ranks its 32 permutations one after another, all 32 lanes on one
//    permutation (rank_word): the m keys (uint64(x_j) << 16) | j, x_j the
//    draw of individual j (css_perm_common.cuh draw_one), padded with
//    kPadKey to p = 2^ceil(log2 m) (at least 128) keys, go through a
//    bitonic network.  The keys are distinct and their ascending order is
//    precedes' stable order (threefry's equal float32 uniforms tie on the
//    index), so the slot a key lands in is _ranks' rank of its individual:
//    p / 2 * log2 p * (log2 p + 1) / 2 compares (4,608 at m = 200) where
//    a rank count takes m^2.  Up to p = kRegSortKeys the keys sit in
//    registers, p / 32 a lane (slot g = lane * E + e), the strides below E
//    inside a lane and the others by shuffles; past it in the warp's key
//    slab, a compare-exchange a lane per step.  Then, for the lane that
//    owns the permutation, the float32 form's lists in index order (the
//    a-group individuals AL with their rank successors AS, the b-group BL
//    with theirs BS, and a b-group bit mask BM with its word prefix counts
//    PR, from one ballot per 32 individuals) or the float64 form's rank
//    order ORD, written into the owner's column of the warp's tables;
// 2. scores: each lane its own permutation, so every sum keeps one lane's
//    order.  The float32 form (walk_f32) adds only the a*b + m - 2 nonzero
//    terms in score_f32_nonzero's row-major order (css_perm_common.cuh):
//    the a-rows in index order, the b-rows between them (their one chain
//    term each), and in an a-row its b-group columns by index with the
//    star term (its rank successor in the a-group) at position p = #{b
//    with index < star}, read from BM and PR.  Every lane has exactly a
//    a-rows of b + (0 or 1) terms, so the a-row loop runs converged; only
//    the short b-row runs between a-rows differ by lane.  A term is one
//    load of D, its product with 1/(ab) or -(a+b) w rounded (the bits of
//    the plain score's D[j][l] * C[j][l]) and one __fadd_rn.  So K8's and K11's
//    hits equal the small forms' (and the plain score's: skipped zero products
//    leave a sum unchanged but for the sign of a zero), and K9's power
//    sums equal the plain version's for finite D.  A window with a non-finite entry is flagged
//    while it is staged: no hits (K8, K11) or NaN sums (K9), as the plain score
//    gives (NaN times a zero coefficient).  The float64 form runs score_f64
//    (mc_native's order) over ORD.
//
// Three forms (form_of):
//   shared — the block's shared memory holds the window's D (rows of m | 1
//     floats: an odd stride spreads the lanes' rows over the banks), its
//     row totals (float64) and kMaxWarps warps' tables with 8-bit entries
//     (m <= 128 float32, 184 float64 on an H100).  32 lanes gather a term
//     each from D: random banks;
//   split — D there, the 8-bit tables in device scratch (L1 / L2), so
//     kMaxWarps warps still share an SM (to m = 232 / 239).  On an H100
//     (chip_smoke.py phase 17e) the shared form's 16 warps took 5-7 %
//     less time a term than the split form's at m = 65-128, and its 8
//     warps at m = 174 19 % more: the shared form needs all kMaxWarps;
//   device — D read in place and the tables (16-bit entries, any m to
//     65,535) in device scratch, also for a split launch whose tasks hold
//     fewer than kMaxWarps warps (K11's 4-word chunk).  The split and
//     device forms' scratch holds kMaxWarps warps an SM: their grid.
// The tables are per-lane columns of 32-bit words, word (row, lane) at row
// * 32 + (lane ^ (row & 31)): a lane's walk reads one row for all lanes at
// once (no two lanes on one bank), and the warp writing one owner's
// entries spreads them over the banks.
//
// What bounds it on H100: the gathers of the terms from D (random banks
// in shared memory; L1 / L2 sectors in the device form, 2.5x the time a
// term) and, at small m, the warp's ranking (the network's
// compare-exchanges and shuffles, the ballots of the lists): chip_smoke.py
// phase 17e reads ~1.4 ps a term on the card from m = 128 and ~2 ns a
// permutation of ranking.  The nonzero terms and the network are the
// operations the bound counts (chip_smoke.py window_ops); the warps an SM
// (the forms) set how much of the gathers' latency is hidden.
#pragma once

#include <cstdint>

#include "css_perm_common.cuh"
#include "fet_common.cuh"
#include "threefry.cuh"

namespace permb {

// The forms (form_of): where a block keeps the window's D and its warps'
// tables.
constexpr int kShared = 1;   // both in shared memory, 8-bit entries
constexpr int kSplit = 2;    // D in shared memory, 8-bit tables in device scratch
constexpr int kDevice = 3;   // D in place, 16-bit tables in device scratch

constexpr int kMaxWarps = 16;           // warps a block
constexpr int kRegSortKeys = 256;       // the sort in registers up to this p
constexpr int kWordsPerWarp = 2;        // K8: words a warp takes per block task
constexpr int kAreaBytes = kMaxWarps * 32;   // a block's small area (K9's warp sums, K11's words)
constexpr uint64_t kPadKey = 0xFFFFFFFFFFFFull;   // above every (x << 16) | j, j < 65,535
constexpr int kNoSucc = 0xFFFF;         // CODE: no rank successor within the group
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~size_t(15); }
__host__ __device__ constexpr int div_up(int n, int d) { return (n + d - 1) / d; }

// Keys of the rank network: the power of two >= m, at least 128.
__host__ __device__ constexpr int sort_keys(int m) {
    int p = 128;
    while (p < m) p <<= 1;
    return p;
}

// Table entries: 8-bit where the block holds D (m <= 236), else 16-bit;
// all ones is "none".
template <int kForm>
struct Entry {
    using T = uint8_t;
    static constexpr int kNone = 0xFF;
    static constexpr int kPerWord = 4;
};
template <>
struct Entry<kDevice> {
    using T = uint16_t;
    static constexpr int kNone = 0xFFFF;
    static constexpr int kPerWord = 2;
};

__host__ __device__ constexpr int per_word(int form) { return form == kDevice ? 2 : 4; }

// Rows (32 words each) of a warp's tables: ORD (float64 form), or BL, BS,
// AL, AS (at most 2 (ceil(m / per_word) + 1) rows whatever the split) and
// BM, PR (a row per 32 individuals each).
__host__ __device__ constexpr size_t table_bytes(int m, bool f64, int form) {
    return size_t(f64 ? div_up(m, per_word(form))
                      : 2 * (div_up(m, per_word(form)) + 1) + 2 * div_up(m, 32)) * 128;
}

// Bytes of a warp's scratch for the permutation being ranked: CODE (uint32
// [m], float32 form) and the key slab where p > kRegSortKeys.
__host__ __device__ constexpr size_t rank_bytes(int m, bool f64) {
    return (f64 ? 0 : align16(size_t(m) * 4)) +
           (sort_keys(m) > kRegSortKeys ? size_t(sort_keys(m)) * 8 : 0);
}

// The block's copy of D: rows of ld = m | 1 floats (an odd stride spreads
// the lanes' rows over the banks).
__host__ __device__ constexpr int mat_ld(int m) { return m | 1; }
__host__ __device__ constexpr size_t mat_bytes(int m) {
    return align16(size_t(m) * mat_ld(m) * 4);
}
__host__ __device__ constexpr size_t rowtot_bytes(int m, bool f64) {
    return f64 ? align16(size_t(m) * 8) : 0;
}

// Shared memory of a block of `warps` warps in a form: D, row totals,
// area, then each warp's tables (shared form) and rank scratch (shared and
// split forms).
__host__ __device__ constexpr size_t smem_bytes(int m, bool f64, int form, int warps) {
    return form == kDevice
               ? size_t(kAreaBytes)
               : mat_bytes(m) + rowtot_bytes(m, f64) + kAreaBytes +
                     size_t(warps) * (rank_bytes(m, f64) +
                                      (form == kShared ? table_bytes(m, f64, form) : 0));
}

// Device scratch of a warp in the split form (its tables) and the device
// form (its tables, its rank scratch and, for its block, the float64 row
// totals); a launch's scratch holds kMaxWarps of the device form's an SM.
__host__ __device__ constexpr size_t slot_bytes(int m, bool f64, int form) {
    return form == kDevice ? rowtot_bytes(m, f64) + table_bytes(m, f64, form) + rank_bytes(m, f64)
                           : table_bytes(m, f64, form);
}

// The form a launch at panel size m takes: shared where a block holds D
// and kMaxWarps warps' tables and rank scratch, else split where it holds
// D and their rank scratch (m <= 255 for the 8-bit entries), else device.
// *scratch is the device scratch of a launch in the split or device form;
// *blocks the SMs.  Negative where the device cannot be asked.
inline int form_of(int m, bool f64, int64_t* blocks, int64_t* scratch) {
    const size_t limit = fetk::smem_optin();
    int dev = 0, sms = 0;
    if (limit == 0 || cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
        return -1;
    }
    *blocks = sms;
    const auto fits = [&](int form) {
        return m <= 255 && smem_bytes(m, f64, form, kMaxWarps) <= limit;
    };
    const int form = fits(kShared) ? kShared : fits(kSplit) ? kSplit : kDevice;
    *scratch = int64_t(sms) * kMaxWarps * int64_t(slot_bytes(m, f64, kDevice));
    return form;
}

// A launch's form, block, shared memory and grid (the blocks the card
// holds at once: the caller takes at most one a task).  The caller gives
// scratch exactly where form_of says split or device; otherwise the launch
// is refused.  max_warps: the warps a task can use; a split launch whose
// tasks use fewer than kMaxWarps (K11's chunk of 4 words) takes the
// device form, several blocks an SM.
struct Launch {
    int form;
    unsigned grid;
    int threads;
    size_t smem;
    unsigned grid_for(int64_t tasks) const {
        return static_cast<unsigned>(tasks < int64_t(grid) ? tasks : int64_t(grid));
    }
};

template <typename Kernel>
inline int plan_launch(const Kernel (&kernels)[3], int m, bool f64, bool scratch, int max_warps,
                       Launch* L) {
    int64_t blocks, bytes;
    int form = form_of(m, f64, &blocks, &bytes);
    if (form < 0 || (form != kShared) != scratch) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (form == kSplit && max_warps < kMaxWarps) form = kDevice;
    const int warps = max_warps < kMaxWarps ? max_warps : kMaxWarps;
    L->form = form;
    L->threads = warps * 32;
    L->smem = smem_bytes(m, f64, form, warps);
    const Kernel kernel = kernels[form - 1];
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L->smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (form == kShared) {
        int per_sm = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, L->threads, L->smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        blocks *= per_sm > 0 ? per_sm : 1;
    } else if (form == kDevice) {
        blocks *= kMaxWarps / warps;   // the scratch's kMaxWarps slots an SM
    }
    L->grid = static_cast<unsigned>(blocks);
    return 0;
}

// ------------------------------------------------------------- the tables

__device__ __forceinline__ uint32_t* col_word(uint32_t* cols, int row, int lane) {
    return cols + row * 32 + (lane ^ (row & 31));
}
__device__ __forceinline__ const uint32_t* col_word(const uint32_t* cols, int row, int lane) {
    return cols + row * 32 + (lane ^ (row & 31));
}

// Entry e of the table at row0 in lane's column.
template <int kForm>
__device__ __forceinline__ void put(uint32_t* cols, int row0, int e, int v, int lane) {
    using T = typename Entry<kForm>::T;
    constexpr int n = Entry<kForm>::kPerWord;
    reinterpret_cast<T*>(col_word(cols, row0 + e / n, lane))[e % n] = static_cast<T>(v);
}

template <int kForm>
__device__ __forceinline__ int get(const uint32_t* cols, int row0, int e, int lane) {
    using T = typename Entry<kForm>::T;
    constexpr int n = Entry<kForm>::kPerWord;
    return reinterpret_cast<const T*>(col_word(cols, row0 + e / n, lane))[e % n];
}

// The float32 form's table rows at split (asize, m - asize).
struct Rows {
    int bl, bs, al, as, bm, pr;
};

template <int kForm>
__device__ __forceinline__ Rows rows_of(int m, int asize) {
    constexpr int n = Entry<kForm>::kPerWord;
    const int wb = div_up(m - asize, n), wa = div_up(asize, n), wm = div_up(m, 32);
    return Rows{0, wb, 2 * wb, 2 * wb + wa, 2 * (wb + wa), 2 * (wb + wa) + wm};
}

struct Warp {
    uint32_t* cols;   // its tables: rows of 32 words
    uint32_t* code;   // [m] individual j of the permutation being ranked:
                      // 1 << 16 if in the b-group, | its rank successor
                      // within its group, or kNoSucc (float32 form)
    uint64_t* keys;   // [p] the key slab (p > kRegSortKeys)
};

struct Block {
    float* mat;        // the shared and split forms: the window's D, stride mat_ld
    double* rowtot;    // float64 form: the window's row totals
    unsigned char* area;
    unsigned char* warps;    // shared memory after the area
    unsigned char* scratch;  // this block's first warp's slot of device scratch
};

template <int kForm>
__device__ __forceinline__ Block carve_block(unsigned char* smem, unsigned char* gscratch, int m,
                                             bool f64) {
    Block b;
    b.scratch = kForm == kShared ? nullptr
                                 : gscratch + size_t(blockIdx.x) * (blockDim.x >> 5) *
                                                  slot_bytes(m, f64, kForm);
    if (kForm == kDevice) {
        b.mat = nullptr;
        b.rowtot = reinterpret_cast<double*>(b.scratch);
        b.area = smem;
        b.warps = nullptr;
    } else {
        b.mat = reinterpret_cast<float*>(smem);
        b.rowtot = reinterpret_cast<double*>(smem + mat_bytes(m));
        b.area = smem + mat_bytes(m) + rowtot_bytes(m, f64);
        b.warps = b.area + kAreaBytes;
    }
    return b;
}

template <int kForm>
__device__ __forceinline__ Warp carve_warp(const Block& b, int m, bool f64) {
    const size_t warp = threadIdx.x >> 5;
    const size_t tb = table_bytes(m, f64, kForm), rb = rank_bytes(m, f64);
    unsigned char* tables;
    unsigned char* rank;
    if (kForm == kShared) {
        tables = b.warps + warp * (tb + rb);
        rank = tables + tb;
    } else if (kForm == kSplit) {
        tables = b.scratch + warp * tb;
        rank = b.warps + warp * rb;
    } else {
        tables = b.scratch + warp * slot_bytes(m, f64, kForm) + rowtot_bytes(m, f64);
        rank = tables + tb;
    }
    Warp w;
    w.cols = reinterpret_cast<uint32_t*>(tables);
    w.code = reinterpret_cast<uint32_t*>(rank);
    w.keys = reinterpret_cast<uint64_t*>(rank + (f64 ? 0 : align16(size_t(m) * 4)));
    return w;
}

// Stage the window's D for a task, by the whole block: the block's copy
// of D (shared, split) and the float64 row totals.  True where an entry of
// D is not finite.  Ends with a barrier.
template <int kForm, bool kF64>
__device__ __forceinline__ bool stage_window(const Block& b, const float* __restrict__ D, int m) {
    const int64_t mm = int64_t(m) * m;
    const int ld = mat_ld(m);
    bool bad = false;
    for (int64_t i = threadIdx.x; i < mm; i += blockDim.x) {
        const float d = __ldg(D + i);
        bad |= !isfinite(d);
        if (kForm != kDevice) {
            const int64_t j = i / m;
            b.mat[j * ld + (i - j * m)] = d;
        }
    }
    const bool flagged = __syncthreads_or(bad) != 0;
    if (kF64) {
        for (int j = threadIdx.x; j < m; j += blockDim.x) b.rowtot[j] = permk::row_total(D, m, j);
        __syncthreads();
    }
    return flagged;
}

// The window's D a task reads, and its row stride: the block's copy, or D
// in place.
template <int kForm>
__device__ __forceinline__ const float* window_mat(const Block& b, const float* D) {
    return kForm == kDevice ? D : b.mat;
}
template <int kForm>
__device__ __forceinline__ int window_ld(int m) {
    return kForm == kDevice ? m : mat_ld(m);
}

// ------------------------------------------------------------ the ranking

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int mask) {
    const uint32_t lo = __shfl_xor_sync(kFull, static_cast<uint32_t>(v), mask);
    const uint32_t hi = __shfl_xor_sync(kFull, static_cast<uint32_t>(v >> 32), mask);
    return (static_cast<uint64_t>(hi) << 32) | lo;
}

// Compare-exchange of a lane's keys a, b: the smaller to a iff up.
__device__ __forceinline__ void cx(uint64_t& a, uint64_t& b, bool up) {
    const bool sw = up ? a > b : a < b;
    const uint64_t lo = sw ? b : a;
    b = sw ? a : b;
    a = lo;
}

// Bitonic sort, ascending, of the warp's 32 E keys, slot g = lane * E + e:
// the comparator (g, g ^ j) of stage (k, j) keeps the smaller key at the
// lower slot iff (g & k) == 0 (kernels/perm.py:network_ranks).  The stages
// with k <= E run in a lane; past them each k runs its strides j >= E by
// shuffles (j / E lanes apart) and then its strides below E in a lane,
// one direction a lane.  Loops over k and the shuffle strides keep the
// code small (an instruction cache's worth is the whole sort).
template <int E, int LOGE>
__device__ __forceinline__ void sort_registers(uint64_t (&k)[E], int lane) {
#pragma unroll
    for (int s = 1; s <= LOGE; ++s) {
#pragma unroll
        for (int t = s - 1; t >= 0; --t) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
                if ((e & (1 << t)) == 0) {
                    cx(k[e], k[e | (1 << t)], ((lane * E + e) & (1 << s)) == 0);
                }
            }
        }
    }
#pragma unroll 1
    for (int kk = 2 * E; kk <= 32 * E; kk <<= 1) {
        const bool up = ((lane * E) & kk) == 0;
#pragma unroll 1
        for (int lj = kk / (2 * E); lj > 0; lj >>= 1) {
            const bool take_min = ((lane & lj) == 0) == up;
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const uint64_t o = shfl_xor64(k[e], lj);
                k[e] = take_min == (o < k[e]) ? o : k[e];
            }
        }
#pragma unroll
        for (int t = LOGE - 1; t >= 0; --t) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
                if ((e & (1 << t)) == 0) cx(k[e], k[e | (1 << t)], up);
            }
        }
    }
}

// The same network on the warp's key slab, a compare-exchange a lane.
__device__ __forceinline__ void sort_memory(uint64_t* keys, int p, int lane) {
    for (int kk = 2; kk <= p; kk <<= 1) {
        for (int j = kk >> 1; j > 0; j >>= 1) {
            __syncwarp();
            for (int i = lane; i < p / 2; i += 32) {
                const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
                const int hi = lo | j;
                const bool up = (lo & kk) == 0;
                const uint64_t a = keys[lo], b = keys[hi];
                if (up ? a > b : a < b) {
                    keys[lo] = b;
                    keys[hi] = a;
                }
            }
        }
    }
    __syncwarp();
}

__device__ __forceinline__ uint64_t draw_key(uint2 key, uint32_t base, int g, int m, int bitgen) {
    return g < m ? (static_cast<uint64_t>(permk::draw_one(key, base + uint32_t(g), bitgen)) << 16) |
                       static_cast<uint64_t>(g)
                 : kPadKey;
}

// Slot g of the sorted keys holds individual idx, and slot g + 1 `next`:
// the float64 form's ORD entry, or the float32 form's CODE.
template <int kForm, bool kF64>
__device__ __forceinline__ void emit(const Warp& w, int g, int idx, int next, int m, int asize,
                                     int owner) {
    if (kF64) {
        put<kForm>(w.cols, 0, g, idx, owner);
    } else {
        const int lim = g < asize ? asize : m;
        w.code[idx] = (g < asize ? 0u : 0x10000u) | uint32_t(g + 1 < lim ? next : kNoSucc);
    }
}

template <int kForm, bool kF64, int E, int LOGE>
__device__ __forceinline__ void rank_registers(const Warp& w, uint2 key, uint32_t K, int m,
                                               int asize, int bitgen, int owner, int lane) {
    uint64_t k[E];
    const uint32_t base = K * static_cast<uint32_t>(m);
#pragma unroll
    for (int e = 0; e < E; ++e) k[e] = draw_key(key, base, lane * E + e, m, bitgen);
    sort_registers<E, LOGE>(k, lane);
    const int next0 = __shfl_down_sync(kFull, static_cast<int>(k[0] & 0xFFFF), 1);
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int g = lane * E + e;
        const int next = e + 1 < E ? static_cast<int>(k[e + 1 < E ? e + 1 : e] & 0xFFFF) : next0;
        if (g < m) emit<kForm, kF64>(w, g, static_cast<int>(k[e] & 0xFFFF), next, m, asize, owner);
    }
}

template <int kForm, bool kF64>
__device__ __forceinline__ void rank_memory(const Warp& w, uint2 key, uint32_t K, int m,
                                            int asize, int bitgen, int owner, int lane) {
    const int p = sort_keys(m);
    const uint32_t base = K * static_cast<uint32_t>(m);
    __syncwarp();
    for (int g = lane; g < p; g += 32) w.keys[g] = draw_key(key, base, g, m, bitgen);
    sort_memory(w.keys, p, lane);
    for (int g = lane; g < m; g += 32) {
        const int next = g + 1 < m ? static_cast<int>(w.keys[g + 1] & 0xFFFF) : 0;
        emit<kForm, kF64>(w, g, static_cast<int>(w.keys[g] & 0xFFFF), next, m, asize, owner);
    }
}

// The float32 form's lists of the ranked permutation, into owner's
// column: a ballot of the b-group over each 32 individuals gives every
// individual its place in AL or BL.
template <int kForm>
__device__ __forceinline__ void fill_lists(const Warp& w, const Rows& rw, int m, int asize,
                                           int owner, int lane) {
    __syncwarp();
    const unsigned lt = (1u << lane) - 1u;
    int nb = 0;
    for (int t = 0; t * 32 < m; ++t) {
        const int j = t * 32 + lane;
        const bool in = j < m;
        const uint32_t c = in ? w.code[j] : 0u;
        const bool isb = c >= 0x10000u;
        const unsigned mask = __ballot_sync(kFull, isb);
        const int before = nb + __popc(mask & lt);
        if (in) {
            const int s = static_cast<int>(c & 0xFFFFu);
            if (isb) {
                put<kForm>(w.cols, rw.bl, before, j, owner);
                put<kForm>(w.cols, rw.bs, before, s, owner);
            } else {
                put<kForm>(w.cols, rw.al, j - before, j, owner);
                put<kForm>(w.cols, rw.as, j - before, s, owner);
            }
        }
        if (lane == 0) {
            *col_word(w.cols, rw.bm + t, owner) = mask;
            *col_word(w.cols, rw.pr + t, owner) = static_cast<uint32_t>(nb);
        }
        nb += __popc(mask);
    }
    __syncwarp();
}

// Rank permutations 32 qq .. 32 qq + 31 of the chunk keyed by ck, lane
// i's into column i.
template <int kForm, bool kF64>
__device__ __forceinline__ void rank_word(const Warp& w, const Rows& rw, uint2 ck, int qq, int m,
                                          int asize, int bitgen, int lane) {
    const int p = sort_keys(m);
    __syncwarp();   // the lanes are done with the last word's columns
    for (int owner = 0; owner < 32; ++owner) {
        const uint32_t K = static_cast<uint32_t>(qq * 32 + owner);
        if (p == 128) {
            rank_registers<kForm, kF64, 4, 2>(w, ck, K, m, asize, bitgen, owner, lane);
        } else if (p == 256) {
            rank_registers<kForm, kF64, 8, 3>(w, ck, K, m, asize, bitgen, owner, lane);
        } else {
            rank_memory<kForm, kF64>(w, ck, K, m, asize, bitgen, owner, lane);
        }
        if (!kF64) fill_lists<kForm>(w, rw, m, asize, owner, lane);
    }
    __syncwarp();
}

// ------------------------------------------------------------ the scores

// An entry of the window's D: the block's copy, or D in device memory.
template <int kForm>
__device__ __forceinline__ float dload(const float* p) {
    if (kForm != kDevice) return *p;
    return __ldg(p);
}

// This lane's float32 score: score_f32_nonzero's terms in its order (see
// the header), each product rounded as the plain score rounds D[j][l] * C[j][l].
// mat: the window's D (window_mat), rows ld floats apart.
template <int kForm>
__device__ __forceinline__ float walk_f32(const uint32_t* cols, const Rows& rw, const float* mat,
                                          int ld, int m, int asize, permk::CoeffConst c,
                                          int lane) {
    using T = typename Entry<kForm>::T;
    constexpr int n = Entry<kForm>::kPerWord;
    constexpr int kNone = Entry<kForm>::kNone;
    constexpr uint32_t kMask = (1u << (8 * sizeof(T))) - 1u;
    const int bsize = m - asize;
    const int nfull = bsize / n;
    const float nca = -c.ca, ncb = -c.cb;
    float acc = 0.0f;
    int sb = 0;   // the next b-row, in index order
    for (int i = 0; i < asize; ++i) {
        const int j = get<kForm>(cols, rw.al, i, lane);
        for (; sb < j - i; ++sb) {   // the b-rows before row j
            const int nx = get<kForm>(cols, rw.bs, sb, lane);
            if (nx != kNone) {
                const int jb = get<kForm>(cols, rw.bl, sb, lane);
                acc = __fadd_rn(acc, __fmul_rn(dload<kForm>(mat + size_t(jb) * ld + nx), ncb));
            }
        }
        const float* row = mat + size_t(j) * ld;
        const int star = get<kForm>(cols, rw.as, i, lane);
        float sterm = 0.0f;
        int p = -1;
        if (star != kNone) {
            sterm = __fmul_rn(dload<kForm>(row + star), nca);
            const int t = star >> 5;
            p = static_cast<int>(*col_word(cols, rw.pr + t, lane)) +
                __popc(*col_word(cols, rw.bm + t, lane) & ((1u << (star & 31)) - 1u));
        }
#pragma unroll 4
        for (int q = 0; q < nfull; ++q) {
            const uint32_t word = *col_word(cols, rw.bl + q, lane);
            const int pq = p - q * n;
#pragma unroll
            for (int e = 0; e < n; ++e) {
                const float v = __fmul_rn(
                    dload<kForm>(row + ((word >> (8 * sizeof(T) * e)) & kMask)), c.between);
                if (pq == e) acc = __fadd_rn(acc, sterm);
                acc = __fadd_rn(acc, v);
            }
        }
        for (int s = nfull * n; s < bsize; ++s) {
            const float v = __fmul_rn(dload<kForm>(row + get<kForm>(cols, rw.bl, s, lane)),
                                      c.between);
            if (s == p) acc = __fadd_rn(acc, sterm);
            acc = __fadd_rn(acc, v);
        }
        if (p == bsize) acc = __fadd_rn(acc, sterm);
    }
    for (; sb < bsize; ++sb) {   // the b-rows after the last a-row
        const int nx = get<kForm>(cols, rw.bs, sb, lane);
        if (nx != kNone) {
            const int jb = get<kForm>(cols, rw.bl, sb, lane);
            acc = __fadd_rn(acc, __fmul_rn(dload<kForm>(mat + size_t(jb) * ld + nx), ncb));
        }
    }
    return acc;
}

// This lane's float64 score: score_f64 over its column's ORD.
template <int kForm>
__device__ __forceinline__ double walk_f64(const uint32_t* cols, const Block& b, const float* mat,
                                           int ld, int m, int asize, permk::NativeConst nc,
                                           int lane) {
    return permk::score_f64_at(mat, ld, b.rowtot,
                               [cols, lane](int p) { return get<kForm>(cols, 0, p, lane); }, m,
                               asize, nc);
}

}  // namespace permb
