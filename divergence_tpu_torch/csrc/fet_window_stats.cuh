// The per-window body of K2, shared by K2 (fet_aggregate.cu), K10
// (fet_window.cu) and K2r (fet_aggregate_ranks.cu): a window's n per-SNP
// sort keys in, its score and bootstrap stddev out.  One definition, so
// K10 on gathered windows and K2r on LUT ranks equal K1 -> K2 on the
// chromosome bit for bit.
//
// Replaces divergence_tpu/kernels/fet.py: _aggregate and _aggregate_ranks,
// with _interp_ranks, _sorted_pick, _steps_max and _order_stat_uniforms.
// Plain torch version: divergence_tpu_torch/kernels/fet.py
// _aggregate_sorted (its _lane_moments is the stddev's order below).
//
// The keys are the scores themselves (K2, K10: value_of is KeyIsValue) or
// int32 ranks into the ascending LUT (K2r: value_of reads lut_sorted).
// value_of is non-decreasing, so the order statistics of the keys map to
// those of the scores, and every pick below is the same score either way.
//
//   1. bitonic sort of keys [0, P), ascending, P = window_pad(n): the n
//      keys in front, pads that sort first (-inf, or rank -1) up to P;
//      comparator (i, i ^ j) ascending iff (i & k) == 0, swapping only
//      when strictly out of order (so -0.0 and +0.0 keep their places);
//   2. score = (1-d) s[idx] + d s[hi] with end-anchored picks
//      s[P - n + rank] = value_of(sorted[P - n + rank]) (reference
//      statistics/fisher/cFisher.c:136-144);
//   3. bootstrap of nsamples replicates: the Renyi recursion
//      U_(n-j) = U_(n-j+1) * V_j^(1/max(n-j,1)), V_j = uniform(fold_in(
//      wkey, j), (nsamples,))[s] drawn with the threefry replica; the
//      resample's order statistic is s[ceil(n U) - 1];
//   4. population stddev of the replicates in a fixed order: sample s
//      belongs to lane s % 32, each lane sums its samples in order
//      (s = lane, lane + 32, ...) from 0, then an xor butterfly over the
//      lanes (strides 16, 8, 4, 2, 1) gives the total; the mean is total /
//      nsamples, and the squared deviations (d * d) are summed the same
//      way.
// The JAX version runs a fixed steps_max + 1 steps and masks past each
// window's t1 = n-1-idx; a step past t1 changes neither capture, so each
// window stops at its own t1 with identical results, and its last step's
// U is the captured U_(k1).
//
// Two bodies run the same network, draws and sums, so a window's bits do
// not depend on which one took it:
//   * warp_window_stats, one warp per window of P <= 128 (kWarpMaxPad):
//     each lane holds R = P/32 keys, element i = R lane + r in register r;
//     strides >= R are __shfl_xor_sync exchanges, strides below R
//     compare-exchanges within the lane, with no block barrier.  The sorted keys go to the
//     warp's shared slab for the picks.  The bootstrap runs step j on the
//     outside (one fold_in(wkey, j) per lane and step) and the lane's
//     kLaneSamples samples inside, in registers.
//   * block_window_stats, one block per window of P <= kBlockMaxPad
//     whose keys fit a block's shared memory with the nsamples
//     replicates: the same network over shared memory with a barrier a
//     stage, one thread a sample; warp 0 sums the replicates.
//   * band_window_stats, wider windows (the *_wide kernels; a
//     persistent grid, as many 256-thread blocks an SM as fit, at most
//     kWideBlocksPerSm, walks the windows).  It sorts nothing: the
//     output reads only the order statistics at idx, hi and the 2 x
//     nsamples bootstrap ranks, and those ranks come from the Renyi
//     recursion on wkey alone.  So, by all the block's threads:
//       1. the bootstrap first, the keys unread, in tiles of steps: the
//          step keys fold_in(wkey, j) and exponents 1 / max(n - j, 1)
//          once a window; the terms pow(V_{s,j}, e_j) over the tile's
//          (step, sample) pairs; then each sample folds its terms into u
//          in j order, capturing u2 at j == t2 (the same product chain,
//          so the same bits as the other bodies);
//       2. the band [r_lo, r_hi] that covers idx, hi and every sample's
//          ranks; a radix select of the keys at r_lo and r_hi (8-bit
//          digits, most significant first, warp-aggregated shared
//          histograms, 8 keys in flight a thread) over the window's n
//          keys mapped to unsigned integers in order (Radix: a float's
//          sign-flipped bits, an int rank offset by 2^31), read in place
//          (K10: from its per-SNP scores, computed once into device
//          scratch).  It stops after the first pass whose bins from
//          r_lo's to r_hi's hold at most kEarlyKeys keys: those keys are
//          the band.  Where it runs every digit (ends tied over more keys)
//          the band is the keys strictly between the two ends, at most
//          r_hi - r_lo - 1 of them.  The band is gathered and sorted in
//          shared memory (up to band_keys), else in device scratch by
//          wide_sort;
//       3. a pick at rank r is the band's key at r less the keys before
//          the band; below the band (ends tied) the low end's key, past
//          it the high end's: the values at those ranks are a property of
//          the multiset of keys, so they equal the sorted bodies' picks.
//     The replicates, stddev and score are computed as in the others.
// A launch takes the warp body when its widest window has P <= 128, the
// block body to P = kBlockMaxPad, else the wide body (fet_window_form,
// which the wrappers ask).
//
// Numerics: the same operations in the same order and dtype as the plain
// torch version (--fmad=false; the same libdevice pow, correctly rounded
// division and sqrt), so scores agree to the sort's picks and stddev to
// the sums' order, which the plain version mirrors.
#pragma once

#include "fet_common.cuh"
#include "threefry.cuh"

namespace fetk {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpMaxPad = 128;             // the widest window a warp sorts
constexpr int kLaneSamples = 4;               // samples a lane carries per pass
constexpr int kWarpsPerBlock = 4;             // windows a warp-body block takes
constexpr int kWideThreads = 256;             // the wide body's block
constexpr int kWideChunk = 4096;              // keys a shared-memory pass of wide_sort sorts
constexpr int kWideBlocksPerSm = 4;           // the wide body's persistent grid, at most
constexpr int kBandKeys = kWideChunk;         // band keys sorted in shared memory
constexpr int kTermTile = 4096;               // bootstrap terms a tile holds
constexpr int kRadixBins = 256;               // the select's digit: 8 bits
constexpr int kKeysInFlight = 8;              // keys a thread loads at once in the select
constexpr int kEarlyKeys = 512;               // the select stops once its band fits this
// The widest window the block body takes: past it the band body is
// faster on an H100 (tests/measure_large_forms.py, block / band body time:
// at P = 256 0.87 / 0.75 / 0.70 for K2 float32, K2 float64, K2r; at 512
// 1.36 / 1.13 / 0.82; at 1,024 1.91 / 1.55 / 1.48).
constexpr int kBlockMaxPad = 256;

// The padded sort width of a window of n SNPs: the next power of two
// >= n, at least 32 (kernels/fet.py:_window_pad).
__host__ __device__ __forceinline__ int window_pad(int n) {
    int P = 32;
    while (P < n) P <<= 1;
    return P;
}

__host__ __device__ __forceinline__ size_t align16(size_t bytes) {
    return (bytes + 15) & ~static_cast<size_t>(15);
}

// Windows a warp-body block takes when each warp needs warp_bytes of
// shared memory: up to kWarpsPerBlock, 0 when one warp does not fit.
inline int warps_per_block(size_t warp_bytes) {
    const size_t fit = smem_optin() / warp_bytes;
    return static_cast<int>(fit < kWarpsPerBlock ? fit : kWarpsPerBlock);
}

// Shared memory of the block body: P keys and nsamples replicates.
inline size_t block_bytes(int pmax, int nsamples, int key_bytes, int value_bytes) {
    return static_cast<size_t>(pmax) * key_bytes + static_cast<size_t>(nsamples) * value_bytes;
}

// Steps of the bootstrap a tile of the wide body takes.
__host__ __device__ inline int band_tile_steps(int nsamples) {
    return nsamples < kTermTile ? kTermTile / nsamples : 1;
}

// Shared memory of the wide body, in BandSmem's order: the band's keys,
// the tile's terms, the samples' u and u2, the tile's step keys and
// exponents, two histograms and the select's scalars.
__host__ __device__ inline size_t wide_bytes(int nsamples, int key_bytes, int value_bytes) {
    const size_t J = static_cast<size_t>(band_tile_steps(nsamples));
    return align16(static_cast<size_t>(kBandKeys) * key_bytes) +
           align16(J * nsamples * value_bytes) +
           2 * align16(static_cast<size_t>(nsamples) * value_bytes) +
           align16(J * 8) + align16(J * value_bytes) + 2 * kRadixBins * 4 + 64;
}

// The wide body's persistent grid on the current device (kWideBlocksPerSm
// blocks an SM), 0 where the device cannot be asked.
inline int64_t wide_grid() {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
        return 0;
    }
    return static_cast<int64_t>(sms) * kWideBlocksPerSm;
}

// The body a launch whose widest window pads to pmax takes: 0, the warp
// body (pmax <= kWarpMaxPad); 1, the block body (its keys and replicates
// in shared memory); 2, the wide body, with *scratch_bytes of device
// scratch (two slabs of pmax keys for each block of wide_grid: K10's
// per-SNP scores, and a band too wide for shared memory).  Negative:
// the device cannot be asked (-1) or not even the wide body's shared
// memory fits (-2).
inline int window_form(int pmax, int nsamples, int key_bytes, int value_bytes,
                       int64_t* scratch_bytes) {
    *scratch_bytes = 0;
    if (pmax <= kWarpMaxPad) return 0;
    const size_t limit = smem_optin();
    if (limit == 0) return -1;
    if (pmax <= kBlockMaxPad && block_bytes(pmax, nsamples, key_bytes, value_bytes) <= limit) {
        return 1;
    }
    if (wide_bytes(nsamples, key_bytes, value_bytes) > limit) return -2;
    const int64_t grid = wide_grid();
    if (grid == 0) return -1;
    *scratch_bytes = grid * 2 * pmax * key_bytes;
    return 2;
}

// Launch shape of the wide body: the grid (the blocks that fit an SM at
// once, at most kWideBlocksPerSm, and at most one block a window) and its
// shared memory, after opting the kernel in to it.
template <typename Kernel>
int wide_config(Kernel kernel, int64_t nwin, int nsamples, int key_bytes, int value_bytes,
                unsigned* grid, size_t* smem) {
    const int64_t full = wide_grid();
    if (full == 0) return static_cast<int>(cudaErrorInvalidValue);
    *smem = wide_bytes(nsamples, key_bytes, value_bytes);
    if (*smem > smem_optin()) return static_cast<int>(cudaErrorInvalidValue);
    if (*smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    int fit = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kWideThreads, *smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t blocks = full / kWideBlocksPerSm * (fit < kWideBlocksPerSm ? fit : kWideBlocksPerSm);
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    *grid = static_cast<unsigned>(nwin < blocks ? nwin : blocks);
    return 0;
}

// The value of a sort key that is the score itself (K2, K10).
template <typename T>
struct KeyIsValue {
    __device__ __forceinline__ T operator()(T key) const { return key; }
};

// A window's interpolation ranks and Renyi step targets (_interp_ranks).
template <typename T>
struct Picks {
    T nf, delta, t1, t2, rank_max;
    int idx, hi, steps;
    __device__ __forceinline__ Picks(int n, T perc) {
        const T one = T(1);
        const T zero = T(0);
        nf = static_cast<T>(n);
        const T xpos = (nf - one) * perc;
        idx = static_cast<int>(t_floor(xpos));
        delta = xpos - static_cast<T>(idx);
        hi = min(idx + 1, max(n - 1, 0));
        // steps down from U_(n): t1 = n - k1 = n-1-idx, t2 = n-1-hi <= t1
        t1 = t_max(nf - one - static_cast<T>(idx), zero);
        t2 = nf - one - static_cast<T>(hi);
        steps = static_cast<int>(t1);
        rank_max = t_max(nf - one, zero);
    }
};

// The resample's order statistic an order-statistic uniform picks:
// ceil(n u) - 1, clamped to [0, n - 1].
template <typename T>
__device__ __forceinline__ int rank_of(const Picks<T>& w, T u) {
    return static_cast<int>(t_min(t_max(t_ceil(w.nf * u) - T(1), T(0)), w.rank_max));
}

// One replicate percentile from its pair of order-statistic uniforms.
template <typename T, typename Pick>
__device__ __forceinline__ T replicate(const Picks<T>& w, T u1, T u2, Pick pick) {
    const T one = T(1);
    const T x1 = pick(rank_of(w, u1));
    const T x2 = w.hi == w.idx ? x1 : pick(rank_of(w, u2));
    return (one - w.delta) * x1 + w.delta * x2;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFullMask, v, m);
    return v;
}

// Population stddev of reps[0, nsamples) in the fixed lane order (step 4).
// All 32 lanes of one warp call it; every lane gets the same value.
template <typename T>
__device__ __forceinline__ T lane_order_stddev(const T* reps, int nsamples, int lane) {
    T part = T(0);
    for (int s = lane; s < nsamples; s += 32) part += reps[s];
    const T mu = warp_sum(part) / static_cast<T>(nsamples);
    T sq = T(0);
    for (int s = lane; s < nsamples; s += 32) {
        const T d = reps[s] - mu;
        sq += d * d;
    }
    return t_sqrt(warp_sum(sq) / static_cast<T>(nsamples));
}

// One stage (k, j) of the network over the keys s[0, n) by the block's
// threads, i0 the global index of s[0] (a multiple of n when n < P): the
// comparator (i, i ^ j) sorts ascending iff ((i0 + i) & k) == 0 and swaps
// only when strictly out of order.  No barrier.
template <typename K>
__device__ __forceinline__ void bitonic_stage(K* s, int n, int i0, int k, int j) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
            const K a = s[i];
            const K b = s[ixj];
            const bool up = ((i0 + i) & k) == 0;
            if (up ? (a > b) : (a < b)) {
                s[i] = b;
                s[ixj] = a;
            }
        }
    }
}

// The whole network over sorted[0, P) in one array, a barrier a stage.
template <typename K>
__device__ void block_sort(K* sorted, int P) {
    for (int k = 2; k <= P; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            bitonic_stage(sorted, P, 0, k, j);
            __syncthreads();
        }
    }
}

// Stages (k, j_hi), (k, j_hi / 2), ..., (k, 1) of every k in [k_lo, k_hi]
// (j_hi = k / 2 for all but k_lo, which starts at j_first) on each
// aligned chunk of S keys of g[0, P), staged in buf (S keys of shared
// memory): every comparator of those stages stays in its chunk.
template <typename K>
__device__ void chunk_pass(K* g, int P, K* buf, int S, int k_lo, int k_hi, int j_first) {
    for (int c0 = 0; c0 < P; c0 += S) {
        for (int i = threadIdx.x; i < S; i += blockDim.x) buf[i] = g[c0 + i];
        __syncthreads();
        for (int k = k_lo; k <= k_hi; k <<= 1) {
            for (int j = k == k_lo ? j_first : k >> 1; j > 0; j >>= 1) {
                bitonic_stage(buf, S, c0, k, j);
                __syncthreads();
            }
        }
        for (int i = threadIdx.x; i < S; i += blockDim.x) g[c0 + i] = buf[i];
        __syncthreads();
    }
}

// block_sort's comparators in block_sort's order over g[0, P) in device
// memory: stages of stride >= S over g, each run of stages of stride < S
// chunk by chunk in buf (kWideChunk keys, S = min(kWideChunk, P)).
template <typename K>
__device__ void wide_sort(K* g, int P, K* buf) {
    const int S = P < kWideChunk ? P : kWideChunk;
    chunk_pass(g, P, buf, S, 2, S, 1);   // every k <= S, whole
    for (int k = 2 * S; k <= P; k <<= 1) {
        for (int j = k >> 1; j >= S; j >>= 1) {
            bitonic_stage(g, P, 0, k, j);
            __syncthreads();
        }
        chunk_pass(g, P, buf, S, k, k, S >> 1);
    }
}

// The picks, bootstrap and stddev of a window from its sorted keys (after
// a barrier that publishes them).
template <typename T, typename K, typename ValueOf>
__device__ void window_picks(const K* sorted, T* reps, int n, int P, uint2 wkey, T perc,
                             int nsamples, ValueOf value_of, T* __restrict__ score_out,
                             T* __restrict__ stddev_out) {
    const T one = T(1);
    const Picks<T> w(n, perc);
    const int base = P - n;
    auto pick = [&](int rank) {
        return value_of(sorted[min(max(base + rank, 0), P - 1)]);
    };
    if (threadIdx.x == 0) {
        *score_out = (one - w.delta) * pick(w.idx) + w.delta * pick(w.hi);
    }
    for (int s = threadIdx.x; s < nsamples; s += blockDim.x) {
        T u = one, u2 = one;
        for (int j = 0; j <= w.steps; ++j) {
            const T jf = static_cast<T>(j);
            const T v = tf::uniform<T>(tf::fold_in(wkey, static_cast<uint32_t>(j)),
                                       static_cast<uint32_t>(s));
            u = u * t_pow(v, one / t_max(w.nf - jf, one));
            if (jf == w.t2) u2 = u;
        }
        reps[s] = replicate(w, u, u2, pick);   // the last step is t1: u = U_(k1)
    }
    __syncthreads();
    if (threadIdx.x < 32) {
        const T sd = lane_order_stddev(reps, nsamples, threadIdx.x);
        if (threadIdx.x == 0) *stddev_out = sd;
    }
}

// Every thread of the block calls it, after a barrier that publishes
// sorted[0, P).  reps holds nsamples values.  Thread 0 writes the window's
// score and stddev.  Needs blockDim.x >= 32.
template <typename T, typename K, typename ValueOf>
__device__ void block_window_stats(K* sorted, T* reps, int n, int P, uint2 wkey,
                                   T perc, int nsamples, ValueOf value_of,
                                   T* __restrict__ score_out,
                                   T* __restrict__ stddev_out) {
    block_sort(sorted, P);
    window_picks(sorted, reps, n, P, wkey, perc, nsamples, value_of, score_out, stddev_out);
}

// The wide body's shared memory, carved in wide_bytes's order.
template <typename T, typename U>
struct BandSmem {
    struct Scalars {
        U plo, phi;      // the select's prefixes, then the keys at r_lo and r_hi
        int klo, khi;    // the targets' ranks among the keys with the prefix
        int eq_lo;       // keys equal to the key at r_lo
        int rmin, rmax;  // the band's ends
        int count;       // band keys gathered
        U first, last;   // the last pass's bins of r_lo and r_hi, as a key range
        int below, upto; // keys below first, keys up to last
    };
    static_assert(sizeof(Scalars) <= 64, "wide_bytes keeps 64 bytes for the select's scalars");
    U* band;
    T* term;
    T* u1;
    T* u2;
    uint2* kj;
    T* ej;
    int* hist;           // [2][kRadixBins]: the low target's, the high one's
    Scalars* sc;
    __device__ BandSmem(unsigned char* p, int nsamples) {
        const size_t J = static_cast<size_t>(band_tile_steps(nsamples));
        band = reinterpret_cast<U*>(p);
        p += align16(sizeof(U) * kBandKeys);
        term = reinterpret_cast<T*>(p);
        p += align16(J * nsamples * sizeof(T));
        u1 = reinterpret_cast<T*>(p);
        p += align16(sizeof(T) * nsamples);
        u2 = reinterpret_cast<T*>(p);
        p += align16(sizeof(T) * nsamples);
        kj = reinterpret_cast<uint2*>(p);
        p += align16(J * 8);
        ej = reinterpret_cast<T*>(p);
        p += align16(J * sizeof(T));
        hist = reinterpret_cast<int*>(p);
        p += 2 * kRadixBins * 4;
        sc = reinterpret_cast<Scalars*>(p);
    }
};

// key with its bits below `bit` cleared (0 when bit is the key's width).
template <typename U>
__device__ __forceinline__ U high_bits(U key, int bit) {
    return bit >= static_cast<int>(8 * sizeof(U)) ? U(0) : key & ~((U(1) << bit) - U(1));
}

// Add the lanes with pred to hist[d], one shared atomic a digit a warp.
// All 32 lanes of the warp call it.
__device__ __forceinline__ void warp_count(int* hist, unsigned d, bool pred) {
    const unsigned act = __ballot_sync(kFullMask, pred);
    if (pred) {
        const unsigned peers = __match_any_sync(act, d);
        const unsigned lower = (1u << (threadIdx.x & 31)) - 1u;
        if ((peers & lower) == 0) atomicAdd(hist + d, __popc(peers));
    }
}

// One warp, every lane: the bin of h[0, kRadixBins) that holds the k-th
// key (from 0) in bin order, and the count of keys in the bins before it.
__device__ __forceinline__ void radix_bin(const int* h, int k, unsigned* bin, int* below) {
    constexpr int kPer = kRadixBins / 32;
    const int lane = threadIdx.x & 31;
    int c[kPer];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
        c[q] = h[kPer * lane + q];
        sum += c[q];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFullMask, incl, o);
        if (lane >= o) incl += t;
    }
    int acc = incl - sum;
    const int src = __ffs(__ballot_sync(kFullMask, acc <= k && k < incl)) - 1;
    int found = -1;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
        if (found < 0) {
            if (acc + c[q] > k) {
                found = q;
            } else {
                acc += c[q];
            }
        }
    }
    *bin = static_cast<unsigned>(__shfl_sync(kFullMask, kPer * lane + found, src));
    *below = __shfl_sync(kFullMask, acc, src);
}

// The wide body (see the top of this file).  Every thread of the block
// calls it; key_at(i) is key i < n of the window mapped by Radix, and
// value_of maps a mapped key to its score.  gband holds pmax mapped keys
// of device scratch for a band wider than band_keys (at most kBandKeys).
// Thread 0 writes the score and stddev.  Needs blockDim.x >= 64.  Ends
// with a barrier, so the block may take its next window.
template <typename T, typename U, typename KeyAt, typename ValueOf>
__device__ void band_window_stats(unsigned char* smem, KeyAt key_at, U* gband, int n,
                                  uint2 wkey, T perc, int nsamples, int band_keys,
                                  ValueOf value_of, T* __restrict__ score_out,
                                  T* __restrict__ stddev_out) {
    constexpr int kUBits = 8 * sizeof(U);
    const BandSmem<T, U> L(smem, nsamples);
    typename BandSmem<T, U>::Scalars* sc = L.sc;
    const T one = T(1);
    const Picks<T> w(n, perc);
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    // 1. the bootstrap, tile by tile of steps
    for (int s = tid; s < nsamples; s += nt) {
        L.u1[s] = one;
        L.u2[s] = one;
    }
    if (tid == 0) {
        sc->plo = sc->phi = U(0);
        sc->rmin = w.idx;
        sc->rmax = w.hi;
        sc->count = 0;
    }
    const int J = band_tile_steps(nsamples);
    for (int j0 = 0; j0 <= w.steps; j0 += J) {
        const int jn = min(J, w.steps + 1 - j0);
        for (int t = tid; t < jn; t += nt) {
            const T jf = static_cast<T>(j0 + t);
            L.kj[t] = tf::fold_in(wkey, static_cast<uint32_t>(j0 + t));
            L.ej[t] = one / t_max(w.nf - jf, one);
        }
        __syncthreads();
        const int items = jn * nsamples;
        for (int i = tid; i < items; i += nt) {
            const int j = i / nsamples;
            const int s = i - j * nsamples;
            L.term[i] = t_pow(tf::uniform<T>(L.kj[j], static_cast<uint32_t>(s)), L.ej[j]);
        }
        __syncthreads();
        for (int s = tid; s < nsamples; s += nt) {
            T u = L.u1[s];
            T u2 = L.u2[s];
            for (int j = 0; j < jn; ++j) {
                u = u * L.term[j * nsamples + s];
                if (static_cast<T>(j0 + j) == w.t2) u2 = u;
            }
            L.u1[s] = u;   // after the last tile: U_(k1), the step t1's u
            L.u2[s] = u2;
        }
        __syncthreads();
    }

    // 2. the band of ranks every pick falls in
    int rmin = w.idx;
    int rmax = w.hi;
    for (int s = tid; s < nsamples; s += nt) {
        const int r1 = rank_of(w, L.u1[s]);
        rmin = min(rmin, r1);
        rmax = max(rmax, r1);
        if (w.hi != w.idx) {
            const int r2 = rank_of(w, L.u2[s]);
            rmin = min(rmin, r2);
            rmax = max(rmax, r2);
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        rmin = min(rmin, __shfl_xor_sync(kFullMask, rmin, o));
        rmax = max(rmax, __shfl_xor_sync(kFullMask, rmax, o));
    }
    if (lane == 0) {
        atomicMin(&sc->rmin, rmin);
        atomicMax(&sc->rmax, rmax);
    }
    __syncthreads();
    const int r_lo = sc->rmin;
    const int r_hi = sc->rmax;
    if (tid == 0) {
        sc->klo = r_lo;
        sc->khi = r_hi;
    }

    // the keys at r_lo and r_hi, digit by digit from the top, until the
    // keys in the bins from r_lo's to r_hi's are few enough to sort
    const int cap = min(band_keys, kBandKeys);
    bool early = false;
    for (int shift = kUBits - 8; shift >= 0; shift -= 8) {
        for (int b = tid; b < 2 * kRadixBins; b += nt) L.hist[b] = 0;
        __syncthreads();
        const U plo = sc->plo;
        const U phi = sc->phi;
        const bool same = plo == phi;
        for (int i0 = 0; i0 < n; i0 += kKeysInFlight * nt) {
            U key[kKeysInFlight];   // the loads first, so they are in flight together
#pragma unroll
            for (int q = 0; q < kKeysInFlight; ++q) {
                const int i = i0 + q * nt + tid;
                key[q] = i < n ? key_at(i) : U(0);
            }
#pragma unroll
            for (int q = 0; q < kKeysInFlight; ++q) {
                const bool in = i0 + q * nt + tid < n;
                const U top = high_bits(key[q], shift + 8);
                const unsigned d = static_cast<unsigned>(key[q] >> shift) & (kRadixBins - 1);
                warp_count(L.hist, d, in && top == plo);
                if (!same) warp_count(L.hist + kRadixBins, d, in && top == phi);
            }
        }
        __syncthreads();
        if (warp < 2) {   // warp 0 the low target's bin, warp 1 the high one's
            const int* h = L.hist + (warp == 1 && !same ? kRadixBins : 0);
            unsigned bin;
            int below;
            radix_bin(h, warp == 0 ? sc->klo : sc->khi, &bin, &below);
            if (lane == 0) {
                const U digit = static_cast<U>(bin) << shift;
                if (warp == 0) {
                    sc->first = plo | digit;
                    sc->below = r_lo - sc->klo + below;   // keys below the bin
                    sc->plo = plo | digit;
                    sc->klo -= below;
                    if (shift == 0) sc->eq_lo = h[bin];
                } else {
                    sc->last = phi | digit | ((U(1) << shift) - U(1));
                    sc->upto = r_hi - sc->khi + below + h[bin];   // keys up to the bin's end
                    sc->phi = phi | digit;
                    sc->khi -= below;
                }
            }
        }
        __syncthreads();
        if (sc->upto - sc->below <= min(cap, kEarlyKeys)) {
            early = true;
            break;
        }
    }
    // the picks' keys: past the low end's count and before the high end's,
    // the band of keys in [first, last] sorted; else the key at r_lo below
    // and the key at r_hi above
    const U vlo = sc->plo;
    const U vhi = sc->phi;
    int le_lo, lt_hi;   // keys before the band, keys before its end
    U first, last;
    if (early) {
        le_lo = sc->below;
        lt_hi = sc->upto;
        first = sc->first;
        last = sc->last;
    } else {
        le_lo = r_lo - sc->klo + sc->eq_lo;   // keys <= vlo
        lt_hi = r_hi - sc->khi;               // keys < vhi
        first = vlo + U(1);
        last = vhi - U(1);
    }
    const int nb = lt_hi - le_lo;
    U* band = nb <= cap ? L.band : gband;
    if (nb > 0) {
        for (int i0 = 0; i0 < n; i0 += kKeysInFlight * nt) {
            U key[kKeysInFlight];
#pragma unroll
            for (int q = 0; q < kKeysInFlight; ++q) {
                const int i = i0 + q * nt + tid;
                key[q] = i < n ? key_at(i) : U(0);
            }
#pragma unroll
            for (int q = 0; q < kKeysInFlight; ++q) {
                const bool take = i0 + q * nt + tid < n && key[q] >= first && key[q] <= last;
                const unsigned mask = __ballot_sync(kFullMask, take);
                int base = 0;
                if (lane == 0 && mask) base = atomicAdd(&sc->count, __popc(mask));
                base = __shfl_sync(kFullMask, base, 0);
                if (take) band[base + __popc(mask & ((1u << lane) - 1u))] = key[q];
            }
        }
        int pb = 1;
        while (pb < nb) pb <<= 1;
        for (int i = nb + tid; i < pb; i += nt) band[i] = ~U(0);   // pads sort last
        __syncthreads();
        if (band == L.band) {
            block_sort(band, pb);
        } else {
            wide_sort(band, pb, L.band);
        }
    }

    // 3. the picks, replicates and stddev
    auto pick = [&](int r) {
        return value_of(r < le_lo ? vlo : (r >= lt_hi ? vhi : band[r - le_lo]));
    };
    if (tid == 0) *score_out = (one - w.delta) * pick(w.idx) + w.delta * pick(w.hi);
    for (int s = tid; s < nsamples; s += nt) L.u1[s] = replicate(w, L.u1[s], L.u2[s], pick);
    __syncthreads();
    if (tid < 32) {
        const T sd = lane_order_stddev(L.u1, nsamples, tid);
        if (tid == 0) *stddev_out = sd;
    }
    __syncthreads();
}

// One comparator of the network within a lane's registers.
template <typename K>
__device__ __forceinline__ void lane_exchange(K& lo, K& hi, bool up) {
    if (up ? (lo > hi) : (lo < hi)) {
        const K t = lo;
        lo = hi;
        hi = t;
    }
}

// The 32 lanes of one warp call it, for a window of 1 <= n <= 128 keys,
// load(i) giving key i < n; pad sorts first.  The window's P = R * 32
// elements lie R to a lane: element i = R lane + r in register r (R =
// P/32: 1, 2 or 4).  slab holds P keys and reps nsamples values of this
// warp in shared memory.  Lane 0 writes the window's score and stddev.
template <int R, typename T, typename K, typename ValueOf, typename Load>
__device__ void warp_window_stats_r(Load load, K pad, K* slab, T* reps, int n,
                                    uint2 wkey, T perc, int nsamples, ValueOf value_of,
                                    T* __restrict__ score_out,
                                    T* __restrict__ stddev_out) {
    constexpr int P = 32 * R;
    const int lane = threadIdx.x & 31;
    const int i0 = lane * R;
    K keys[R];
#pragma unroll
    for (int r = 0; r < R; ++r) keys[r] = i0 + r < n ? load(i0 + r) : pad;
    for (int k = 2; k <= P; k <<= 1) {
        for (int j = k >> 1; j >= R; j >>= 1) {   // strides >= R: across lanes
            const int lj = j / R;                  // partner lane distance
            const bool lower = (lane & lj) == 0;   // i < i ^ j
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const K other = __shfl_xor_sync(kFullMask, keys[r], lj);
                const bool up = ((i0 + r) & k) == 0;
                const K a = lower ? keys[r] : other;
                const K b = lower ? other : keys[r];
                if (up ? (a > b) : (a < b)) keys[r] = other;
            }
        }
#pragma unroll
        for (int j = R / 2; j > 0; j >>= 1) {      // strides < R: within the lane
            if (j < k) {
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    if ((r & j) == 0) lane_exchange(keys[r], keys[r | j], ((i0 + r) & k) == 0);
                }
            }
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) slab[i0 + r] = keys[r];
    __syncwarp();

    const T one = T(1);
    const Picks<T> w(n, perc);
    const int base = P - n;
    auto pick = [=](int rank) {
        return value_of(slab[min(max(base + rank, 0), P - 1)]);
    };
    if (lane == 0) {
        *score_out = (one - w.delta) * pick(w.idx) + w.delta * pick(w.hi);
    }
    for (int s0 = 0; s0 < nsamples; s0 += 32 * kLaneSamples) {
        T u[kLaneSamples], u2[kLaneSamples];
#pragma unroll
        for (int q = 0; q < kLaneSamples; ++q) u[q] = u2[q] = one;
        for (int j = 0; j <= w.steps; ++j) {
            const T jf = static_cast<T>(j);
            const uint2 kj = tf::fold_in(wkey, static_cast<uint32_t>(j));
            const T e = one / t_max(w.nf - jf, one);
#pragma unroll
            for (int q = 0; q < kLaneSamples; ++q) {
                const int s = s0 + 32 * q + lane;
                if (s < nsamples) {
                    const T v = tf::uniform<T>(kj, static_cast<uint32_t>(s));
                    u[q] = u[q] * t_pow(v, e);
                    if (jf == w.t2) u2[q] = u[q];
                }
            }
        }
#pragma unroll
        for (int q = 0; q < kLaneSamples; ++q) {
            const int s = s0 + 32 * q + lane;
            if (s < nsamples) reps[s] = replicate(w, u[q], u2[q], pick);
        }
    }
    __syncwarp();
    const T sd = lane_order_stddev(reps, nsamples, lane);
    if (lane == 0) *stddev_out = sd;
}

// warp_window_stats_r at the window's own R = window_pad(n) / 32.
template <typename T, typename K, typename ValueOf, typename Load>
__device__ __forceinline__ void warp_window_stats(Load load, K pad, K* slab, T* reps, int n,
                                                  uint2 wkey, T perc, int nsamples,
                                                  ValueOf value_of, T* __restrict__ score_out,
                                                  T* __restrict__ stddev_out) {
    const int P = window_pad(n);
    if (P == 32) {
        warp_window_stats_r<1>(load, pad, slab, reps, n, wkey, perc, nsamples, value_of,
                               score_out, stddev_out);
    } else if (P == 64) {
        warp_window_stats_r<2>(load, pad, slab, reps, n, wkey, perc, nsamples, value_of,
                               score_out, stddev_out);
    } else {
        warp_window_stats_r<4>(load, pad, slab, reps, n, wkey, perc, nsamples, value_of,
                               score_out, stddev_out);
    }
}

// Shared memory of one warp-body window: reps [nsamples] T, then the key
// slab [pmax] K, each 16-byte aligned (the caller may append more).
template <typename T, typename K>
struct WarpSlabs {
    __host__ __device__ static size_t slab_offset(int nsamples) {
        return align16(static_cast<size_t>(nsamples) * sizeof(T));
    }
    __host__ __device__ static size_t bytes(int nsamples, int pmax) {
        return slab_offset(nsamples) + align16(static_cast<size_t>(pmax) * sizeof(K));
    }
};

}  // namespace fetk
