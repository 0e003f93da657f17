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
//   * block_window_stats, one block per window whose P keys take at most
//     kBlockKeyBytes (P up to 4,096 in float64, 8,192 in float32 and
//     int32 ranks) and fit a block's shared memory with the nsamples
//     replicates: the same network over shared memory with a barrier a
//     stage, one thread a sample; warp 0 sums the replicates.
//   * wide_window_stats, wider windows: the keys in a per-block slab of
//     device scratch (a persistent grid of wide_grid blocks walks the
//     windows, so the slabs stay few and L2-resident), the same
//     comparators in the same stage order: every stage whose stride j is
//     at least kWideChunk runs over the slab in device memory, and each
//     run of consecutive stages with j < kWideChunk runs chunk by chunk
//     in shared memory (their comparators never leave an aligned chunk of
//     kWideChunk keys, and a comparator's direction is its global index's
//     bit k, as in the one-pass network), so the sorted slab is the same
//     bits.  The picks and bootstrap read the slab in place.
// A launch takes the warp body when its widest window has P <= 128, the
// block body up to kBlockKeyBytes of keys, else the wide body
// (fet_window_form, which the wrappers ask).
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
constexpr int kWideChunk = 4096;              // keys a shared-memory pass sorts
constexpr int kWideBlocksPerSm = 2;           // the wide body's persistent grid
// The widest key slab the block body takes: past it the wide body is
// faster on an H100 (tests/measure_large_forms.py: block / wide 0.63-0.73
// at 32 KB of keys, 0.98-1.20 at 64 KB, 2.95-3.15 at 128 KB).
constexpr size_t kBlockKeyBytes = 32 * 1024;

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

// Shared memory of the wide body: kWideChunk keys, then the replicates.
__host__ __device__ inline size_t wide_bytes(int nsamples, int key_bytes, int value_bytes) {
    return align16(static_cast<size_t>(kWideChunk) * key_bytes) +
           align16(static_cast<size_t>(nsamples) * value_bytes);
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
// scratch (a slab of pmax keys for each block of wide_grid).  Negative:
// the device cannot be asked (-1) or not even the wide body's shared
// memory fits (-2).
inline int window_form(int pmax, int nsamples, int key_bytes, int value_bytes,
                       int64_t* scratch_bytes) {
    *scratch_bytes = 0;
    if (pmax <= kWarpMaxPad) return 0;
    const size_t limit = smem_optin();
    if (limit == 0) return -1;
    if (static_cast<size_t>(pmax) * key_bytes <= kBlockKeyBytes &&
        block_bytes(pmax, nsamples, key_bytes, value_bytes) <= limit) {
        return 1;
    }
    if (wide_bytes(nsamples, key_bytes, value_bytes) > limit) return -2;
    const int64_t grid = wide_grid();
    if (grid == 0) return -1;
    *scratch_bytes = grid * pmax * key_bytes;
    return 2;
}

// Launch shape of the wide body: the grid (at most one block a window) and
// its shared memory, after opting the kernel in to it.
template <typename Kernel>
int wide_config(Kernel kernel, int64_t nwin, int nsamples, int key_bytes, int value_bytes,
                unsigned* grid, size_t* smem) {
    const int64_t full = wide_grid();
    if (full == 0) return static_cast<int>(cudaErrorInvalidValue);
    *grid = static_cast<unsigned>(nwin < full ? nwin : full);
    *smem = wide_bytes(nsamples, key_bytes, value_bytes);
    if (*smem > smem_optin()) return static_cast<int>(cudaErrorInvalidValue);
    if (*smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
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

// One replicate percentile from its pair of order-statistic uniforms.
template <typename T, typename Pick>
__device__ __forceinline__ T replicate(const Picks<T>& w, T u1, T u2, Pick pick) {
    const T one = T(1);
    const T zero = T(0);
    const T r1 = t_min(t_max(t_ceil(w.nf * u1) - one, zero), w.rank_max);
    const T r2 = t_min(t_max(t_ceil(w.nf * u2) - one, zero), w.rank_max);
    const T x1 = pick(static_cast<int>(r1));
    const T x2 = w.hi == w.idx ? x1 : pick(static_cast<int>(r2));
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

// The wide body: block_window_stats with the keys in g (device memory),
// sorted by wide_sort through buf.  Ends with a barrier, so the block may
// refill g and reps for its next window.
template <typename T, typename K, typename ValueOf>
__device__ void wide_window_stats(K* g, K* buf, T* reps, int n, int P, uint2 wkey, T perc,
                                  int nsamples, ValueOf value_of, T* __restrict__ score_out,
                                  T* __restrict__ stddev_out) {
    wide_sort(g, P, buf);
    window_picks(g, reps, n, P, wkey, perc, nsamples, value_of, score_out, stddev_out);
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
