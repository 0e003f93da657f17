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
//   * block_window_stats, one block per window up to 4,096 SNPs: the same
//     network over shared memory with a barrier a stage, one thread a
//     sample; warp 0 sums the replicates.
// A launch takes the warp body when its widest window has P <= 128.
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
constexpr size_t kSmemLimit = 232448;         // bytes a Hopper block may use

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
    const size_t fit = kSmemLimit / warp_bytes;
    return static_cast<int>(fit < kWarpsPerBlock ? fit : kWarpsPerBlock);
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

// Every thread of the block calls it, after a barrier that publishes
// sorted[0, P).  reps holds nsamples values.  Thread 0 writes the window's
// score and stddev.  Needs blockDim.x >= 32.
template <typename T, typename K, typename ValueOf>
__device__ void block_window_stats(K* sorted, T* reps, int n, int P, uint2 wkey,
                                   T perc, int nsamples, ValueOf value_of,
                                   T* __restrict__ score_out,
                                   T* __restrict__ stddev_out) {
    for (int k = 2; k <= P; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < P; i += blockDim.x) {
                const int ixj = i ^ j;
                if (ixj > i) {
                    const K a = sorted[i];
                    const K b = sorted[ixj];
                    const bool up = (i & k) == 0;
                    if (up ? (a > b) : (a < b)) {
                        sorted[i] = b;
                        sorted[ixj] = a;
                    }
                }
            }
            __syncthreads();
        }
    }

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
