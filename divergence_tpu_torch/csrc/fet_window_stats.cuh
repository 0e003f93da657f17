// The per-window body of K2, shared by K2 (fet_aggregate.cu), K10
// (fet_window.cu) and K2r (fet_aggregate_ranks.cu): one block holds a
// window's n per-SNP sort keys in shared memory and computes its score and
// bootstrap stddev.  One definition, so K10 on gathered windows and K2r
// on LUT ranks equal K1 -> K2 on the chromosome bit for bit.
//
// Replaces divergence_tpu/kernels/fet.py: _aggregate and _aggregate_ranks,
// with _interp_ranks, _sorted_pick, _steps_max and _order_stat_uniforms.
// Plain torch version: divergence_tpu_torch/kernels/fet.py
// _aggregate_sorted.
//
// The keys are the scores themselves (K2, K10: value_of is KeyIsValue) or
// int32 ranks into the ascending LUT (K2r: value_of reads lut_sorted).
// value_of is non-decreasing, so the order statistics of the keys map to
// those of the scores, and every pick below is the same score either way.
//
//   1. bitonic sort of sorted[0, P), ascending: the caller has put the n
//      keys in front and pads that sort first (-inf, or rank -1) up to P;
//   2. score = (1-d) s[idx] + d s[hi] with end-anchored picks
//      s[P - n + rank] = value_of(sorted[P - n + rank]) (reference
//      statistics/fisher/cFisher.c:136-144);
//   3. bootstrap, one thread per sample s: the Renyi recursion
//      U_(n-j) = U_(n-j+1) * V_j^(1/max(n-j,1)), V_j = uniform(fold_in(
//      wkey, j), (nsamples,))[s] drawn with the threefry replica; the
//      resample's order statistic is s[ceil(n U) - 1];
//   4. population stddev of the nsamples replicate percentiles.
// The JAX version runs a fixed steps_max + 1 steps and masks past each
// window's t1 = n-1-idx; a step past t1 changes neither capture, so each
// window stops at its own t1 with identical results.
//
// Numerics: the same operations in the same order and dtype as the plain
// torch version (--fmad=false; the same libdevice pow), so scores and
// stddev agree to round-off in the final mean/variance sums, which run
// sequentially here.
#pragma once

#include "fet_common.cuh"
#include "threefry.cuh"

namespace fetk {

// The padded sort width of a window of n SNPs: the next power of two
// >= n, at least 32 (kernels/fet.py:_window_pad).
__device__ __forceinline__ int window_pad(int n) {
    int P = 32;
    while (P < n) P <<= 1;
    return P;
}

// The value of a sort key that is the score itself (K2, K10).
template <typename T>
struct KeyIsValue {
    __device__ __forceinline__ T operator()(T key) const { return key; }
};

// Every thread of the block calls it, after a barrier that publishes
// sorted[0, P).  reps holds nsamples values.  Thread 0 writes the window's
// score and stddev.
template <typename T, typename K, typename ValueOf>
__device__ void window_stats(K* sorted, T* reps, int n, int P, uint2 wkey,
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
    const T zero = T(0);
    const T nf = static_cast<T>(n);
    const T xpos = (nf - one) * perc;
    const int idx = static_cast<int>(t_floor(xpos));
    const T delta = xpos - static_cast<T>(idx);
    const int hi = min(idx + 1, max(n - 1, 0));
    const int base = P - n;
    auto pick = [&](int rank) {
        return value_of(sorted[min(max(base + rank, 0), P - 1)]);
    };
    if (threadIdx.x == 0) {
        *score_out = (one - delta) * pick(idx) + delta * pick(hi);
    }

    // steps down from U_(n): t1 = n - k1 = n-1-idx, t2 = n-1-hi <= t1
    const T t1 = t_max(nf - one - static_cast<T>(idx), zero);
    const T t2 = nf - one - static_cast<T>(hi);
    const int steps = static_cast<int>(t1);
    const T rank_max = t_max(nf - one, zero);
    for (int s = threadIdx.x; s < nsamples; s += blockDim.x) {
        T u = one, u1 = one, u2 = one;
        for (int j = 0; j <= steps; ++j) {
            const T jf = static_cast<T>(j);
            const T v = tf::uniform<T>(tf::fold_in(wkey, static_cast<uint32_t>(j)),
                                       static_cast<uint32_t>(s));
            u = u * t_pow(v, one / t_max(nf - jf, one));
            if (jf == t2) u2 = u;
            if (jf == t1) u1 = u;
        }
        const T r1 = t_min(t_max(t_ceil(nf * u1) - one, zero), rank_max);
        const T r2 = t_min(t_max(t_ceil(nf * u2) - one, zero), rank_max);
        const T x1 = pick(static_cast<int>(r1));
        const T x2 = hi == idx ? x1 : pick(static_cast<int>(r2));
        reps[s] = (one - delta) * x1 + delta * x2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        T sum = zero;
        for (int s = 0; s < nsamples; ++s) sum += reps[s];
        const T mu = sum / static_cast<T>(nsamples);
        T ss = zero;
        for (int s = 0; s < nsamples; ++s) {
            const T d = reps[s] - mu;
            ss += d * d;
        }
        *stddev_out = t_sqrt(ss / static_cast<T>(nsamples));
    }
}

}  // namespace fetk
