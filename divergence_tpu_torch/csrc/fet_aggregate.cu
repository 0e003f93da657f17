// K2: window score (interpolated percentile of the per-SNP -log10 p) and
// bootstrap stddev, for every window of a chromosome in one launch.
//
// Replaces divergence_tpu/kernels/fet.py: fet_aggregate_all ->
// fet_aggregate_windows -> _aggregate, with _interp_ranks, _sorted_pick,
// _steps_max and _order_stat_uniforms.  Plain torch version:
// divergence_tpu_torch/kernels/fet.py fet_aggregate_plain.
//
// One block per window:
//   1. load logs[lo, lo+n) contiguously into shared memory, -inf pads up
//      to P = the next power of two >= n (at least 32);
//   2. bitonic sort, ascending (pads first);
//   3. score = (1-d) s[idx] + d s[hi] with end-anchored picks
//      s[P - n + rank] (reference statistics/fisher/cFisher.c:136-144);
//   4. bootstrap, one thread per sample s: the Renyi recursion
//      U_(n-j) = U_(n-j+1) * V_j^(1/max(n-j,1)), V_j = uniform(fold_in(
//      wkey, j), (nsamples,))[s] drawn with the threefry replica, wkey =
//      fold_in(chrom_key, slot); the resample's order statistic is
//      s[ceil(n U) - 1];
//   5. population stddev of the nsamples replicate percentiles.
// The JAX version runs a fixed steps_max + 1 steps and masks past each
// window's t1 = n-1-idx; a step past t1 changes neither capture, so each
// window stops at its own t1 with identical results.
//
// What bounds it on H100: latency of small blocks, not bytes or FLOPs.
// A window reads n (about 50 at the bench's density) scores once and
// runs ~21 sort stages plus (t1+1) x nsamples x 2 threefry hashes and
// pow calls (t1 ~ 0.05 n).  The design keeps everything of a window in
// shared memory and registers, reads its scores as one contiguous run,
// and launches every window at once so ~800k blocks keep all 132 SMs
// busy.  Threads past P/2 idle during the sort: that is the first thing
// a faster version would change (one warp per small window).
//
// Numerics: the same operations in the same order and dtype as the plain
// torch version (--fmad=false; the same libdevice pow), so scores and
// stddev agree to round-off in the final mean/variance sums, which run
// sequentially here.
#include "fet_common.cuh"
#include "threefry.cuh"

namespace {

using namespace fetk;

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fet_aggregate(const T* __restrict__ logs, const int64_t* __restrict__ rows,
              int64_t nwin, uint2 chrom_key, T perc, int nsamples, int pmax,
              T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sorted = reinterpret_cast<T*>(smem_raw);
    T* reps = sorted + pmax;

    const int64_t w = blockIdx.x;
    const int64_t lo = rows[w];
    const int n = static_cast<int>(rows[nwin + w]);
    const uint32_t slot = static_cast<uint32_t>(rows[2 * nwin + w]);
    if (n <= 0) {
        if (threadIdx.x == 0) {
            out[w] = T(0);
            out[nwin + w] = T(0);
        }
        return;
    }
    int P = 32;
    while (P < n) P <<= 1;

    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        sorted[i] = i < n ? logs[lo + i] : neg_inf<T>();
    }
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < P; i += blockDim.x) {
                const int ixj = i ^ j;
                if (ixj > i) {
                    const T a = sorted[i];
                    const T b = sorted[ixj];
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
        return sorted[min(max(base + rank, 0), P - 1)];
    };
    if (threadIdx.x == 0) {
        out[w] = (one - delta) * pick(idx) + delta * pick(hi);
    }

    // steps down from U_(n): t1 = n - k1 = n-1-idx, t2 = n-1-hi <= t1
    const T t1 = t_max(nf - one - static_cast<T>(idx), zero);
    const T t2 = nf - one - static_cast<T>(hi);
    const int steps = static_cast<int>(t1);
    const T rank_max = t_max(nf - one, zero);
    const uint2 wkey = tf::fold_in(chrom_key, slot);
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
        out[nwin + w] = t_sqrt(ss / static_cast<T>(nsamples));
    }
}

template <typename T>
int launch_aggregate(const T* logs, const int64_t* rows, int64_t nwin,
                     uint32_t key0, uint32_t key1, double perc, int nsamples,
                     int pmax, T* out, void* stream) {
    if (nwin == 0) return 0;
    const size_t smem = static_cast<size_t>(pmax + nsamples) * sizeof(T);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            fet_aggregate<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    fet_aggregate<T><<<static_cast<unsigned>(nwin), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        logs, rows, nwin, make_uint2(key0, key1), static_cast<T>(perc),
        nsamples, pmax, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

FET_EXPORT int fet_aggregate_f64(const double* logs, const int64_t* rows,
                                 int64_t nwin, uint32_t key0, uint32_t key1,
                                 double perc, int nsamples, int pmax,
                                 double* out, void* stream) {
    return launch_aggregate<double>(logs, rows, nwin, key0, key1, perc,
                                    nsamples, pmax, out, stream);
}

FET_EXPORT int fet_aggregate_f32(const float* logs, const int64_t* rows,
                                 int64_t nwin, uint32_t key0, uint32_t key1,
                                 double perc, int nsamples, int pmax,
                                 float* out, void* stream) {
    return launch_aggregate<float>(logs, rows, nwin, key0, key1, perc,
                                   nsamples, pmax, out, stream);
}
