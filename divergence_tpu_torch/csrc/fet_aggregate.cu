// K2: window score (interpolated percentile of the per-SNP -log10 p) and
// bootstrap stddev, for every window of a chromosome in one launch.
//
// Replaces divergence_tpu/kernels/fet.py: fet_aggregate_all ->
// fet_aggregate_windows -> _aggregate, with _interp_ranks, _sorted_pick,
// _steps_max and _order_stat_uniforms.  Plain torch version:
// divergence_tpu_torch/kernels/fet.py fet_aggregate_plain.
//
// One block per window: load logs[lo, lo+n) contiguously into shared
// memory, -inf pads up to P = the next power of two >= n (at least 32),
// then fet_window_stats.cuh:window_stats (sort, picks, bootstrap, stddev,
// the steps shared with K10) with wkey = fold_in(chrom_key, slot).
//
// What bounds it on H100: latency of small blocks, not bytes or FLOPs.
// A window reads n (about 50 at the bench's density) scores once and
// runs ~21 sort stages plus (t1+1) x nsamples x 2 threefry hashes and
// pow calls (t1 ~ 0.05 n).  The design keeps everything of a window in
// shared memory and registers, reads its scores as one contiguous run,
// and launches every window at once so ~800k blocks keep all 132 SMs
// busy.  Threads past P/2 idle during the sort: that is the first thing
// a faster version would change (one warp per small window).
#include "fet_window_stats.cuh"

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
    const int P = window_pad(n);
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        sorted[i] = i < n ? logs[lo + i] : neg_inf<T>();
    }
    __syncthreads();
    window_stats(sorted, reps, n, P, tf::fold_in(chrom_key, slot), perc,
                 nsamples, KeyIsValue<T>{}, out + w, out + nwin + w);
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
