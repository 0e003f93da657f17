// K2: window score (interpolated percentile of the per-SNP -log10 p) and
// bootstrap stddev, for every window of a chromosome in one launch.
//
// Replaces divergence_tpu/kernels/fet.py: fet_aggregate_all ->
// fet_aggregate_windows -> _aggregate, with _interp_ranks, _sorted_pick,
// _steps_max and _order_stat_uniforms.  Plain torch version:
// divergence_tpu_torch/kernels/fet.py fet_aggregate_plain.
//
// The window body is fet_window_stats.cuh's, with wkey = fold_in(
// chrom_key, slot):
//   * warp path (the launch's widest window has P <= 128, the bench's 87
//     SNPs included): one warp per window, 4 windows a block; each lane
//     loads its P/32 keys logs[lo + (P/32) lane + r] (the window's run is
//     contiguous) and warp_window_stats sorts them in registers;
//   * block path (P up to what a block's shared memory holds with the
//     replicates, fet_window_form): one block per window loads logs[lo,
//     lo+n) into shared memory, -inf pads up to P, block_window_stats;
//   * wide path (fet_aggregate_wide, wider windows): a persistent grid,
//     each block running band_window_stats on its window's keys in place
//     (no sort: the bootstrap first, then a radix select of the band of
//     ranks its picks need).
//
// What bounds it on H100: the bootstrap's arithmetic, not bytes.  A
// window reads n (about 50 at the bench's density) scores once; its
// draws need (t1+1) x (nsamples+1) threefry hashes (a fold_in a step,
// which each lane computes for itself) and (t1+1) x nsamples pows
// (t1 ~ 0.05 n).  A warp per window keeps the sort in registers with no
// block barrier, and no lane sits idle past P/2.
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
    block_window_stats(sorted, reps, n, P, tf::fold_in(chrom_key, slot), perc,
                       nsamples, KeyIsValue<T>{}, out + w, out + nwin + w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fet_aggregate_warp(const T* __restrict__ logs, const int64_t* __restrict__ rows,
                   int64_t nwin, uint2 chrom_key, T perc, int nsamples, int pmax,
                   T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t w = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
    if (w >= nwin) return;
    using Slabs = WarpSlabs<T, T>;
    unsigned char* mine = smem_raw + warp * Slabs::bytes(nsamples, pmax);
    T* reps = reinterpret_cast<T*>(mine);
    T* slab = reinterpret_cast<T*>(mine + Slabs::slab_offset(nsamples));

    const int64_t lo = rows[w];
    const int n = static_cast<int>(rows[nwin + w]);
    const uint32_t slot = static_cast<uint32_t>(rows[2 * nwin + w]);
    if (n <= 0) {
        if (lane == 0) {
            out[w] = T(0);
            out[nwin + w] = T(0);
        }
        return;
    }
    warp_window_stats([=](int i) { return logs[lo + i]; }, neg_inf<T>(), slab, reps, n,
                      tf::fold_in(chrom_key, slot), perc, nsamples, KeyIsValue<T>{},
                      out + w, out + nwin + w);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
fet_aggregate_wide(const T* __restrict__ logs, const int64_t* __restrict__ rows,
                   int64_t nwin, uint2 chrom_key, T perc, int nsamples, int pmax,
                   int band_keys, T* __restrict__ gscratch, T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    using U = typename Radix<T>::U;
    U* gband = reinterpret_cast<U*>(gscratch + static_cast<int64_t>(blockIdx.x) * 2 * pmax);
    for (int64_t w = blockIdx.x; w < nwin; w += gridDim.x) {
        const int64_t lo = rows[w];
        const int n = static_cast<int>(rows[nwin + w]);
        const uint32_t slot = static_cast<uint32_t>(rows[2 * nwin + w]);
        if (n <= 0) {
            if (threadIdx.x == 0) {
                out[w] = T(0);
                out[nwin + w] = T(0);
            }
            continue;
        }
        const T* x = logs + lo;
        band_window_stats(smem_raw, [=](int i) { return Radix<T>::to(x[i]); }, gband, n,
                          tf::fold_in(chrom_key, slot), perc, nsamples, band_keys,
                          [](U u) { return Radix<T>::from(u); }, out + w, out + nwin + w);
    }
}

template <typename T>
int launch_aggregate_wide(const T* logs, const int64_t* rows, int64_t nwin, uint32_t key0,
                          uint32_t key1, double perc, int nsamples, int pmax, int band_keys,
                          T* gscratch, T* out, void* stream) {
    if (nwin == 0) return 0;
    if (pmax < 32 || nsamples < 1 || band_keys < 0 || gscratch == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    unsigned grid;
    size_t smem;
    const int rc = wide_config(fet_aggregate_wide<T>, nwin, nsamples, sizeof(T), sizeof(T),
                               &grid, &smem);
    if (rc != 0) return rc;
    fet_aggregate_wide<T><<<grid, kWideThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        logs, rows, nwin, make_uint2(key0, key1), static_cast<T>(perc), nsamples, pmax,
        band_keys, gscratch, out);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_aggregate(const T* logs, const int64_t* rows, int64_t nwin,
                     uint32_t key0, uint32_t key1, double perc, int nsamples,
                     int pmax, T* out, void* stream) {
    if (nwin == 0) return 0;
    if (pmax < 32 || nsamples < 1) return static_cast<int>(cudaErrorInvalidValue);
    const uint2 key = make_uint2(key0, key1);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (pmax <= kWarpMaxPad) {
        const size_t warp_bytes = WarpSlabs<T, T>::bytes(nsamples, pmax);
        const int wpb = warps_per_block(warp_bytes);
        if (wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
        const size_t smem = wpb * warp_bytes;
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                fet_aggregate_warp<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (e != cudaSuccess) return static_cast<int>(e);
        }
        const int64_t blocks = (nwin + wpb - 1) / wpb;
        fet_aggregate_warp<T><<<static_cast<unsigned>(blocks), wpb * 32, smem, st>>>(
            logs, rows, nwin, key, static_cast<T>(perc), nsamples, pmax, out);
        return static_cast<int>(cudaGetLastError());
    }
    const size_t smem = static_cast<size_t>(pmax + nsamples) * sizeof(T);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            fet_aggregate<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    fet_aggregate<T><<<static_cast<unsigned>(nwin), kThreads, smem, st>>>(
        logs, rows, nwin, key, static_cast<T>(perc), nsamples, pmax, out);
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

// The body K2, K2r and K10 take for a launch whose widest window pads to
// pmax (fet_window_stats.cuh window_form): 0 warp, 1 block, 2 wide with
// *scratch_bytes of device scratch; negative where it cannot run.
FET_EXPORT int fet_window_form(int pmax, int nsamples, int key_bytes, int value_bytes,
                               int64_t* scratch_bytes) {
    return window_form(pmax, nsamples, key_bytes, value_bytes, scratch_bytes);
}

// K2's wide path: fet_aggregate's arguments, then the band keys a block
// sorts in shared memory before it takes device scratch (at most
// kBandKeys) and the scratch of fet_window_form's form 2.
FET_EXPORT int fet_aggregate_wide_f64(const double* logs, const int64_t* rows, int64_t nwin,
                                      uint32_t key0, uint32_t key1, double perc,
                                      int nsamples, int pmax, int band_keys, double* gscratch,
                                      double* out, void* stream) {
    return launch_aggregate_wide<double>(logs, rows, nwin, key0, key1, perc, nsamples, pmax,
                                         band_keys, gscratch, out, stream);
}

FET_EXPORT int fet_aggregate_wide_f32(const float* logs, const int64_t* rows, int64_t nwin,
                                      uint32_t key0, uint32_t key1, double perc,
                                      int nsamples, int pmax, int band_keys, float* gscratch,
                                      float* out, void* stream) {
    return launch_aggregate_wide<float>(logs, rows, nwin, key0, key1, perc, nsamples, pmax,
                                        band_keys, gscratch, out, stream);
}
