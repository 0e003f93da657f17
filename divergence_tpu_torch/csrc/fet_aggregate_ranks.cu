// K2r: K2 in LUT-rank space — the window score and bootstrap stddev of
// every window of a chromosome from its SNPs' int32 ranks into the
// ascending LUT (K1r, fet_rank.cu).
//
// Replaces divergence_tpu/kernels/fet.py: fet_aggregate_all_ranks ->
// _aggregate_ranks (the int32 sort with -1 pads, _sorted_pick, and the
// picks mapped through lut_sorted just before interpolation).  Plain
// torch version: divergence_tpu_torch/kernels/fet.py
// fet_aggregate_ranks_plain.
//
// The window body is fet_window_stats.cuh's with value_of = a read of
// lut_sorted, launched as K2 launches it (a warp per window where the
// launch's widest window has P <= 128, a block per window where it fits
// shared memory, else fet_aggregate_ranks_wide's persistent blocks on
// slabs of device scratch; -1 pads up to P).  The sort, picks, Renyi bootstrap and stddev are K2's own
// code, so the result equals K1 -> K2 bit for bit: the window's ranks map
// to the same multiset of scores in the same order.
//
// What bounds it on H100: as K2, the bootstrap's hashes and pows.
// Against K2 the sort moves 4-byte keys instead of 8-byte doubles in
// exact mode, and each pick adds one read of lut_sorted (139 KB in
// float64 at 11 + 10, resident in L1/L2).
#include "fet_window_stats.cuh"

namespace {

using namespace fetk;

constexpr int kThreads = 128;

// The score of a LUT rank.  end-anchored picks never read a -1 pad of a
// window with n > 0; the clamp keeps any rank in range, as JAX's clip.
template <typename T>
struct LutValue {
    const T* __restrict__ lut_sorted;
    int G;
    __device__ __forceinline__ T operator()(int rank) const {
        return __ldg(lut_sorted + min(max(rank, 0), G - 1));
    }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fet_aggregate_ranks(const T* __restrict__ lut_sorted, int G,
                    const int* __restrict__ ranks,
                    const int64_t* __restrict__ rows, int64_t nwin,
                    uint2 chrom_key, T perc, int nsamples, int pmax,
                    T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* reps = reinterpret_cast<T*>(smem_raw);
    int* sorted = reinterpret_cast<int*>(reps + nsamples);

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
        sorted[i] = i < n ? ranks[lo + i] : -1;
    }
    __syncthreads();
    block_window_stats(sorted, reps, n, P, tf::fold_in(chrom_key, slot), perc,
                       nsamples, LutValue<T>{lut_sorted, G}, out + w, out + nwin + w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fet_aggregate_ranks_warp(const T* __restrict__ lut_sorted, int G,
                         const int* __restrict__ ranks,
                         const int64_t* __restrict__ rows, int64_t nwin,
                         uint2 chrom_key, T perc, int nsamples, int pmax,
                         T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t w = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
    if (w >= nwin) return;
    using Slabs = WarpSlabs<T, int>;
    unsigned char* mine = smem_raw + warp * Slabs::bytes(nsamples, pmax);
    T* reps = reinterpret_cast<T*>(mine);
    int* slab = reinterpret_cast<int*>(mine + Slabs::slab_offset(nsamples));

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
    warp_window_stats([=](int i) { return ranks[lo + i]; }, -1, slab, reps, n,
                      tf::fold_in(chrom_key, slot), perc, nsamples,
                      LutValue<T>{lut_sorted, G}, out + w, out + nwin + w);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
fet_aggregate_ranks_wide(const T* __restrict__ lut_sorted, int G,
                         const int* __restrict__ ranks, const int64_t* __restrict__ rows,
                         int64_t nwin, uint2 chrom_key, T perc, int nsamples, int pmax,
                         int band_keys, int* __restrict__ gscratch, T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    using U = Radix<int>::U;
    U* gband = reinterpret_cast<U*>(gscratch + static_cast<int64_t>(blockIdx.x) * 2 * pmax);
    const LutValue<T> lut{lut_sorted, G};
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
        const int* x = ranks + lo;
        band_window_stats(smem_raw, [=](int i) { return Radix<int>::to(x[i]); }, gband, n,
                          tf::fold_in(chrom_key, slot), perc, nsamples, band_keys,
                          [=](U u) { return lut(Radix<int>::from(u)); }, out + w,
                          out + nwin + w);
    }
}

template <typename T>
int launch_aggregate_ranks_wide(const T* lut_sorted, int G, const int* ranks,
                                const int64_t* rows, int64_t nwin, uint32_t key0,
                                uint32_t key1, double perc, int nsamples, int pmax,
                                int band_keys, int* gscratch, T* out, void* stream) {
    if (nwin == 0) return 0;
    if (G < 1 || pmax < 32 || nsamples < 1 || band_keys < 0 || gscratch == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    unsigned grid;
    size_t smem;
    const int rc = wide_config(fet_aggregate_ranks_wide<T>, nwin, nsamples, sizeof(int),
                               sizeof(T), &grid, &smem);
    if (rc != 0) return rc;
    fet_aggregate_ranks_wide<T><<<grid, kWideThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
        lut_sorted, G, ranks, rows, nwin, make_uint2(key0, key1), static_cast<T>(perc),
        nsamples, pmax, band_keys, gscratch, out);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_aggregate_ranks(const T* lut_sorted, int G, const int* ranks,
                           const int64_t* rows, int64_t nwin, uint32_t key0,
                           uint32_t key1, double perc, int nsamples, int pmax,
                           T* out, void* stream) {
    if (nwin == 0) return 0;
    if (G < 1 || pmax < 32 || nsamples < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const uint2 key = make_uint2(key0, key1);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (pmax <= kWarpMaxPad) {
        const size_t warp_bytes = WarpSlabs<T, int>::bytes(nsamples, pmax);
        const int wpb = warps_per_block(warp_bytes);
        if (wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
        const size_t smem = wpb * warp_bytes;
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                fet_aggregate_ranks_warp<T>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
            if (e != cudaSuccess) return static_cast<int>(e);
        }
        const int64_t blocks = (nwin + wpb - 1) / wpb;
        fet_aggregate_ranks_warp<T><<<static_cast<unsigned>(blocks), wpb * 32, smem, st>>>(
            lut_sorted, G, ranks, rows, nwin, key, static_cast<T>(perc), nsamples, pmax,
            out);
        return static_cast<int>(cudaGetLastError());
    }
    const size_t smem = static_cast<size_t>(nsamples) * sizeof(T) +
                        static_cast<size_t>(pmax) * sizeof(int);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            fet_aggregate_ranks<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    fet_aggregate_ranks<T><<<static_cast<unsigned>(nwin), kThreads, smem, st>>>(
        lut_sorted, G, ranks, rows, nwin, key, static_cast<T>(perc), nsamples, pmax, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

FET_EXPORT int fet_aggregate_ranks_f64(const double* lut_sorted, int G,
                                       const int* ranks, const int64_t* rows,
                                       int64_t nwin, uint32_t key0,
                                       uint32_t key1, double perc,
                                       int nsamples, int pmax, double* out,
                                       void* stream) {
    return launch_aggregate_ranks<double>(lut_sorted, G, ranks, rows, nwin,
                                          key0, key1, perc, nsamples, pmax,
                                          out, stream);
}

FET_EXPORT int fet_aggregate_ranks_f32(const float* lut_sorted, int G,
                                       const int* ranks, const int64_t* rows,
                                       int64_t nwin, uint32_t key0,
                                       uint32_t key1, double perc,
                                       int nsamples, int pmax, float* out,
                                       void* stream) {
    return launch_aggregate_ranks<float>(lut_sorted, G, ranks, rows, nwin,
                                         key0, key1, perc, nsamples, pmax,
                                         out, stream);
}

// K2r's wide path: fet_aggregate_ranks's arguments, then the band keys a
// block sorts in shared memory (at most kBandKeys) and the scratch of
// fet_window_form's form 2 (int32 keys).
FET_EXPORT int fet_aggregate_ranks_wide_f64(const double* lut_sorted, int G, const int* ranks,
                                            const int64_t* rows, int64_t nwin, uint32_t key0,
                                            uint32_t key1, double perc, int nsamples,
                                            int pmax, int band_keys, int* gscratch,
                                            double* out, void* stream) {
    return launch_aggregate_ranks_wide<double>(lut_sorted, G, ranks, rows, nwin, key0, key1,
                                               perc, nsamples, pmax, band_keys, gscratch, out,
                                               stream);
}

FET_EXPORT int fet_aggregate_ranks_wide_f32(const float* lut_sorted, int G, const int* ranks,
                                            const int64_t* rows, int64_t nwin, uint32_t key0,
                                            uint32_t key1, double perc, int nsamples,
                                            int pmax, int band_keys, int* gscratch,
                                            float* out, void* stream) {
    return launch_aggregate_ranks_wide<float>(lut_sorted, G, ranks, rows, nwin, key0, key1,
                                              perc, nsamples, pmax, band_keys, gscratch, out,
                                              stream);
}
