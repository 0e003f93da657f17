// K10: the FET score and bootstrap stddev of pre-gathered windows, the
// FET part of the sharded divergence step.
//
// Replaces divergence_tpu/kernels/fet.py: fet_window_batch (count_tables
// -> _neglog10_p -> _aggregate on [B, P, a] / [B, P, b] codes, keyed by
// slot_keys(key, slot)).  Plain torch version:
// divergence_tpu_torch/kernels/fet.py fet_window_batch_plain.
//
// The window body is fet_window_stats.cuh's with wkey = fold_in(key,
// slot), launched as K2 launches it:
//   * warp path (the launch's widest window has P <= 128, the step's bench
//     windows at most 87 SNPs, and one warp's codes fit in shared memory):
//     one warp per window, 4 windows a block.  The warp stages its
//     window's contiguous [n, a] and [n, b] int16 blocks in shared memory
//     (16-byte cp.async copies where the batch's rows allow: the block
//     starts at w P_in a 2 bytes, 16-byte aligned when P_in a 2 is; 2-byte
//     copies otherwise), each lane counts
//     the 2x2 tables of its P/32 rows (fet_table.cuh:count_table,
//     snp_score: K1's code; the LUT entry in global memory where the
//     panel's LUT is on, else the support scan), and warp_window_stats
//     sorts them in registers;
//   * block path (P up to what a block's shared memory holds with the
//     replicates, fet_window_form, or panels too wide to stage): one
//     block per window, each thread a row s < n read in place, -inf pads
//     up to P, block_window_stats;
//   * wide path (fet_window_wide, wider windows): a persistent grid, each
//     block scoring its window's rows once into its slab of device
//     scratch and running band_window_stats on them.
// K1 and K2 run the same device code, so on the windows of a chromosome
// K10 equals K1 -> K2 bit for bit.
//
// What bounds it on H100: the bootstrap's arithmetic, as K2's: a window
// reads its n (a+b) codes once (~3.6 KB at n = 87, 11 + 10) and its
// draws need (t1+1) x (nsamples+1) threefry hashes and (t1+1) x nsamples
// pows.
#include "fet_table.cuh"
#include "fet_window_stats.cuh"

namespace {

using namespace fetk;

constexpr int kThreads = 128;

template <typename T>
struct CodeSlabs {
    // reps [nsamples] T, keys [pmax] T, then the a and b codes of pmax rows
    __host__ __device__ static size_t a_offset(int nsamples, int pmax) {
        return WarpSlabs<T, T>::bytes(nsamples, pmax);
    }
    __host__ __device__ static size_t b_offset(int nsamples, int pmax, int asize) {
        return a_offset(nsamples, pmax) + align16(static_cast<size_t>(pmax) * asize * 2);
    }
    __host__ __device__ static size_t bytes(int nsamples, int pmax, int asize, int bsize) {
        return b_offset(nsamples, pmax, asize) +
               align16(static_cast<size_t>(pmax) * bsize * 2);
    }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fet_window(const int16_t* __restrict__ av, const int16_t* __restrict__ bv,
           const int64_t* __restrict__ npos, const int64_t* __restrict__ slots,
           int64_t nwin, int p_in, int asize, int bsize,
           const T* __restrict__ lut, const T* __restrict__ lf, int nmax,
           int maxs, uint2 key, T perc, int nsamples, int pmax,
           T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sorted = reinterpret_cast<T*>(smem_raw);
    T* reps = sorted + pmax;

    const int64_t w = blockIdx.x;
    const int n = static_cast<int>(npos[w]);
    if (n <= 0) {
        if (threadIdx.x == 0) {
            out[w] = T(0);
            out[nwin + w] = T(0);
        }
        return;
    }
    const int16_t* a = av + w * p_in * asize;
    const int16_t* b = bv + w * p_in * bsize;
    const int P = window_pad(n);
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        T v = neg_inf<T>();
        if (i < n) {
            const Table t = count_table(a + static_cast<int64_t>(i) * asize, asize,
                                        b + static_cast<int64_t>(i) * bsize, bsize);
            v = snp_score(t, asize, bsize, lut, lf, nmax, maxs);
        }
        sorted[i] = v;
    }
    __syncthreads();
    const uint32_t slot = static_cast<uint32_t>(slots[w]);
    block_window_stats(sorted, reps, n, P, tf::fold_in(key, slot), perc, nsamples,
                       KeyIsValue<T>{}, out + w, out + nwin + w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fet_window_warp(const int16_t* __restrict__ av, const int16_t* __restrict__ bv,
                const int64_t* __restrict__ npos, const int64_t* __restrict__ slots,
                int64_t nwin, int p_in, int asize, int bsize,
                const T* __restrict__ lut, const T* __restrict__ lf, int nmax,
                int maxs, uint2 key, T perc, int nsamples, int pmax, int stage,
                T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t w = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
    if (w >= nwin) return;
    using Slabs = CodeSlabs<T>;
    unsigned char* mine = smem_raw + warp * Slabs::bytes(nsamples, pmax, asize, bsize);
    T* reps = reinterpret_cast<T*>(mine);
    T* slab = reinterpret_cast<T*>(mine + WarpSlabs<T, T>::slab_offset(nsamples));

    const int n = static_cast<int>(npos[w]);
    if (n <= 0) {
        if (lane == 0) {
            out[w] = T(0);
            out[nwin + w] = T(0);
        }
        return;
    }
    int16_t* a = reinterpret_cast<int16_t*>(mine + Slabs::a_offset(nsamples, pmax));
    int16_t* b = reinterpret_cast<int16_t*>(mine + Slabs::b_offset(nsamples, pmax, asize));
    stage_codes(a, av + w * p_in * asize, n * asize, stage, lane);
    stage_codes(b, bv + w * p_in * bsize, n * bsize, stage, lane);
    stage_wait(stage);
    auto score = [=](int i) {
        const Table t = count_table(a + i * asize, asize, b + i * bsize, bsize);
        return snp_score(t, asize, bsize, lut, lf, nmax, maxs);
    };
    const uint32_t slot = static_cast<uint32_t>(slots[w]);
    warp_window_stats(score, neg_inf<T>(), slab, reps, n, tf::fold_in(key, slot), perc,
                      nsamples, KeyIsValue<T>{}, out + w, out + nwin + w);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
fet_window_wide(const int16_t* __restrict__ av, const int16_t* __restrict__ bv,
                const int64_t* __restrict__ npos, const int64_t* __restrict__ slots,
                int64_t nwin, int p_in, int asize, int bsize, const T* __restrict__ lut,
                const T* __restrict__ lf, int nmax, int maxs, uint2 key, T perc,
                int nsamples, int pmax, int band_keys, T* __restrict__ gscratch,
                T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    using U = typename Radix<T>::U;
    T* g = gscratch + static_cast<int64_t>(blockIdx.x) * 2 * pmax;   // the window's scores
    U* gband = reinterpret_cast<U*>(g + pmax);
    for (int64_t w = blockIdx.x; w < nwin; w += gridDim.x) {
        const int n = static_cast<int>(npos[w]);
        if (n <= 0) {
            if (threadIdx.x == 0) {
                out[w] = T(0);
                out[nwin + w] = T(0);
            }
            continue;
        }
        const int16_t* a = av + w * p_in * asize;
        const int16_t* b = bv + w * p_in * bsize;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const Table t = count_table(a + static_cast<int64_t>(i) * asize, asize,
                                        b + static_cast<int64_t>(i) * bsize, bsize);
            g[i] = snp_score(t, asize, bsize, lut, lf, nmax, maxs);
        }
        __syncthreads();
        const uint32_t slot = static_cast<uint32_t>(slots[w]);
        band_window_stats(smem_raw, [=](int i) { return Radix<T>::to(g[i]); }, gband, n,
                          tf::fold_in(key, slot), perc, nsamples, band_keys,
                          [](U u) { return Radix<T>::from(u); }, out + w, out + nwin + w);
    }
}

template <typename T>
int launch_window(const int16_t* av, const int16_t* bv, const int64_t* npos,
                  const int64_t* slots, int64_t nwin, int p_in, int asize,
                  int bsize, const T* lut, const T* lf, int nmax, int maxs,
                  uint32_t key0, uint32_t key1, double perc, int nsamples,
                  int pmax, T* out, void* stream) {
    if (nwin == 0) return 0;
    if (asize < 1 || bsize < 1 || p_in < 1 || pmax < 32 || nsamples < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const uint2 key = make_uint2(key0, key1);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    // the warp body wherever one warp's codes fit in shared memory (a + b up
    // to ~800 individuals), else the block body, which reads them in place
    const size_t warp_bytes = CodeSlabs<T>::bytes(nsamples, pmax, asize, bsize);
    const int wpb = warps_per_block(warp_bytes);
    if (pmax <= kWarpMaxPad && wpb >= 1) {
        // 16-byte copies need every window's blocks 16-byte aligned: the
        // bases, and the row blocks' strides p_in a 2 and p_in b 2
        const bool aligned = reinterpret_cast<uintptr_t>(av) % 16 == 0 &&
                             reinterpret_cast<uintptr_t>(bv) % 16 == 0 &&
                             (static_cast<int64_t>(p_in) * asize * 2) % 16 == 0 &&
                             (static_cast<int64_t>(p_in) * bsize * 2) % 16 == 0;
        const int stage = aligned ? kAsync16 : kCopy2;
        const size_t smem = wpb * warp_bytes;
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                fet_window_warp<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (e != cudaSuccess) return static_cast<int>(e);
        }
        const int64_t blocks = (nwin + wpb - 1) / wpb;
        fet_window_warp<T><<<static_cast<unsigned>(blocks), wpb * 32, smem, st>>>(
            av, bv, npos, slots, nwin, p_in, asize, bsize, lut, lf, nmax, maxs, key,
            static_cast<T>(perc), nsamples, pmax, stage, out);
        return static_cast<int>(cudaGetLastError());
    }
    const size_t smem = static_cast<size_t>(pmax + nsamples) * sizeof(T);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            fet_window<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    fet_window<T><<<static_cast<unsigned>(nwin), kThreads, smem, st>>>(
        av, bv, npos, slots, nwin, p_in, asize, bsize, lut, lf, nmax, maxs, key,
        static_cast<T>(perc), nsamples, pmax, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

FET_EXPORT int fet_window_f64(const int16_t* av, const int16_t* bv,
                              const int64_t* npos, const int64_t* slots,
                              int64_t nwin, int p_in, int asize, int bsize,
                              const double* lut, const double* lf, int nmax,
                              int maxs, uint32_t key0, uint32_t key1,
                              double perc, int nsamples, int pmax, double* out,
                              void* stream) {
    return launch_window<double>(av, bv, npos, slots, nwin, p_in, asize, bsize,
                                 lut, lf, nmax, maxs, key0, key1, perc,
                                 nsamples, pmax, out, stream);
}

FET_EXPORT int fet_window_f32(const int16_t* av, const int16_t* bv,
                              const int64_t* npos, const int64_t* slots,
                              int64_t nwin, int p_in, int asize, int bsize,
                              const float* lut, const float* lf, int nmax,
                              int maxs, uint32_t key0, uint32_t key1,
                              double perc, int nsamples, int pmax, float* out,
                              void* stream) {
    return launch_window<float>(av, bv, npos, slots, nwin, p_in, asize, bsize,
                                lut, lf, nmax, maxs, key0, key1, perc,
                                nsamples, pmax, out, stream);
}

namespace {

template <typename T>
int launch_window_wide(const int16_t* av, const int16_t* bv, const int64_t* npos,
                       const int64_t* slots, int64_t nwin, int p_in, int asize, int bsize,
                       const T* lut, const T* lf, int nmax, int maxs, uint32_t key0,
                       uint32_t key1, double perc, int nsamples, int pmax, int band_keys,
                       T* gscratch, T* out, void* stream) {
    if (nwin == 0) return 0;
    if (asize < 1 || bsize < 1 || p_in < 1 || pmax < 32 || nsamples < 1 || band_keys < 0 ||
        gscratch == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    unsigned grid;
    size_t smem;
    const int rc = wide_config(fet_window_wide<T>, nwin, nsamples, sizeof(T), sizeof(T),
                               &grid, &smem);
    if (rc != 0) return rc;
    fet_window_wide<T><<<grid, kWideThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        av, bv, npos, slots, nwin, p_in, asize, bsize, lut, lf, nmax, maxs,
        make_uint2(key0, key1), static_cast<T>(perc), nsamples, pmax, band_keys, gscratch, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K10's wide path: fet_window's arguments, then the band keys a block
// sorts in shared memory (at most kBandKeys) and the scratch of
// fet_window_form's form 2.
FET_EXPORT int fet_window_wide_f64(const int16_t* av, const int16_t* bv, const int64_t* npos,
                                   const int64_t* slots, int64_t nwin, int p_in, int asize,
                                   int bsize, const double* lut, const double* lf, int nmax,
                                   int maxs, uint32_t key0, uint32_t key1, double perc,
                                   int nsamples, int pmax, int band_keys, double* gscratch,
                                   double* out, void* stream) {
    return launch_window_wide<double>(av, bv, npos, slots, nwin, p_in, asize, bsize, lut, lf,
                                      nmax, maxs, key0, key1, perc, nsamples, pmax, band_keys,
                                      gscratch, out, stream);
}

FET_EXPORT int fet_window_wide_f32(const int16_t* av, const int16_t* bv, const int64_t* npos,
                                   const int64_t* slots, int64_t nwin, int p_in, int asize,
                                   int bsize, const float* lut, const float* lf, int nmax,
                                   int maxs, uint32_t key0, uint32_t key1, double perc,
                                   int nsamples, int pmax, int band_keys, float* gscratch,
                                   float* out, void* stream) {
    return launch_window_wide<float>(av, bv, npos, slots, nwin, p_in, asize, bsize, lut, lf,
                                     nmax, maxs, key0, key1, perc, nsamples, pmax, band_keys,
                                     gscratch, out, stream);
}
