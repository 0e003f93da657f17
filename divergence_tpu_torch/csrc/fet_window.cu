// K10: the FET score and bootstrap stddev of pre-gathered windows, the
// FET part of the sharded divergence step.
//
// Replaces divergence_tpu/kernels/fet.py: fet_window_batch (count_tables
// -> _neglog10_p -> _aggregate on [B, P, a] / [B, P, b] codes, keyed by
// slot_keys(key, slot)).  Plain torch version:
// divergence_tpu_torch/kernels/fet.py fet_window_batch_plain.
//
// One block per window:
//   1. each thread takes SNPs s < npos[b]: it counts the 2x2 table of row
//      s from the window's a + b int16 codes (a row stride of a or b
//      codes) and writes the score -log10 p into shared memory
//      (fet_table.cuh:snp_score, K1's code: the LUT entry in global
//      memory where the panel's LUT is on — 17,424 values at 11 + 10,
//      139 KB in float64, read through L1/L2 rather than staged in every
//      block's shared memory — else the support scan); -inf pads up to
//      P = the next power of two >= n;
//   2. fet_window_stats.cuh:window_stats, K2's block body, with wkey =
//      fold_in(key, slot).
// K1 and K2 run the same device code, so on the windows of a chromosome
// K10 equals K1 -> K2 bit for bit.
//
// What bounds it on H100: latency of small blocks, as K2.  A window reads
// its n (a+b) codes once (~3.6 KB at n = 87, 11 + 10) and then runs K2's
// sort and bootstrap.  Shared memory per block is P + nsamples values
// (1.8 KB in float64 at P = 128, 100 samples), so occupancy is bound by
// the 128-thread blocks, not by shared memory.
#include "fet_table.cuh"
#include "fet_window_stats.cuh"

namespace {

using namespace fetk;

constexpr int kThreads = 128;

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
    window_stats(sorted, reps, n, P, tf::fold_in(key, slot), perc, nsamples,
                 KeyIsValue<T>{}, out + w, out + nwin + w);
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
    const size_t smem = static_cast<size_t>(pmax + nsamples) * sizeof(T);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            fet_window<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    fet_window<T><<<static_cast<unsigned>(nwin), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        av, bv, npos, slots, nwin, p_in, asize, bsize, lut, lf, nmax, maxs,
        make_uint2(key0, key1), static_cast<T>(perc), nsamples, pmax, out);
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
