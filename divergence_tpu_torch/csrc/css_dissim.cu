// K3 (and K4): opposite-homozygote pair counts of every window of a
// chromosome, in one launch.
//
// Replaces divergence_tpu/kernels/css.py: dissimilarity_prefix +
// dissimilarity_from_prefix (the [N+1, m, m] chromosome prefix, K3) and
// dissimilarity_counts (the one-hot product over gathered windows, K4).
// Both give the same integer counts; this kernel counts each window
// directly, so it needs neither the prefix (N m^2 elements, the JAX
// engine's memory cliff) nor a gather.  Plain torch version:
// divergence_tpu_torch/kernels/css.py dissimilarity_plain.
//
// D[i][j] = #{SNPs s in the window : (c_si == 3 && c_sj == -3) ||
//                                     (c_si == -3 && c_sj == 3)}
// (reference statistics/css/css.c:277-327).  The missing code -10000
// and heterozygotes 0 never count; the diagonal is 0.
//
// One block per window:
//   1. pack: for up to 8 words of 32 SNPs at a time (as many as the
//      window needs), one warp per (word, individual) reads 32 codes and
//      ballots them into a hom-major and a hom-minor bit set (bits past
//      the window are 0);
//   2. count: threads own pairs i < j and add
//      popc(maj_i & mnr_j) + popc(mnr_i & maj_j) over the words into an
//      int32 count in shared memory;
//   3. write both triangles and a zero diagonal in the compute dtype
//      (exact: counts are at most 2501 at wsize 2500).
//
// What bounds it on H100: latency and the strided reads of the codes.  A
// window of n SNPs reads n*m int16 codes (about 2 KB at n=50, m=21), as
// 32-lane ballots whose rows are m*2 bytes apart; L1 serves the m
// individuals' passes over the same rows.  The count is m(m-1)/2 pairs x
// ceil(n/32) words of popcounts: small.  Windows overlap wsize/wstep-fold,
// so each code is read about 5 times, from L2.
#include "fet_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWords = 8;   // 32-SNP words packed per pass

template <typename T>
__global__ void __launch_bounds__(kThreads)
css_dissim(const int16_t* __restrict__ vals, const int64_t* __restrict__ lo_arr,
           const int64_t* __restrict__ npos_arr, int64_t nwin, int m,
           T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int mm = m * m;
    int* cnt = reinterpret_cast<int*>(smem_raw);                    // [m*m]
    uint32_t* maj = reinterpret_cast<uint32_t*>(cnt + mm);          // [m][kWords]
    uint32_t* mnr = maj + m * kWords;                               // [m][kWords]

    const int64_t w = blockIdx.x;
    const int64_t lo = lo_arr[w];
    const int n = static_cast<int>(npos_arr[w]);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;

    for (int p = threadIdx.x; p < mm; p += blockDim.x) cnt[p] = 0;
    for (int s0 = 0; s0 < n; s0 += 32 * kWords) {
        const int words = min(kWords, (n - s0 + 31) / 32);
        __syncthreads();   // the previous pass has read maj / mnr
        for (int task = warp; task < words * m; task += nwarps) {
            const int wd = task / m;
            const int i = task - wd * m;
            const int s = s0 + wd * 32 + lane;
            const int16_t v = s < n ? vals[(lo + s) * m + i] : int16_t(0);
            const uint32_t bmaj = __ballot_sync(0xffffffffu, v == 3);
            const uint32_t bmnr = __ballot_sync(0xffffffffu, v == -3);
            if (lane == 0) {
                maj[i * kWords + wd] = bmaj;
                mnr[i * kWords + wd] = bmnr;
            }
        }
        __syncthreads();
        for (int p = threadIdx.x; p < mm; p += blockDim.x) {
            const int i = p / m;
            const int j = p - i * m;
            if (j <= i) continue;
            int acc = 0;
            for (int k = 0; k < words; ++k) {
                acc += __popc(maj[i * kWords + k] & mnr[j * kWords + k]) +
                       __popc(mnr[i * kWords + k] & maj[j * kWords + k]);
            }
            cnt[p] += acc;
        }
    }
    __syncthreads();
    T* o = out + w * mm;
    for (int p = threadIdx.x; p < mm; p += blockDim.x) {
        const int i = p / m;
        const int j = p - i * m;
        const int c = i < j ? cnt[p] : (i > j ? cnt[j * m + i] : 0);
        o[p] = static_cast<T>(c);
    }
}

template <typename T>
int launch_dissim(const int16_t* vals, const int64_t* lo, const int64_t* npos,
                  int64_t nwin, int m, T* out, void* stream) {
    if (nwin == 0) return 0;
    const size_t smem = static_cast<size_t>(m) * m * sizeof(int) +
                        2 * static_cast<size_t>(m) * kWords * sizeof(uint32_t);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            css_dissim<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    css_dissim<T><<<static_cast<unsigned>(nwin), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(vals, lo, npos, nwin,
                                                         m, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

FET_EXPORT int css_dissim_f64(const int16_t* vals, const int64_t* lo,
                              const int64_t* npos, int64_t nwin, int m,
                              double* out, void* stream) {
    return launch_dissim<double>(vals, lo, npos, nwin, m, out, stream);
}

FET_EXPORT int css_dissim_f32(const int16_t* vals, const int64_t* lo,
                              const int64_t* npos, int64_t nwin, int m,
                              float* out, void* stream) {
    return launch_dissim<float>(vals, lo, npos, nwin, m, out, stream);
}
