// K1: the Fisher's exact test score -log10 p of every SNP.
//
// Replaces divergence_tpu/kernels/fet.py: fet_snp_logs_joint ->
// fet_snp_logs, with count_tables, _shift_min_first, _support_logp,
// fet_two_tailed (exact, f64), fet_two_tailed_neglog10 (fast, f32) and
// _table_grid.  Plain torch version: divergence_tpu_torch/kernels/fet.py
// fet_lut_plain / fet_snp_logs_plain.
//
// Two kernels:
//   fet_lut_build  one thread per entry of the (a+1)^2 (b+1)^2 grid of
//                  possible tables (17,424 at 11+10), in row-major
//                  (f0, f1, f2, f3) order; each runs the support scan in
//                  registers.
//   fet_snp_logs   one thread per SNP counts the homozygous codes of its
//                  int16 row, then reads its table's score from the LUT
//                  through L1 from global memory (__ldg; 139 KB in f64
//                  stays resident in L1/L2, with no per-block fill of
//                  shared memory) or, for panels where the LUT is off,
//                  runs the same scan itself.
//
// What bounds it on H100: memory.  A SNP costs 2(a+b) bytes of codes
// (42 B at 11+10) and 4-8 B of output against a few integer compares per
// byte.  Neighbouring threads take neighbouring rows, so a warp reads one
// contiguous span of 32 rows; every byte is read once.  The LUT build is
// 17k threads of ~12-point scans.
//
// The per-table score (support scan and LUT read) lives in
// fet_table.cuh, shared with K10 (fet_window.cu).
#include "fet_table.cuh"

namespace {

using namespace fetk;

template <typename T>
__global__ void fet_lut_build(const T* __restrict__ lf, int nmax, int asize,
                              int bsize, int maxs, T* __restrict__ out,
                              int grid) {
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= grid) return;
    const int A1 = asize + 1, B1 = bsize + 1;
    const int f3 = g % B1;
    int r = g / B1;
    const int f2 = r % B1;
    r /= B1;
    const int f1 = r % A1;
    const int f0 = r / A1;
    out[g] = neglog10_p(f0, f1, f2, f3, maxs, lf, nmax);
}

template <typename T>
__global__ void fet_snp_logs(const int16_t* __restrict__ vals, int64_t n,
                             int asize, int bsize, const T* __restrict__ lut,
                             const T* __restrict__ lf, int nmax, int maxs,
                             T* __restrict__ out) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int16_t* row = vals + i * (asize + bsize);
    const Table t = count_table(row, asize, row + asize, bsize);
    out[i] = snp_score(t, asize, bsize, lut, lf, nmax, maxs);
}

constexpr int kThreads = 256;

template <typename T>
int launch_lut_build(const T* lf, int nmax, int asize, int bsize, int maxs,
                     T* out, void* stream) {
    const int grid = (asize + 1) * (asize + 1) * (bsize + 1) * (bsize + 1);
    fet_lut_build<T><<<(grid + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        lf, nmax, asize, bsize, maxs, out, grid);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_snp_logs(const int16_t* vals, int64_t n, int asize, int bsize,
                    const T* lut, const T* lf, int nmax, int maxs, T* out,
                    void* stream) {
    if (n == 0) return 0;
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    fet_snp_logs<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        vals, n, asize, bsize, lut, lf, nmax, maxs, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

FET_EXPORT int fet_lut_build_f64(const double* lf, int nmax, int asize,
                                 int bsize, int maxs, double* out,
                                 void* stream) {
    return launch_lut_build<double>(lf, nmax, asize, bsize, maxs, out, stream);
}

FET_EXPORT int fet_lut_build_f32(const float* lf, int nmax, int asize,
                                 int bsize, int maxs, float* out,
                                 void* stream) {
    return launch_lut_build<float>(lf, nmax, asize, bsize, maxs, out, stream);
}

FET_EXPORT int fet_snp_logs_f64(const int16_t* vals, int64_t n, int asize,
                                int bsize, const double* lut, const double* lf,
                                int nmax, int maxs, double* out, void* stream) {
    return launch_snp_logs<double>(vals, n, asize, bsize, lut, lf, nmax, maxs,
                                   out, stream);
}

FET_EXPORT int fet_snp_logs_f32(const int16_t* vals, int64_t n, int asize,
                                int bsize, const float* lut, const float* lf,
                                int nmax, int maxs, float* out, void* stream) {
    return launch_snp_logs<float>(vals, n, asize, bsize, lut, lf, nmax, maxs,
                                  out, stream);
}

FET_EXPORT const char* fet_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
