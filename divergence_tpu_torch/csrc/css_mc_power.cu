// K9: per-chunk power sums of the permutation null (approx p-values).
//
// Replaces divergence_tpu/kernels/perm.py:_null_power_sums as
// _power_stage_all runs it for approx_significance.  Plain torch version:
// divergence_tpu_torch/kernels/perm.py null_power_sums_plain.
//
// For each window w and each chunk k in [k0, k0 + nk) the output holds
// out[k - k0][q][w] = sum over the chunk's permutations of s^(q+1), q =
// 0, 1, 2, in float64, s the float32 permuted score widened to float64
// (s*s and (s*s)*s as in perm.py:629-635).  Every window takes every
// chunk: there is no early exit.
//
// css_mc_power_shared (kernel power_shared) — the shared stream: tiles of
//   32 windows, one column of M (css_mc_coeff's, all nk chunks side by
//   side) per thread, K7's float32 product (permk::tile_product); each
//   column's three powers are summed over the warp with shuffles, then
//   over the block's warps, and over the chunk's column passes, in shared
//   memory.
// css_mc_power_window (kernel power_window) — the window stream: one warp
//   per window, K8's draws, ranks and float32 score (css_perm_common.cuh),
//   lane i taking columns i, i + 32, ... of each chunk and summing its
//   powers in registers, then a shuffle sum over the warp.
//
// What bounds it on H100: as K7 (float32 FMAs, m^2 per window and
// permutation) for the shared stream and as K8 (instruction issue) for
// the window stream; the float64 power sums add 5 float64 operations per
// (window, permutation).  Memory is small: D is read once per tile or
// window, M once per tile from L2, and 3 doubles per window and chunk are
// written.
#include "css_perm_common.cuh"
#include "fet_common.cuh"
#include "threefry.cuh"

namespace {

using permk::kE;
using permk::kMaxM;
using permk::kTC;
using permk::kTW;

constexpr int kWarps = kTC / 32;
constexpr int kWarpsPerBlock = 4;        // window stream: windows per block
constexpr int kWindowThreads = 32 * kWarpsPerBlock;

__device__ __forceinline__ double warp_sum(double v) {
    for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__global__ void __launch_bounds__(kTC)
power_shared(const float* __restrict__ dist, int64_t B, int m,
                    const float* __restrict__ M, int nk, int chunk,
                    double* __restrict__ out) {
    __shared__ __align__(16) float Ds[kE][kTW];
    __shared__ int64_t s_row[kTW];
    __shared__ double red[kWarps][kTW][3];
    __shared__ double sums[kTW][3];

    const int mm = m * m;
    const int64_t ncols = static_cast<int64_t>(nk) * chunk;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kTW;
    if (tid < kTW) s_row[tid] = base + tid < B ? base + tid : -1;

    for (int kk = 0; kk < nk; ++kk) {
        if (tid < kTW * 3) sums[tid / 3][tid % 3] = 0.0;
        const float* Mk = M + static_cast<int64_t>(kk) * chunk;
        for (int ct = 0; ct < chunk; ct += kTC) {
            const int K = ct + tid;
            const bool in_chunk = K < chunk;
            float acc[kTW];
            permk::tile_product(dist, s_row, mm, Mk, ncols, K, in_chunk, Ds, acc);
#pragma unroll
            for (int w = 0; w < kTW; ++w) {
                const double v = in_chunk ? static_cast<double>(acc[w]) : 0.0;
                const double v2 = __dmul_rn(v, v);
                const double p1 = warp_sum(v);
                const double p2 = warp_sum(v2);
                const double p3 = warp_sum(__dmul_rn(v2, v));
                if (lane == 0) {
                    red[warp][w][0] = p1;
                    red[warp][w][1] = p2;
                    red[warp][w][2] = p3;
                }
            }
            __syncthreads();
            if (tid < kTW * 3) {
                const int w = tid / 3;
                const int q = tid % 3;
                double t = sums[w][q];
                for (int wp = 0; wp < kWarps; ++wp) t = __dadd_rn(t, red[wp][w][q]);
                sums[w][q] = t;
            }
            // red is rewritten by the next pass only after tile_product's barriers
        }
        __syncthreads();
        if (tid < kTW * 3) {
            const int w = tid / 3;
            const int q = tid % 3;
            if (s_row[w] >= 0) out[(static_cast<int64_t>(kk) * 3 + q) * B + s_row[w]] = sums[w][q];
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(kWindowThreads)
power_window(const float* __restrict__ dist, const int64_t* __restrict__ wkeys,
                    int64_t B, int m, int asize, int k0, int nk, int chunk,
                    int bitgen, permk::CoeffConst cc, double* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
    if (w >= B) return;   // warp-uniform; no block-wide barrier follows
    const int mm = m * m;
    float* D = smem + warp * mm;
    for (int i = lane; i < mm; i += 32) D[i] = dist[w * mm + i];
    __syncwarp();
    const uint2 wkey = make_uint2(static_cast<uint32_t>(wkeys[2 * w]),
                                  static_cast<uint32_t>(wkeys[2 * w + 1]));
    uint32_t x[kMaxM];
    int r[kMaxM];
    int ord[kMaxM];
    for (int kk = 0; kk < nk; ++kk) {
        const uint2 ck = tf::fold_in(wkey, static_cast<uint32_t>(k0 + kk));
        double p1 = 0.0, p2 = 0.0, p3 = 0.0;
        for (int K = lane; K < chunk; K += 32) {
            permk::draw(ck, static_cast<uint32_t>(K), m, bitgen, x);
            permk::rank(x, m, r, ord);
            const double v = static_cast<double>(permk::score_f32(D, r, m, asize, cc));
            const double v2 = __dmul_rn(v, v);
            p1 = __dadd_rn(p1, v);
            p2 = __dadd_rn(p2, v2);
            p3 = __dadd_rn(p3, __dmul_rn(v2, v));
        }
        p1 = warp_sum(p1);
        p2 = warp_sum(p2);
        p3 = warp_sum(p3);
        if (lane == 0) {
            out[(static_cast<int64_t>(kk) * 3 + 0) * B + w] = p1;
            out[(static_cast<int64_t>(kk) * 3 + 1) * B + w] = p2;
            out[(static_cast<int64_t>(kk) * 3 + 2) * B + w] = p3;
        }
    }
}

}  // namespace

FET_EXPORT int css_mc_power_shared(const float* dist, int64_t B, int m,
                                   const float* M, int nk, int chunk,
                                   double* out, void* stream) {
    if (m > kMaxM || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0 || nk == 0) return 0;
    const unsigned blocks = static_cast<unsigned>((B + kTW - 1) / kTW);
    power_shared<<<blocks, kTC, 0, static_cast<cudaStream_t>(stream)>>>(
        dist, B, m, M, nk, chunk, out);
    return static_cast<int>(cudaGetLastError());
}

FET_EXPORT int css_mc_power_window(const float* dist, const int64_t* wkeys,
                                   int64_t B, int m, int asize, int k0, int nk,
                                   int chunk, int bitgen, float between, float ca,
                                   float cb, double* out, void* stream) {
    if (m > kMaxM || m < 2 || asize < 1 || asize >= m || chunk <= 0 || bitgen < 0 ||
        bitgen > 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (B == 0 || nk == 0) return 0;
    const unsigned blocks =
        static_cast<unsigned>((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
    const size_t smem = sizeof(float) * kWarpsPerBlock * m * m;
    const cudaError_t attr = cudaFuncSetAttribute(
        power_window, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    power_window<<<blocks, kWindowThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        dist, wkeys, B, m, asize, k0, nk, chunk, bitgen,
        permk::CoeffConst{between, ca, cb}, out);
    return static_cast<int>(cudaGetLastError());
}
