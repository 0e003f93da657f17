// K8: the per-window-stream permutation Monte-Carlo of CSS significance.
//
// Replaces divergence_tpu/kernels/perm.py: mc_significance with
// stream="window" (_ranks, _scores_from_ranks, _perm_scores and its
// _perm_scores_mlast layout, _fold_chunk, _mix32/_mix_bits), as
// _mc_stage1_all / _mc_stage2_all run it, and in its float64 form
// native/mc_native.cpp:mc_native (perm_backend="native").  Plain torch
// versions: divergence_tpu_torch/kernels/perm.py mc_significance
// (stream="window") and mc_native_plain.  Its draws, ranks and scores are
// css_perm_common.cuh's, which K11 (css_perm_chunk.cu, one fixed chunk per
// window for the sharded step) runs too.
//
// css_mc_window (kernel window_mc) — one warp per window, several windows
// per block:
//   the window's D (m*m float32) is staged once in shared memory (and, in
//   the float64 form, its row totals);
//   the warp walks the window's permutations in order, 32 at a time:
//   lane i takes permutation g = base + i, chunk k = g / chunk, column
//   K = g % chunk, draws its m words from fold_in(wkey, k) (mix or
//   threefry), ranks them by pairwise compares with the index tie-break
//   and scores it (css_perm_common.cuh: score_f32 adds the float32
//   products of perm.py:_scores_from_ranks in the twin's order; score_f64
//   is mc_native's order in float64 against the float32 observed score
//   widened to float64);
//   the hits of the 32 permutations are one ballot, counted in
//   permutation order, so the need-th hit is found exactly; the warp
//   stops there (n = its 1-based index, hits = threshold) or at runs
//   (n = runs).  That is the single-pass loop's result (perm.py:368-380),
//   and each warp stops on its own.
//
// What bounds it on H100: instruction issue, not memory (D is read once
// per window).  Per permutation a lane does m draws (two mix32 or one
// threefry-2x32 each) and m^2 rank compares; the float32 form then tests
// all m^2 coefficients and does a float32 multiply and add for each (the
// useful work: a*b + m - 2 nonzero terms), the float64 form about
// C(min(a,b), 2) + m float64 adds over the rank order.  At m = 21 that is
// some 3,000 instructions per lane and permutation.  The design keeps D in
// shared memory (a broadcast read: every lane reads the same D[j][l] in
// the float32 form), the draws and ranks in thread-local arrays (L1), and
// gives each window its own early exit, so no warp computes past its stop.
#include "css_perm_common.cuh"
#include "fet_common.cuh"
#include "threefry.cuh"

namespace {

using permk::kMaxM;

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;

// Shared memory of one warp: D, then (float64 form) the row totals.
__host__ __device__ constexpr int floats_per_warp(int m) {
    return ((m * m + 1) / 2) * 2 + 2 * m;   // D padded to 8 bytes, m doubles
}

template <bool kF64>
__global__ void __launch_bounds__(kThreads)
window_mc(const float* __restrict__ dist, const float* __restrict__ obs,
              const int64_t* __restrict__ wkeys, int64_t B, int m, int asize,
              int chunk, int runs, int threshold, int bitgen,
              permk::CoeffConst cc, permk::NativeConst nc,
              int* __restrict__ hits_out, int* __restrict__ nsc_out) {
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
    if (w >= B) return;   // warp-uniform; no block-wide barrier follows
    const int mm = m * m;
    float* D = smem + warp * floats_per_warp(m);
    double* rowtot = reinterpret_cast<double*>(D + ((mm + 1) / 2) * 2);
    for (int i = lane; i < mm; i += 32) D[i] = dist[w * mm + i];
    __syncwarp();
    if (kF64) {
        for (int j = lane; j < m; j += 32) rowtot[j] = permk::row_total(D, m, j);
        __syncwarp();
    }
    const float o32 = obs[w];
    const double o64 = static_cast<double>(o32);
    const uint2 wkey = make_uint2(static_cast<uint32_t>(wkeys[2 * w]),
                                  static_cast<uint32_t>(wkeys[2 * w + 1]));

    int hits = 0;
    int n = runs;
    int key_k = -1;
    uint2 ck = wkey;
    uint32_t x[kMaxM];
    int r[kMaxM];
    int ord[kMaxM];
    for (int base = 0; base < runs; base += 32) {
        const int g = base + lane;
        bool hit = false;
        if (g < runs) {
            const int k = g / chunk;
            if (k != key_k) {
                ck = tf::fold_in(wkey, static_cast<uint32_t>(k));
                key_k = k;
            }
            permk::draw(ck, static_cast<uint32_t>(g - k * chunk), m, bitgen, x);
            permk::rank(x, m, r, ord);
            if (kF64) {
                hit = permk::score_f64(D, rowtot, ord, m, asize, nc) >= o64;
            } else {
                hit = permk::score_f32(D, r, m, asize, cc) >= o32;
            }
        }
        uint32_t b = __ballot_sync(0xffffffffu, hit);
        const int c = __popc(b);
        const int need = threshold - hits;
        if (c >= need) {
            for (int q = need; q > 1; --q) b &= b - 1;
            n = base + __ffs(b);   // 1-based index of the need-th hit
            hits = threshold;
            break;
        }
        hits += c;
    }
    if (lane == 0) {
        hits_out[w] = hits;
        nsc_out[w] = n;
    }
}

}  // namespace

FET_EXPORT int css_mc_window(const float* dist, const float* obs,
                             const int64_t* wkeys, int64_t B, int m, int asize,
                             int chunk, int runs, int threshold, int bitgen,
                             int f64, float between, float ca, float cb,
                             double wa, double wb, double inv_ab, int* hits,
                             int* nsc, void* stream) {
    if (m > kMaxM || m < 2 || asize < 1 || asize >= m || chunk <= 0 ||
        threshold <= 0 || bitgen < 0 || bitgen > 1 || (f64 && bitgen != 0)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (B == 0) return 0;
    const unsigned blocks =
        static_cast<unsigned>((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
    const size_t smem = sizeof(float) * kWarpsPerBlock * floats_per_warp(m);
    const permk::CoeffConst cc{between, ca, cb};
    const permk::NativeConst nc{wa, wb, inv_ab};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // above 48 KB (m > 54) dynamic shared memory must be asked for
    const cudaError_t attr = f64
        ? cudaFuncSetAttribute(window_mc<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem))
        : cudaFuncSetAttribute(window_mc<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    if (f64) {
        window_mc<true><<<blocks, kThreads, smem, s>>>(
            dist, obs, wkeys, B, m, asize, chunk, runs, threshold, bitgen, cc, nc,
            hits, nsc);
    } else {
        window_mc<false><<<blocks, kThreads, smem, s>>>(
            dist, obs, wkeys, B, m, asize, chunk, runs, threshold, bitgen, cc, nc,
            hits, nsc);
    }
    return static_cast<int>(cudaGetLastError());
}
