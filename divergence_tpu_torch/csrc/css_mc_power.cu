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
// css_mc_power_shared (kernels power_shared, power_reduce) — the shared
//   stream: M of the nk chunks side by side (css_mc_coeff's, chunk kk in
//   columns [kk*cstride, kk*cstride + chunk)), and the product on K7's
//   register-blocked body (permk::tile_gemm) over a 2-D grid of (window
//   tile, column tile of a chunk), window tiles varying fastest.  Each
//   thread sums its 8 columns' s, s^2, s^3 for each of its 8 windows in
//   float64 (__dmul_rn, __dadd_rn, columns in order), the 16 threads that
//   share a window add theirs by a fixed xor-shuffle tree, and the block
//   writes one partial per (chunk, column tile, power, window);
//   power_reduce adds a chunk's column tiles in order.  No atomics: the
//   sums are the same bits run to run.  (A grid of one block per window
//   tile and chunk, walking the chunk's tiles, would launch 314 blocks for
//   19,997 windows x 2 chunks: 1.2 waves of 2 blocks per SM.)
// css_mc_power_window — the window stream to m = 64: css_mc_window.cu's
//   kernel power_sums on K8's small-panel body (a block a window's chunk,
//   its warps the chunk's words, each lane's draws, ranks and nonzero-term
//   score in registers and lane-interleaved tables), the sums in the same
//   order as the block form below.
// css_mc_power_window_block (kernel power_window_block) — the window
//   stream past kMaxM on the large-panel body of css_perm_block.cuh: a
//   block a (window, chunk) task, its warps the chunk's words (the sort of
//   (draw, index) keys, then each lane's walk over its permutation's
//   nonzero terms: for finite D the plain version's scores); lane i
//   sums its columns' powers in order, the xor tree adds a warp's lanes
//   and thread 0 the warps' sums in warp order.  A window with a
//   non-finite entry gets NaN sums, as the plain score's NaN products give.
// What bounds it on H100: as K7 (float32 FMAs, m^2 per window and
// permutation, in tile_gemm) for the shared stream and as K8 for the
// window stream (the instruction rate; past kMaxM the gathers of the
// terms, css_perm_block.cuh); the float64 power sums add 5
// float64 operations per (window, permutation).  Memory is small: D is read once
// per column tile from L2, M once per window tile, and 3 doubles per
// window, chunk and column tile are written (then read once by
// power_reduce).
#include <algorithm>

#include "css_perm_block.cuh"
#include "css_perm_common.cuh"
#include "fet_common.cuh"
#include "threefry.cuh"

namespace {

using permk::kTC;
using permk::kThreads;
using permk::kTW;
using permk::kWordBits;

constexpr int kReduceThreads = 256;
constexpr int64_t kMaxGridY = 65535;

__device__ __forceinline__ double warp_sum(double v) {
    for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// partial[(g*3 + q)*B + w] for column tile g = kk*tpc + t (tile t of
// chunk kk) = sum over the tile's columns K < chunk of s^(q+1).
__global__ void __launch_bounds__(kThreads, 2)
power_shared(const float* __restrict__ dist, int64_t B, int mm,
             const float* __restrict__ M, int64_t ldm, int64_t g0, int chunk, int cstride,
             int tpc, double* __restrict__ partial) {
    permk::TileSmem& sm = permk::tile_smem();
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kTW;
    const int64_t g = g0 + blockIdx.y;
    const int64_t kk = g / tpc;
    const int t = static_cast<int>(g - kk * tpc);
    const int64_t c0 = kk * cstride + static_cast<int64_t>(t) * kTC;
    permk::load_tile_rows(sm, nullptr, base, B);
    float acc[8][8];
    permk::tile_gemm(dist, mm, M, ldm, c0, (kk + 1) * cstride, sm, acc);

    uint32_t in_chunk = 0;   // bit j: this thread's column j is one of the chunk's
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        if (t * kTC + permk::tile_column(j) < chunk) in_chunk |= 1u << j;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        double p[3] = {0.0, 0.0, 0.0};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if ((in_chunk >> j) & 1u) {
                const double v = static_cast<double>(acc[i][j]);
                const double v2 = __dmul_rn(v, v);
                p[0] = __dadd_rn(p[0], v);
                p[1] = __dadd_rn(p[1], v2);
                p[2] = __dadd_rn(p[2], __dmul_rn(v2, v));
            }
        }
        // the 16 threads of one ty (one half-warp) share these windows
#pragma unroll
        for (int q = 0; q < 3; ++q) {
#pragma unroll
            for (int o = 1; o < 16; o <<= 1) {
                p[q] = __dadd_rn(p[q], __shfl_xor_sync(0xffffffffu, p[q], o));
            }
        }
        const int w = permk::tile_window(i);
        if (threadIdx.x % 16 == 0 && sm.row[w] >= 0) {
#pragma unroll
            for (int q = 0; q < 3; ++q) partial[(g * 3 + q) * B + base + w] = p[q];
        }
    }
}

// out[(kk*3 + q)*B + w] = sum over t = 0 .. tpc-1, in order, of the
// partials of chunk kk's column tiles.
__global__ void __launch_bounds__(kReduceThreads)
power_reduce(const double* __restrict__ partial, int64_t B, int64_t n, int tpc,
             double* __restrict__ out) {
    const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    const int64_t w = idx % B;
    const int64_t kq = idx / B;          // kk*3 + q
    const int64_t kk = kq / 3;
    const int64_t q = kq - kk * 3;
    double s = 0.0;
    for (int t = 0; t < tpc; ++t) s = __dadd_rn(s, partial[((kk * tpc + t) * 3 + q) * B + w]);
    out[idx] = s;
}

// K9's window stream past kMaxM: a block task is a window's chunk; the
// block stages the window, its warps take the chunk's words (word q on
// warp q % warps), lane i summing the powers of its columns in order, the
// xor tree adding a warp's lanes, and thread 0 the warps' sums in warp
// order.  A window with a non-finite D gets NaN sums, as its scores are.
template <int kForm>
__global__ void __launch_bounds__(permb::kMaxWarps * 32, 1)
power_window_block(const float* __restrict__ dist, const int64_t* __restrict__ wkeys,
                   int64_t B, int m, int asize, int k0, int nk, int chunk, int bitgen,
                   permk::CoeffConst cc, unsigned char* gscratch, double* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const permb::Block blk = permb::carve_block<kForm>(smem_raw, gscratch, m, false);
    const permb::Warp w = permb::carve_warp<kForm>(blk, m, false);
    const permb::Rows rw = permb::rows_of<kForm>(m, asize);
    double* warp_sums = reinterpret_cast<double*>(blk.area);   // [nwarps][3]
    const int wpc = (chunk + 31) / 32;
    const int64_t ntasks = B * nk;
    for (int64_t task = blockIdx.x; task < ntasks; task += gridDim.x) {
        const int64_t win = task / nk;
        const int kk = static_cast<int>(task - win * nk);
        const float* D = dist + win * int64_t(m) * m;
        const bool flagged = permb::stage_window<kForm, false>(blk, D, m);
        const float* mat = permb::window_mat<kForm>(blk, D);
        const int ld = permb::window_ld<kForm>(m);
        const uint2 wkey = make_uint2(static_cast<uint32_t>(wkeys[2 * win]),
                                      static_cast<uint32_t>(wkeys[2 * win + 1]));
        const uint2 ck = tf::fold_in(wkey, static_cast<uint32_t>(k0 + kk));
        double p1 = 0.0, p2 = 0.0, p3 = 0.0;
        for (int q = warp; q < wpc && !flagged; q += nwarps) {
            const int K = q * 32 + lane;
            permb::rank_word<kForm, false>(w, rw, ck, q, m, asize, bitgen, lane);
            if (K < chunk) {
                const double v = static_cast<double>(
                    permb::walk_f32<kForm>(w.cols, rw, mat, ld, m, asize, cc, lane));
                const double v2 = __dmul_rn(v, v);
                p1 = __dadd_rn(p1, v);
                p2 = __dadd_rn(p2, v2);
                p3 = __dadd_rn(p3, __dmul_rn(v2, v));
            }
        }
        p1 = warp_sum(p1);
        p2 = warp_sum(p2);
        p3 = warp_sum(p3);
        if (lane == 0) {
            warp_sums[3 * warp + 0] = p1;
            warp_sums[3 * warp + 1] = p2;
            warp_sums[3 * warp + 2] = p3;
        }
        __syncthreads();
        if (threadIdx.x < 3) {
            const int q = threadIdx.x;
            double t = 0.0;
            for (int r = 0; r < nwarps; ++r) t = __dadd_rn(t, warp_sums[3 * r + q]);
            out[(static_cast<int64_t>(kk) * 3 + q) * B + win] =
                flagged ? __longlong_as_double(0x7ff8000000000000LL) : t;
        }
        __syncthreads();   // the next task restages the window and the sums
    }
}

}  // namespace

FET_EXPORT int css_mc_power_shared(const float* dist, int64_t B, int m,
                                   const float* M, int nk, int chunk, int cstride,
                                   double* partial, double* out, void* stream) {
    if (chunk <= 0 || cstride < chunk || cstride % kWordBits != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (B == 0 || nk == 0) return 0;
    const cudaError_t attr = permk::set_tile_smem(power_shared);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int tpc = (cstride + kTC - 1) / kTC;
    const int64_t ldm = static_cast<int64_t>(nk) * cstride;
    const int64_t wtiles = (B + kTW - 1) / kTW;
    const int64_t tiles = static_cast<int64_t>(nk) * tpc;
    for (int64_t g0 = 0; g0 < tiles; g0 += kMaxGridY) {
        const dim3 grid(static_cast<unsigned>(wtiles),
                        static_cast<unsigned>(tiles - g0 < kMaxGridY ? tiles - g0 : kMaxGridY));
        power_shared<<<grid, kThreads, sizeof(permk::TileSmem), st>>>(
            dist, B, m * m, M, ldm, g0, chunk, cstride, tpc, partial);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int64_t n = static_cast<int64_t>(nk) * 3 * B;
    power_reduce<<<static_cast<unsigned>((n + kReduceThreads - 1) / kReduceThreads),
                   kReduceThreads, 0, st>>>(partial, B, n, tpc, out);
    return static_cast<int>(cudaGetLastError());
}

// K9's window stream past kMaxM (any m >= 2): css_mc_power_window's
// arguments to cb, then gscratch (as css_mc_window_block's).
FET_EXPORT int css_mc_power_window_block(const float* dist, const int64_t* wkeys, int64_t B,
                                         int m, int asize, int k0, int nk, int chunk,
                                         int bitgen, float between, float ca, float cb,
                                         void* gscratch, double* out, void* stream) {
    if (m < 2 || m > 65535 || asize < 1 || asize >= m || chunk <= 0 || bitgen < 0 ||
        bitgen > 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (B == 0 || nk == 0) return 0;
    unsigned char* gs = static_cast<unsigned char*>(gscratch);
    decltype(&power_window_block<permb::kShared>) const kernels[3] = {
        power_window_block<permb::kShared>, power_window_block<permb::kSplit>,
        power_window_block<permb::kDevice>};
    permb::Launch L;
    const int rc = permb::plan_launch(kernels, m, false, gs != nullptr, (chunk + 31) / 32, &L);
    if (rc != 0) return rc;
    kernels[L.form - 1]<<<L.grid_for(B * nk), L.threads, L.smem,
                          static_cast<cudaStream_t>(stream)>>>(
        dist, wkeys, B, m, asize, k0, nk, chunk, bitgen, permk::CoeffConst{between, ca, cb},
        gs, out);
    return static_cast<int>(cudaGetLastError());
}
