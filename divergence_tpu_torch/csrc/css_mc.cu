// K7: the shared-stream permutation Monte-Carlo of CSS significance.
//
// Replaces divergence_tpu/kernels/perm.py: _shared_coeff,
// _shared_perm_scores and mc_significance (stream="shared"), run there
// inside _mc_stage1_all / _mc_stage2_all.  Plain torch versions:
// divergence_tpu_torch/kernels/perm.py _shared_coeff and mc_significance.
//
// css_mc_coeff — the coefficient matrix M [m*m, ncols] of a range of
// chunks, one thread per permutation column:
//   key_k = fold_in(mc_key, k) (threefry, threefry.cuh);
//   the m draws of column K and their ranks r_j, mix or threefry
//   (css_perm_common.cuh; perm.py:_mix_bits, _ranks);
//   M[j*m + l][col] = (u_j && !u_l ? 1/(ab) : 0) - (r_l == r_j + 1 ? cw(r_j) : 0)
// with u_j = r_j < a and cw = (a+b) w_a on the a-chain, (a+b) w_b on the
// b-chain.  The three float32 constants come from the host, rounded as
// the JAX package rounds them, and the one subtraction is the JAX one, so
// M is bit-equal to _shared_coeff.  Each thread writes one column, so a
// warp writes 32 consecutive floats of a row.
//
// css_mc_shared — the adaptive chunk loop for tiles of 32 windows, over a
// range of chunks whose M css_mc_coeff wrote:
//   for each chunk k (until every window of the tile is done):
//     scores[w][K] = sum_e D[w][e] M[e][K], float32 FMAs in SIMT (no
//       tensor cores, no TF32), one column per thread, D staged in shared
//       memory 64 entries at a time (permk::tile_product, shared with K9);
//     hit = scores >= observed (float32) and offset + K < runs;
//     per window, the in-chunk count of hits in column order (warp
//       ballots) and the column of the need-th hit, need = threshold - hits;
//     the update of perm.py:368-380: reached -> hits = threshold,
//       n = offset + pos + 1, done; else hits += chunk hits,
//       n = offset + counted.
//   Windows that are done stay frozen, so a tile's early exit gives the
//   single-pass loop's results; it replaces the JAX package's two-stage
//   compaction.  The per-window state (hits, n, done) lives in device
//   memory between launches.
//
// What bounds it on H100: float32 FMA throughput.  A chunk costs
// 32 x chunk x m^2 FMAs per tile; each thread issues 32 FMAs per M value
// it loads (from L2: M of one range is at most 64 MB) and per 8
// broadcast float4 reads of D from shared memory.  16 k windows x 200 k
// permutations at m = 21 is 1.4e12 FMAs, ~42 ms at the 67 TFLOP/s
// float32 peak.
#include "css_perm_common.cuh"
#include "fet_common.cuh"
#include "threefry.cuh"

namespace {

using permk::kE;
using permk::kMaxM;
using permk::kTC;
using permk::kTW;

constexpr int kCoeffThreads = 128;
constexpr int kWarps = kTC / 32;

__global__ void __launch_bounds__(kCoeffThreads)
css_mc_coeff(uint2 mc_key, int k0, int nk, int chunk, int m, int asize,
             int bitgen, float between, float ca, float cb,
             float* __restrict__ out) {
    const int64_t ncols = static_cast<int64_t>(nk) * chunk;
    const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (col >= ncols) return;
    const int kc = k0 + static_cast<int>(col / chunk);
    const uint32_t K = static_cast<uint32_t>(col % chunk);
    const uint2 key = tf::fold_in(mc_key, static_cast<uint32_t>(kc));
    uint32_t x[kMaxM];
    int r[kMaxM];
    int ord[kMaxM];
    permk::draw(key, K, m, bitgen, x);
    permk::rank(x, m, r, ord);
    for (int j = 0; j < m; ++j) {
        const bool uj = r[j] < asize;
        const float cw = r[j] < asize - 1 ? ca
                         : (r[j] >= asize && r[j] < m - 1 ? cb : 0.0f);
        for (int l = 0; l < m; ++l) {
            const float bet = uj && !(r[l] < asize) ? between : 0.0f;
            const float chain = r[l] == r[j] + 1 ? cw : 0.0f;
            out[static_cast<int64_t>(j * m + l) * ncols + col] = bet - chain;
        }
    }
}

__global__ void __launch_bounds__(kTC)
css_mc_shared(const float* __restrict__ dist, const float* __restrict__ obs,
              const int64_t* __restrict__ active, int64_t nact, int m,
              const float* __restrict__ M, int k0, int nk, int chunk, int runs,
              int threshold, int* __restrict__ hits_g, int* __restrict__ nsc_g,
              uint8_t* __restrict__ done_g) {
    __shared__ __align__(16) float Ds[kE][kTW];
    __shared__ uint32_t masks[kTW][kWarps];
    __shared__ int64_t s_row[kTW];
    __shared__ float s_obs[kTW];
    __shared__ int s_hits[kTW], s_nsc[kTW], s_done[kTW];
    __shared__ int s_cum[kTW], s_reached[kTW], s_pos[kTW];
    __shared__ int s_all_done;

    const int mm = m * m;
    const int64_t ncols = static_cast<int64_t>(nk) * chunk;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kTW;

    if (tid < kTW) {
        const bool live = base + tid < nact;
        const int64_t row = live ? active[base + tid] : -1;
        s_row[tid] = row;
        s_obs[tid] = live ? obs[row] : 0.0f;
        s_hits[tid] = live ? hits_g[row] : 0;
        s_nsc[tid] = live ? nsc_g[row] : 0;
        s_done[tid] = live ? done_g[row] : 1;
    }
    __syncthreads();

    for (int kk = 0; kk < nk; ++kk) {
        if (tid == 0) {
            int all = 1;
            for (int w = 0; w < kTW; ++w) all &= s_done[w];
            s_all_done = all;
        }
        if (tid < kTW) {
            s_cum[tid] = 0;
            s_reached[tid] = 0;
            s_pos[tid] = 0;
        }
        __syncthreads();
        if (s_all_done) break;
        const int64_t offset = static_cast<int64_t>(k0 + kk) * chunk;
        const float* Mk = M + static_cast<int64_t>(kk) * chunk;

        for (int ct = 0; ct < chunk; ct += kTC) {
            const int K = ct + tid;
            const bool in_chunk = K < chunk;
            const bool counted = in_chunk && offset + K < runs;
            float acc[kTW];
            permk::tile_product(dist, s_row, mm, Mk, ncols, K, in_chunk, Ds, acc);
#pragma unroll
            for (int w = 0; w < kTW; ++w) {
                const uint32_t b = __ballot_sync(0xffffffffu, counted && acc[w] >= s_obs[w]);
                if (lane == 0) masks[w][warp] = b;
            }
            __syncthreads();
            if (tid < kTW && !s_done[tid] && !s_reached[tid]) {
                const int need = threshold - s_hits[tid];
                int cum = s_cum[tid];
                for (int wp = 0; wp < kWarps; ++wp) {
                    uint32_t b = masks[tid][wp];
                    const int c = __popc(b);
                    if (cum + c >= need) {
                        for (int q = need - cum; q > 1; --q) b &= b - 1;
                        s_pos[tid] = ct + wp * 32 + __ffs(b) - 1;
                        s_reached[tid] = 1;
                        break;
                    }
                    cum += c;
                }
                s_cum[tid] = cum;
            }
        }
        __syncthreads();
        if (tid < kTW && !s_done[tid]) {
            if (s_reached[tid]) {
                s_hits[tid] = threshold;
                s_nsc[tid] = static_cast<int>(offset) + s_pos[tid] + 1;
                s_done[tid] = 1;
            } else {
                const int64_t left = static_cast<int64_t>(runs) - offset;
                const int n_counted = static_cast<int>(left < chunk ? left : chunk);
                s_hits[tid] += s_cum[tid];
                s_nsc[tid] = static_cast<int>(offset) + n_counted;
            }
        }
        __syncthreads();
    }
    if (tid < kTW && s_row[tid] >= 0) {
        const int64_t row = s_row[tid];
        hits_g[row] = s_hits[tid];
        nsc_g[row] = s_nsc[tid];
        done_g[row] = static_cast<uint8_t>(s_done[tid]);
    }
}

}  // namespace

FET_EXPORT int css_mc_coeff(uint32_t key0, uint32_t key1, int k0, int nk,
                            int chunk, int m, int asize, int bitgen,
                            float between, float ca, float cb, float* out,
                            void* stream) {
    if (m > kMaxM || bitgen < 0 || bitgen > 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t ncols = static_cast<int64_t>(nk) * chunk;
    if (ncols == 0) return 0;
    const unsigned blocks =
        static_cast<unsigned>((ncols + kCoeffThreads - 1) / kCoeffThreads);
    css_mc_coeff<<<blocks, kCoeffThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        make_uint2(key0, key1), k0, nk, chunk, m, asize, bitgen, between, ca, cb,
        out);
    return static_cast<int>(cudaGetLastError());
}

FET_EXPORT int css_mc_shared(const float* dist, const float* obs,
                             const int64_t* active, int64_t nact, int m,
                             const float* M, int k0, int nk, int chunk,
                             int runs, int threshold, int* hits, int* nsc,
                             uint8_t* done, void* stream) {
    if (nact == 0) return 0;
    const unsigned blocks = static_cast<unsigned>((nact + kTW - 1) / kTW);
    css_mc_shared<<<blocks, kTC, 0, static_cast<cudaStream_t>(stream)>>>(
        dist, obs, active, nact, m, M, k0, nk, chunk, runs, threshold, hits,
        nsc, done);
    return static_cast<int>(cudaGetLastError());
}
