// K11: one fixed chunk of the permutation null per window, the MC part of
// the sharded divergence step.
//
// Replaces divergence_tpu/kernels/perm.py: permutation_chunk (_perm_scores
// on keys used as given, then the counted / cumsum / argmax epilogue).
// Plain torch version: divergence_tpu_torch/kernels/perm.py
// permutation_chunk_plain.
//
// css_perm_chunk (kernel perm_chunk) — one warp per window,
// several windows per block, the window's D (m*m float32) staged once in
// shared memory.  Lane i takes the permutations K = base + i, base = 0,
// 32, ... < chunk: it draws its m words from the window's key as given
// (no chunk fold), ranks them and scores them (css_perm_common.cuh: draw,
// rank, score_f32, the twin's row-major order, so the scores are bit-equal
// to the plain version's); a hit is score >= float32(obs) with K < limit.
// The hits of 32 permutations are one ballot, counted in permutation
// order: chunk_hits is the whole chunk's count (no early exit), reached =
// chunk_hits >= need, and pos is the 0-based index of the need-th hit, or
// 0 where it is never reached (the all-false argmax of perm.py:420) or
// need <= 0 (the first index meets cum >= need).
//
// What bounds it on H100: instruction issue (D is read once per
// window).  Per permutation a lane does m draws, m^2 rank compares and
// tests m^2 coefficients; at m = 21 some 3,000 instructions.
#include "css_perm_common.cuh"
#include "fet_common.cuh"
#include "threefry.cuh"

namespace {

using permk::kMaxM;

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;

__host__ __device__ constexpr int floats_per_warp(int m) {
    return ((m * m + 3) / 4) * 4;   // D, padded to 16 bytes
}

__global__ void __launch_bounds__(kThreads)
perm_chunk(const float* __restrict__ dist, const float* __restrict__ obs,
           const int* __restrict__ need, const int64_t* __restrict__ keys,
           int64_t B, int m, int asize, int chunk, int limit, int bitgen,
           permk::CoeffConst cc, int* __restrict__ hits_out,
           uint8_t* __restrict__ reached_out, int* __restrict__ pos_out) {
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
    if (w >= B) return;   // warp-uniform; no block-wide barrier follows
    const int mm = m * m;
    float* D = smem + warp * floats_per_warp(m);
    for (int i = lane; i < mm; i += 32) D[i] = dist[w * mm + i];
    __syncwarp();
    const float o32 = obs[w];
    const int nd = need[w];
    const uint2 key = make_uint2(static_cast<uint32_t>(keys[2 * w]),
                                 static_cast<uint32_t>(keys[2 * w + 1]));
    const int counted = min(chunk, limit);

    int hits = 0;
    int pos = 0;
    bool found = nd <= 0;
    uint32_t x[kMaxM];
    int r[kMaxM];
    int ord[kMaxM];
    for (int base = 0; base < chunk; base += 32) {
        const int K = base + lane;
        bool hit = false;
        if (K < counted) {
            permk::draw(key, static_cast<uint32_t>(K), m, bitgen, x);
            permk::rank(x, m, r, ord);
            hit = permk::score_f32(D, r, m, asize, cc) >= o32;
        }
        uint32_t b = __ballot_sync(0xffffffffu, hit);
        const int c = __popc(b);
        if (!found && hits + c >= nd) {
            for (int q = nd - hits; q > 1; --q) b &= b - 1;
            pos = base + __ffs(b) - 1;   // 0-based index of the need-th hit
            found = true;
        }
        hits += c;
    }
    if (lane == 0) {
        hits_out[w] = hits;
        reached_out[w] = hits >= nd;
        pos_out[w] = pos;
    }
}

}  // namespace

FET_EXPORT int css_perm_chunk(const float* dist, const float* obs,
                              const int* need, const int64_t* keys, int64_t B,
                              int m, int asize, int chunk, int limit,
                              int bitgen, float between, float ca, float cb,
                              int* hits, uint8_t* reached, int* pos,
                              void* stream) {
    if (m > kMaxM || m < 2 || asize < 1 || asize >= m || chunk <= 0 ||
        bitgen < 0 || bitgen > 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (B == 0) return 0;
    const unsigned blocks =
        static_cast<unsigned>((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
    const size_t smem = sizeof(float) * kWarpsPerBlock * floats_per_warp(m);
    // above 48 KB (m > 54) dynamic shared memory must be asked for
    const cudaError_t attr = cudaFuncSetAttribute(
        perm_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const permk::CoeffConst cc{between, ca, cb};
    perm_chunk<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        dist, obs, need, keys, B, m, asize, chunk, limit, bitgen, cc, hits,
        reached, pos);
    return static_cast<int>(cudaGetLastError());
}
