// Device-side threefry-2x32 — bit-equal to jax.random (and to
// divergence_tpu_torch/rng.py): the keys, fold_in and uniform draws that
// the JAX package's bootstrap stream is built from
// (divergence_tpu/kernels/fet.py:_order_stat_uniforms).
//
//   fold_in(key, d)          = threefry2x32(key, (0, d))
//   uniform(key, (n,))[i]    from (b0, b1) = threefry2x32(key, (0, i)):
//     float32: bits = b0 ^ b1, float = bits >> 9 | 0x3F800000, minus 1
//     float64: bits = b0 << 32 | b1, float = bits >> 12 | 0x3FF0..., minus 1
#pragma once

#include <cstdint>

namespace tf {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

// 20 rounds; rotations {13,15,26,6} / {17,29,16,24}, key injection every
// 4 rounds with the round number (jax/_src/prng.py threefry2x32).
__device__ __forceinline__ uint2 threefry2x32(uint2 key, uint32_t x0,
                                              uint32_t x1) {
    const uint32_t ks0 = key.x, ks1 = key.y;
    const uint32_t ks2 = key.x ^ key.y ^ 0x1BD11BDAu;
#define TF_ROUND(r) \
    x0 += x1;       \
    x1 = rotl(x1, r); \
    x1 ^= x0;
#define TF_GROUP_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_GROUP_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
    x0 += ks0;
    x1 += ks1;
    TF_GROUP_A
    x0 += ks1;
    x1 += ks2 + 1u;
    TF_GROUP_B
    x0 += ks2;
    x1 += ks0 + 2u;
    TF_GROUP_A
    x0 += ks0;
    x1 += ks1 + 3u;
    TF_GROUP_B
    x0 += ks1;
    x1 += ks2 + 4u;
    TF_GROUP_A
    x0 += ks2;
    x1 += ks0 + 5u;
#undef TF_GROUP_B
#undef TF_GROUP_A
#undef TF_ROUND
    return make_uint2(x0, x1);
}

__device__ __forceinline__ uint2 fold_in(uint2 key, uint32_t data) {
    return threefry2x32(key, 0u, data);
}

template <typename T>
__device__ T uniform(uint2 key, uint32_t i);

template <>
__device__ __forceinline__ float uniform<float>(uint2 key, uint32_t i) {
    const uint2 b = threefry2x32(key, 0u, i);
    const uint32_t bits = ((b.x ^ b.y) >> 9) | 0x3F800000u;
    return __uint_as_float(bits) - 1.0f;
}

template <>
__device__ __forceinline__ double uniform<double>(uint2 key, uint32_t i) {
    const uint2 b = threefry2x32(key, 0u, i);
    const uint64_t bits = ((uint64_t)b.x << 32) | (uint64_t)b.y;
    const uint64_t fbits = (bits >> 12) | 0x3FF0000000000000ull;
    return __longlong_as_double((long long)fbits) - 1.0;
}

}  // namespace tf
