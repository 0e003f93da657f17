// Float helpers shared by the FET kernels: one name per operation for
// float and double, so the templates below call the same libdevice
// function (powf / pow, ...) that torch's elementwise CUDA kernels call
// for the same dtype.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#define FET_EXPORT extern "C" __attribute__((visibility("default")))

namespace fetk {

// Bytes of dynamic shared memory a block may opt in to on the current
// device (232,448 on Hopper), or 0 where the device cannot be asked.  The
// large-panel kernels' launchers and their *_form queries hold their
// slabs against it.
inline size_t smem_optin() {
    int dev = 0, bytes = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess) {
        return 0;
    }
    return static_cast<size_t>(bytes);
}

__device__ __forceinline__ float t_exp(float x) { return expf(x); }
__device__ __forceinline__ double t_exp(double x) { return exp(x); }
__device__ __forceinline__ float t_log(float x) { return logf(x); }
__device__ __forceinline__ double t_log(double x) { return log(x); }
__device__ __forceinline__ float t_pow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double t_pow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float t_floor(float x) { return floorf(x); }
__device__ __forceinline__ double t_floor(double x) { return floor(x); }
__device__ __forceinline__ float t_ceil(float x) { return ceilf(x); }
__device__ __forceinline__ double t_ceil(double x) { return ceil(x); }
__device__ __forceinline__ float t_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double t_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float t_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double t_max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float t_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double t_min(double a, double b) { return fmin(a, b); }

template <typename T>
__device__ __forceinline__ T neg_inf() {
    return -static_cast<T>(INFINITY);
}

// How a warp stages int16 codes in shared memory: 16-byte cp.async copies
// where source and destination are 16-byte aligned, else 2-byte copies.
enum CodeStage : int { kCopy2 = 1, kAsync16 = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem)
                 : "memory");
}

// Copy the first `elems` int16 codes of src to dst, by the 32 lanes of a
// warp; kAsync16 copies whole 16-byte chunks (src readable up to the
// chunk's end) and returns before they land: stage_wait publishes them.
__device__ __forceinline__ void stage_codes(int16_t* dst, const int16_t* src, int elems,
                                            int stage, int lane) {
    if (stage == kAsync16) {
        const int chunks = (elems + 7) / 8;
        for (int c = lane; c < chunks; c += 32) cp_async16(dst + 8 * c, src + 8 * c);
    } else {
        for (int e = lane; e < elems; e += 32) dst[e] = src[e];
    }
}

__device__ __forceinline__ void stage_wait(int stage) {
    if (stage == kAsync16) {
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();
}

// Order-preserving maps of a sort key to an unsigned integer of its
// width, and back (the wide FET body's select, K1r's radix sort): a
// float's bits with the sign bit set when positive and all bits flipped
// when negative; an int32 rank offset by 2^31.
template <typename K>
struct Radix;

template <>
struct Radix<float> {
    using U = uint32_t;
    static __device__ __forceinline__ U to(float x) {
        const U b = __float_as_uint(x);
        return b & 0x80000000u ? ~b : b | 0x80000000u;
    }
    static __device__ __forceinline__ float from(U u) {
        return __uint_as_float(u & 0x80000000u ? u & 0x7fffffffu : ~u);
    }
};

template <>
struct Radix<double> {
    using U = unsigned long long;
    static __device__ __forceinline__ U to(double x) {
        const U b = static_cast<U>(__double_as_longlong(x));
        return b >> 63 ? ~b : b | (1ull << 63);
    }
    static __device__ __forceinline__ double from(U u) {
        return __longlong_as_double(static_cast<long long>(u >> 63 ? u & ~(1ull << 63) : ~u));
    }
};

template <>
struct Radix<int> {
    using U = uint32_t;
    static __device__ __forceinline__ U to(int x) { return static_cast<U>(x) ^ 0x80000000u; }
    static __device__ __forceinline__ int from(U u) { return static_cast<int>(u ^ 0x80000000u); }
};

}  // namespace fetk
