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

}  // namespace fetk
