// Shared helpers of the package's CUDA kernels: element conversions and
// the mask fill.  Every kernel widens its inputs to float32 in registers or
// shared memory; bf16 and int8 values convert exactly.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SW_NEG_BIG (-0.9e30f)  // mask fill; matches ops/attention.py NEG_BIG

__device__ __forceinline__ float sw_to_float(float x) { return x; }
__device__ __forceinline__ float sw_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float sw_to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T sw_from_float(float x);
template <>
__device__ __forceinline__ float sw_from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 sw_from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);  // round half to even
}

// Round ``x`` to T's precision and widen it back (a dtype cast in the
// reference algebra, e.g. ``p.astype(v.dtype)`` before ``p @ v``).
template <typename T>
__device__ __forceinline__ float sw_round_to(float x) {
  return sw_to_float(sw_from_float<T>(x));
}

// Shared memory above the 48 KB default needs an explicit opt-in per kernel.
template <typename K>
static inline void sw_allow_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
  }
}
