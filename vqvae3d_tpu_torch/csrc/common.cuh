// Shared device helpers of the port's CUDA kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace vq {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an fp32 value to T's precision and back: an elementwise op of the
// reference math in T produces exactly this value (fp32 math, one rounding).
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

}  // namespace vq
