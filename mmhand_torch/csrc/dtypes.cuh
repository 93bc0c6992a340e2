// The element types of the port's kernels, by the codes their C interfaces
// take (the wrappers' `_DTYPE_CODES`), and their conversions to and from
// f32: to f32 exactly, from f32 rounded to nearest even.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

}  // namespace
