// The operand types of fused_embedding.cu's kernels, which are templates
// over T = float (K2/K3) or bf16 (K2-bf16/K3-bf16): conversions to and from
// the f32 the kernels compute in, and the rounding a product applies to an
// f32 operand.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// f32 -> T, rounding to nearest even for bf16.
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// The value a product of the T kernels reads of an f32 operand: itself for
// f32, its bf16 rounding for bf16.
template <typename T>
__device__ __forceinline__ float operand(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

}  // namespace tc
