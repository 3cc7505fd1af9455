// The element types of the kernels' global tensors, float or bf16, and
// their loads and stores: a bf16 load widens to float exactly, a bf16 store
// rounds to nearest even. Shared by the team bodies (qr_common.cuh) and the
// products' tile routine (wide_common.cuh).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace repro {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

template <class E>
__device__ __forceinline__ E narrow(float x) {
  if constexpr (std::is_same_v<E, float>) return x;
  else return __float2bfloat16_rn(x);
}

// One element through L2 only (data written earlier in the same launch).
__device__ __forceinline__ float ldcg1(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg1(const bf16* p) {
  return __uint_as_float(
      (unsigned)__ldcg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// Four consecutive floats as one aligned 16-byte access through L2 only,
// and their store (the f32 FFMA bodies).
__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void stv4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
// Two floats rounded to bf16, packed low then high.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

}  // namespace repro
