// The products of K2 and K4 at bf16 above 128 columns: wide_gemm's tile
// routine (wide_common.cuh, launched as in wide_gemm.cuh) with bf16
// operands, and the rounding of a float result to bf16.
//
// Replaces, at bf16, the products inside src/repro/kernels/wy_apply.py::
// wy_apply and src/repro/kernels/stacked_qr.py::stacked_apply, whose tile
// programs accumulate in f32 (preferred_element_type) and store in the
// dtype of C. The routes (kernels/wide.py) chain products whose
// intermediates stay float:
//   K2: Z = Y^T C and W = T^T Z in float, out = C - Y W in bf16;
//   K4: inner = Ct + Y2^T Cb and W = T^T inner in float (with the second
//       store Ct - W in bf16), Cb - Y2 W in bf16 from the float W, and W
//       returned rounded (wide_round_bf16).
// So each operand has its own element type, and only the three
// combinations the routes use are instantiated (GemmBBF, GemmBFF, GemmBFB
// in wide_common.cuh). Every product equals wide_gemm_order_f32 on the
// widened operands, rounded where it stores bf16: the widening is exact
// and the sums run in the order of wide_common.cuh at every tile and
// split of k. A bf16 A or B slice is staged through registers (GEMM_ANY),
// so what bounds it on the H100 is, as at float, FP32 FFMA throughput, with
// the copy's overlap of cp.async lost.
#include <cstdint>

#include <cuda_runtime.h>

#include "wide_gemm.cuh"

using namespace repro;

// wide_gemm_f32's product (strides in elements) at the element types of
// `types` (WB_* of wide_common.cuh): A bf16 and B bf16 into a float out (D
// bf16 or null, no second store); A bf16 times a float B into a float out
// (D null, E bf16 into a bf16 out2, or neither); A bf16 times a float B from
// a bf16 D into a bf16 out (no second store). Any other combination:
// cudaErrorInvalidValue.
extern "C" int wide_gemm_bf16(GEMM_PARAMS, int types, int bn, int kbs,
                              void* part, void* stream) {
  switch (gemm_bf16_kind(types, D, E, O2)) {
    case 1: return wide_gemm_entry<GemmBBF>(GEMM_ARGS, bn, kbs, part, stream);
    case 2: return wide_gemm_entry<GemmBFF>(GEMM_ARGS, bn, kbs, part, stream);
    case 3: return wide_gemm_entry<GemmBFB>(GEMM_ARGS, bn, kbs, part, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

__global__ void wide_round_kernel(const float* __restrict__ src,
                                  bf16* __restrict__ dst, long long n) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x)
    dst[e] = __float2bfloat16_rn(src[e]);
}

// dst[e] = bf16(src[e]) for e < n, rounded to nearest even (K4's W).
extern "C" int wide_round_bf16(const void* src, void* dst, long long n,
                               void* stream) {
  if (n <= 0) return n < 0 ? (int)cudaErrorInvalidValue : 0;
  const long long blocks = (n + 255) / 256;
  wide_round_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                      (cudaStream_t)stream>>>((const float*)src, (bf16*)dst, n);
  return (int)cudaGetLastError();
}
