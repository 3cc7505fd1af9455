// K2: fused compact-WY application  out = C - Y (T^T (Y^T C)).
//
// Replaces the TPU kernel src/repro/kernels/wy_apply.py::wy_apply (body
// wy_apply_math): the leaf apply of every panel of the FT-CAQR sweep on
// the live window, caqr_apply_qt, and recovery's recover_lane_local.
//
// What bounds it on the H100: about 4 m b n FP32 operations against
// 8 m n bytes of C in and out, i.e. b/2 operations per byte; at b = 128
// that is 64, above the card's FP32 ridge (67 TFLOP/s over 3.35 TB/s, 20
// operations per byte), so FP32 FFMA throughput bounds it. TF32 tensor
// cores would be faster but break the 3e-4 tolerance.
//
// The simple design: grid (column blocks of 32, lanes), one block of 256
// threads per tile running wy_apply_tile (qr_common.cuh, shared with the
// fused K5/K6): each block walks all m rows twice in chunks of 32 rows
// staged in shared memory: first W1 = Y^T C for its columns (each thread
// keeps up to 16 sums in registers), then W = T^T W1 in shared memory, then
// out = C - Y W. The reduction over rows stays inside the block, in row
// order: no split-K, no atomics, so a column's bits do not depend on its
// block, its lane or the launch size. C may be a strided view (lane and row
// strides), which is how the sweep passes its live window without a copy.
#include "qr_common.cuh"

using namespace repro;

__global__ void __launch_bounds__(WY_THREADS)
wy_apply_kernel(const float* __restrict__ Y, const float* __restrict__ T,
                const float* __restrict__ C, long long c_bs, long long c_ld,
                float* out, int m, int b, int n) {
  extern __shared__ float smem[];
  const int p = blockIdx.y;
  wy_apply_tile<true>(Y + (size_t)p * m * b, T + (size_t)p * b * b, C + p * c_bs,
                      c_ld, out + (size_t)p * m * n, n, m, b, n,
                      blockIdx.x * WY_BN, threadIdx.x, smem);
}

// Y: P (m x b), T: P (b x b), contiguous. C: P (m x n) with lane stride
// c_bs and row stride c_ld in floats, unit column stride. out: P (m x n),
// contiguous.
extern "C" int wy_apply_f32(const void* Y, const void* T, const void* C,
                            long long c_bs, long long c_ld, void* out, int P,
                            int m, int b, int n, void* stream) {
  const size_t smem = wy_tile_smem_floats(b) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wy_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + WY_BN - 1) / WY_BN, P);
  wy_apply_kernel<<<grid, WY_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)Y, (const float*)T, (const float*)C, c_bs, c_ld,
      (float*)out, m, b, n);
  return (int)cudaGetLastError();
}
