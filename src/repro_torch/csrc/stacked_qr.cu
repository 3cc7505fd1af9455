// K3: QR of two stacked upper triangles [R_top; R_bot] (the FT butterfly
// combine), and K4: the fused trailing combine (paper Algorithm 2 body).
//
// K3 replaces src/repro/kernels/stacked_qr.py::stacked_qr (body
// stacked_qr_math). Bound on the H100: the column loop's latency, as in
// K1; the tile is only (2b x b). Simple design: one block per lane builds
// the stack in a scratch tile in global memory (at b = 128 the stack plus
// its reflectors are 256 KB, over the 227 KB of shared memory a block may
// use) and runs the same masked QR device code as K1 with row_start 0, so
// Y = [I; Y2] with Y2 upper triangular comes out of the general loop. Both
// lanes of a butterfly pair get identical inputs and so identical bits.
//
// K4 replaces src/repro/kernels/stacked_qr.py::stacked_apply (body
// stacked_apply_math):
//     W = T^T (C_top + Y2^T C_bot); C_top - W; C_bot - Y2 W.
// Bound on the H100: about 6 b^2 n FP32 operations against 5 b n floats
// moved, so at b = 128 FP32 FFMA throughput. Simple design: grid (column
// blocks of 32, lanes); each block keeps its C_bot block and the
// intermediate in shared memory, reduces over rows in a fixed order
// inside the block (no split across blocks, no atomics), and reads Y2 and
// T through the cache. Every output column depends only on its own input
// column, so the bits do not depend on the block or the launch size.
//
// The per-lane and per-tile bodies (stacked_qr_lane, stacked_apply_tile)
// live in qr_common.cuh, shared with the fused K6.
#include "qr_common.cuh"

using namespace repro;

__global__ void __launch_bounds__(QR_THREADS)
stacked_qr_kernel(const float* __restrict__ Rt, const float* __restrict__ Rb,
                  float* Y2, float* T, float* R, float* work, float* Yw, int b) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  const size_t bb = (size_t)b * b;
  stacked_qr_lane(Rt + p * bb, Rb + p * bb, Y2 + p * bb, T + p * bb, R + p * bb,
                  work + (size_t)p * 2 * b * b, Yw + (size_t)p * 2 * b * b, b,
                  smem);
}

extern "C" size_t stacked_qr_smem_bytes(int b) {
  return qr_smem_floats(2 * b, b) * sizeof(float);
}

// Rt, Rb: P (b x b) triangles. Y2, T, R: P*b*b floats; work, Yw: P*2b*b.
extern "C" int stacked_qr_f32(const void* Rt, const void* Rb, void* Y2,
                              void* T, void* R, void* work, void* Yw, int P,
                              int b, void* stream) {
  const size_t smem = stacked_qr_smem_bytes(b);
  cudaError_t err = cudaFuncSetAttribute(
      stacked_qr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stacked_qr_kernel<<<P, QR_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)Rt, (const float*)Rb, (float*)Y2, (float*)T, (float*)R,
      (float*)work, (float*)Yw, b);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(SA_THREADS)
stacked_apply_kernel(const float* __restrict__ Y2, const float* __restrict__ T,
                     const float* __restrict__ Ct, const float* __restrict__ Cb,
                     float* ot, float* ob, float* W, int b, int n) {
  extern __shared__ float smem[];
  const int p = blockIdx.y;
  const size_t off = (size_t)p * b * n;
  stacked_apply_tile<true>(Y2 + (size_t)p * b * b, T + (size_t)p * b * b,
                           Ct + off, Cb + off, n, ot + off, ob + off, W + off,
                           b, n, blockIdx.x * SA_BN, threadIdx.x, smem);
}

// Y2, T: P (b x b); Ct, Cb, ot, ob, W: P (b x n); all contiguous.
extern "C" int stacked_apply_f32(const void* Y2, const void* T, const void* Ct,
                                 const void* Cb, void* ot, void* ob, void* W,
                                 int P, int b, int n, void* stream) {
  const size_t smem = sa_tile_smem_floats(b) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stacked_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + SA_BN - 1) / SA_BN, P);
  stacked_apply_kernel<<<grid, SA_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)Y2, (const float*)T, (const float*)Ct, (const float*)Cb,
      (float*)ot, (float*)ob, (float*)W, b, n);
  return (int)cudaGetLastError();
}
