// K1: masked Householder panel QR with compact-WY output, one lane per
// thread block.
//
// Replaces the TPU kernel src/repro/kernels/panel_qr.py::panel_qr (body
// panel_qr_math), the leaf of every panel of the FT-CAQR sweep.
//
// What bounds it on the H100: the column loop. Each of the b columns needs
// a norm, a product w = v^T A and a rank-1 update over the (m x b) tile,
// each after the previous one, so the kernel waits on latency; its
// floating-point work (about 3 m b^2 operations per lane) would take the
// card's FP32 pipes microseconds.
//
// The simple design: one block of 512 threads per lane (the lane axis is
// the grid). The block first copies its (possibly strided) panel into a
// contiguous scratch tile in global memory: at m = 4096, b = 128 a tile is
// 2 MiB, too large for shared memory, but 8 lanes of it stay in the 50 MB
// L2. Shared memory holds the current reflector, the partial sums and, at
// the end, G = Y^T Y and T. No tensor cores: the sums run as IEEE FP32
// FFMA, since TF32 would not meet the 3e-4 tolerance.
#include "qr_common.cuh"

using namespace repro;

__global__ void __launch_bounds__(QR_THREADS)
panel_qr_kernel(const float* __restrict__ A, long long a_bs, long long a_ld,
                const int* __restrict__ rs, float* Y, float* T, float* R,
                float* work, int m, int b) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  panel_qr_lane(A + p * a_bs, a_ld, Y + (size_t)p * m * b,
                T + (size_t)p * b * b, R + (size_t)p * b * b,
                work + (size_t)p * m * b, m, b, rs[p], smem);
}

extern "C" size_t panel_qr_smem_bytes(int m, int b) {
  return qr_smem_floats(m, b) * sizeof(float);
}

// A: P panels (m x b), lane stride a_bs and row stride a_ld in floats,
// unit column stride. rs: P int32 row starts (device). Y, work: P*m*b
// floats; T, R: P*b*b floats.
extern "C" int panel_qr_f32(const void* A, long long a_bs, long long a_ld,
                            const void* rs, void* Y, void* T, void* R,
                            void* work, int P, int m, int b, void* stream) {
  const size_t smem = panel_qr_smem_bytes(m, b);
  cudaError_t err = cudaFuncSetAttribute(
      panel_qr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  panel_qr_kernel<<<P, QR_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)A, a_bs, a_ld, (const int*)rs, (float*)Y, (float*)T,
      (float*)R, (float*)work, m, b);
  return (int)cudaGetLastError();
}
