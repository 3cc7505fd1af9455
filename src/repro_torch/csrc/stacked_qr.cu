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
#include "qr_common.cuh"

using namespace repro;

__global__ void __launch_bounds__(QR_THREADS)
stacked_qr_kernel(const float* __restrict__ Rt, const float* __restrict__ Rb,
                  float* Y2, float* T, float* R, float* work, float* Yw, int b) {
  extern __shared__ float smem[];
  const int p = blockIdx.x, m = 2 * b;
  const size_t bb = (size_t)b * b;
  float* Wp = work + (size_t)p * m * b;
  float* Yp = Yw + (size_t)p * m * b;
  for (int e = threadIdx.x; e < b * b; e += QR_THREADS) {
    const bool up = e / b <= e % b;
    Wp[e] = up ? Rt[p * bb + e] : 0.f;
    Wp[bb + e] = up ? Rb[p * bb + e] : 0.f;
  }
  __syncthreads();
  masked_qr(Wp, Yp, T + p * bb, R + p * bb, m, b, 0, smem);
  for (int e = threadIdx.x; e < b * b; e += QR_THREADS)
    Y2[p * bb + e] = (e / b <= e % b) ? Yp[bb + e] : 0.f;
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

constexpr int SA_THREADS = 256;
constexpr int SA_BN = 32;                      // columns per block
constexpr int SA_NG = SA_THREADS / SA_BN;      // row groups
constexpr int SA_MAX_B = 128;
constexpr int SA_PK = SA_MAX_B / SA_NG;        // rows per thread

__global__ void __launch_bounds__(SA_THREADS)
stacked_apply_kernel(const float* __restrict__ Y2, const float* __restrict__ T,
                     const float* __restrict__ Ct, const float* __restrict__ Cb,
                     float* ot, float* ob, float* W, int b, int n) {
  extern __shared__ float smem[];
  float* cb = smem;             // b x SA_BN block of C_bot
  float* buf = cb + b * SA_BN;  // the inner sum, then W
  const int p = blockIdx.y, col0 = blockIdx.x * SA_BN;
  const int tid = threadIdx.x, c = tid % SA_BN, g = tid / SA_BN;
  const int col = col0 + c;
  const bool ok = col < n;
  const size_t off = (size_t)p * b * n;
  const float* Yp = Y2 + (size_t)p * b * b;
  const float* Tp = T + (size_t)p * b * b;

  for (int e = tid; e < b * SA_BN; e += SA_THREADS) {
    const int q = e / SA_BN, cc = col0 + e % SA_BN;
    cb[e] = cc < n ? Cb[off + (size_t)q * n + cc] : 0.f;
  }
  __syncthreads();

  float acc[SA_PK];
  // inner = C_top + Y2^T C_bot
#pragma unroll
  for (int k = 0; k < SA_PK; ++k) {
    const int r = g + k * SA_NG;
    if (r < b) {
      float s = 0.f;
      for (int q = 0; q < b; ++q) s += __ldg(Yp + q * b + r) * cb[q * SA_BN + c];
      acc[k] = (ok ? Ct[off + (size_t)r * n + col] : 0.f) + s;
    }
  }
#pragma unroll
  for (int k = 0; k < SA_PK; ++k) {
    const int r = g + k * SA_NG;
    if (r < b) buf[r * SA_BN + c] = acc[k];
  }
  __syncthreads();
  // W = T^T inner
#pragma unroll
  for (int k = 0; k < SA_PK; ++k) {
    const int r = g + k * SA_NG;
    if (r < b) {
      float s = 0.f;
      for (int q = 0; q < b; ++q) s += __ldg(Tp + q * b + r) * buf[q * SA_BN + c];
      acc[k] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SA_PK; ++k) {
    const int r = g + k * SA_NG;
    if (r < b) {
      buf[r * SA_BN + c] = acc[k];
      if (ok) {
        const size_t e = off + (size_t)r * n + col;
        W[e] = acc[k];
        ot[e] = Ct[e] - acc[k];
      }
    }
  }
  __syncthreads();
  // C_bot - Y2 W
#pragma unroll
  for (int k = 0; k < SA_PK; ++k) {
    const int r = g + k * SA_NG;
    if (r < b) {
      float s = 0.f;
      for (int q = 0; q < b; ++q) s += __ldg(Yp + r * b + q) * buf[q * SA_BN + c];
      if (ok) ob[off + (size_t)r * n + col] = cb[r * SA_BN + c] - s;
    }
  }
}

// Y2, T: P (b x b); Ct, Cb, ot, ob, W: P (b x n); all contiguous.
extern "C" int stacked_apply_f32(const void* Y2, const void* T, const void* Ct,
                                 const void* Cb, void* ot, void* ob, void* W,
                                 int P, int b, int n, void* stream) {
  const size_t smem = 2 * (size_t)b * SA_BN * sizeof(float);
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
