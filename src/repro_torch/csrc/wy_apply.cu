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
// The simple design: grid (column blocks of 32, lanes). Each block walks
// all m rows twice in chunks of 32 rows staged in shared memory: first
// W1 = Y^T C for its columns (each thread keeps up to 16 sums in
// registers), then W = T^T W1 in shared memory, then out = C - Y W. The
// reduction over rows stays inside the block, in row order: no split-K, no
// atomics, so a column's bits do not depend on its block, its lane or the
// launch size. C may be a strided view (lane and row strides), which is
// how the sweep passes its live window without a copy.
#include <cuda_runtime.h>

constexpr int WY_THREADS = 256;
constexpr int WY_BN = 32;                     // columns per block
constexpr int WY_RM = 32;                     // rows per staged chunk
constexpr int WY_NG = WY_THREADS / WY_BN;     // row groups
constexpr int WY_MAX_B = 128;
constexpr int WY_PK = WY_MAX_B / WY_NG;       // rows of W per thread
constexpr int WY_RK = WY_RM / WY_NG;          // output rows per thread per chunk

__device__ inline void load_rows(float* ys, const float* Yp, int i0, int m,
                                 int b) {
  for (int e = threadIdx.x; e < WY_RM * b; e += WY_THREADS) {
    const int i = i0 + e / b;
    ys[e] = i < m ? Yp[(size_t)i * b + e % b] : 0.f;
  }
}

__global__ void __launch_bounds__(WY_THREADS)
wy_apply_kernel(const float* __restrict__ Y, const float* __restrict__ T,
                const float* __restrict__ C, long long c_bs, long long c_ld,
                float* out, int m, int b, int n) {
  extern __shared__ float smem[];
  float* ys = smem;               // WY_RM x b rows of Y
  float* cs = ys + WY_RM * b;     // WY_RM x WY_BN rows of C
  float* ws = cs + WY_RM * WY_BN; // b x WY_BN: W1, then W
  const int p = blockIdx.y, col0 = blockIdx.x * WY_BN;
  const int tid = threadIdx.x, c = tid % WY_BN, g = tid / WY_BN;
  const int col = col0 + c;
  const bool ok = col < n;
  const float* Yp = Y + (size_t)p * m * b;
  const float* Tp = T + (size_t)p * b * b;
  const float* Cp = C + p * c_bs;
  float* Op = out + (size_t)p * m * n;

  float acc[WY_PK];
#pragma unroll
  for (int k = 0; k < WY_PK; ++k) acc[k] = 0.f;
  // W1 = Y^T C
  for (int i0 = 0; i0 < m; i0 += WY_RM) {
    load_rows(ys, Yp, i0, m, b);
    for (int e = tid; e < WY_RM * WY_BN; e += WY_THREADS) {
      const int i = i0 + e / WY_BN, cc = col0 + e % WY_BN;
      cs[e] = (i < m && cc < n) ? Cp[(size_t)i * c_ld + cc] : 0.f;
    }
    __syncthreads();
    for (int ii = 0; ii < WY_RM; ++ii) {
      const float cv = cs[ii * WY_BN + c];
#pragma unroll
      for (int k = 0; k < WY_PK; ++k) {
        const int q = g + k * WY_NG;
        if (q < b) acc[k] += ys[ii * b + q] * cv;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < WY_PK; ++k) {
    const int q = g + k * WY_NG;
    if (q < b) ws[q * WY_BN + c] = acc[k];
  }
  __syncthreads();
  // W = T^T W1
#pragma unroll
  for (int k = 0; k < WY_PK; ++k) {
    const int r = g + k * WY_NG;
    if (r < b) {
      float s = 0.f;
      for (int q = 0; q < b; ++q) s += __ldg(Tp + q * b + r) * ws[q * WY_BN + c];
      acc[k] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < WY_PK; ++k) {
    const int r = g + k * WY_NG;
    if (r < b) ws[r * WY_BN + c] = acc[k];
  }
  __syncthreads();
  // out = C - Y W
  for (int i0 = 0; i0 < m; i0 += WY_RM) {
    load_rows(ys, Yp, i0, m, b);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WY_RK; ++k) {
      const int ii = g + k * WY_NG, i = i0 + ii;
      float s = 0.f;
      for (int q = 0; q < b; ++q) s += ys[ii * b + q] * ws[q * WY_BN + c];
      if (i < m && ok) Op[(size_t)i * n + col] = Cp[(size_t)i * c_ld + col] - s;
    }
    __syncthreads();
  }
}

// Y: P (m x b), T: P (b x b), contiguous. C: P (m x n) with lane stride
// c_bs and row stride c_ld in floats, unit column stride. out: P (m x n),
// contiguous.
extern "C" int wy_apply_f32(const void* Y, const void* T, const void* C,
                            long long c_bs, long long c_ld, void* out, int P,
                            int m, int b, int n, void* stream) {
  const size_t smem = ((size_t)WY_RM * b + WY_RM * WY_BN + (size_t)b * WY_BN) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wy_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + WY_BN - 1) / WY_BN, P);
  wy_apply_kernel<<<grid, WY_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)Y, (const float*)T, (const float*)C, c_bs, c_ld,
      (float*)out, m, b, n);
  return (int)cudaGetLastError();
}
