// K2: fused compact-WY application  out = C - Y (T^T (Y^T C)).
//
// Replaces the TPU kernel src/repro/kernels/wy_apply.py::wy_apply (body
// wy_apply_math): the leaf apply of every panel of the FT-CAQR sweep on
// the live window, caqr_apply_qt, and recovery's recover_lane_local.
//
// What bounds it on the H100: 4 m b n + b^2 n FP32 operations against
// 8 m n bytes of C in and out, about b/2 operations per byte; at b = 128
// that is 64, above the card's FP32 ridge (67 TFLOP/s over 3.35 TB/s, 20
// operations per byte), so FP32 FFMA throughput bounds it. TF32 tensor
// cores would be faster but break the 3e-4 tolerance.
//
// The design: grid (column tiles of BN, lanes), one 256-thread block per
// tile running apply_engine (qr_common.cuh, shared with K4 and the fused
// K5/K6). Phase A accumulates W1 = Y^T C (b x BN) in registers, 8 x 8 per
// thread at BN = 128, over slices of 16 to 64 rows of Y and C that a
// cp.async double buffer brings in while the previous slice is multiplied,
// each thread's copy addresses worked out once per tile; phase B
// keeps W1 in shared memory and forms W = T^T W1 from staged slices of T;
// phase C streams 128-row blocks of Y against the resident W and writes
// out = C - Y W. BN (128, 64 or 32) is the caller's choice per launch
// (backend.tile_bn fills the SMs: the tall sweep's window narrows from
// 4096 to 128 columns, and a REBUILD replays one lane).
//
// The bits: each output element is one sequential fmaf chain in index
// order (W1 over the m rows, W over q, Y W over q, then C minus it), which
// neither BN, nor the thread that computes it, nor the lane changes, and
// which the kernel's first, one-FMA-per-load version also followed: the
// reduction over the rows stays whole inside the block (no split-K, no
// atomics), so both give the same bits. C may be a strided view (lane and
// row strides), which is how the sweep passes its live window without a
// copy; 16-byte copies are used when every stride and pointer allows them,
// scalar loads otherwise (two instances of the kernel, chosen per launch).
//
// bf16 (wy_apply_bf16, b <= 128): the same grid on bf16 Y, T, C and out,
// each tile running K2's bf16 engine (qr_common.cuh, wg_apply_engine): the
// three products on wgmma with bf16 operands copied raw by cp.async, f32
// sums, Z and W split into bf16 halves (wgmma_bf16.cuh, whose order
// contract replaces the one above at bf16). With the products on the
// tensor cores it is bound by the bytes of C (read twice, written once).
#include <cstdint>

#include "qr_common.cuh"

using namespace repro;

template <int BN, bool VEC, class E>
__global__ void __launch_bounds__(TILE_THREADS, 2)
wy_apply_kernel(const E* __restrict__ Y, const E* __restrict__ T,
                const E* __restrict__ C, long long c_bs, long long c_ld,
                E* out, int m, int b, int n) {
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.y;
  wy_apply_tile<BN, VEC>(Y + (size_t)p * m * b, T + (size_t)p * b * b,
                         C + p * c_bs, c_ld, out + (size_t)p * m * n, n, m, b,
                         n, blockIdx.x * BN, threadIdx.x, 0, smem);
}

template <int BN, bool VEC, class E>
static int launch(const E* Y, const E* T, const E* C, long long c_bs,
                  long long c_ld, E* out, int P, int m, int b, int n,
                  cudaStream_t stream) {
  const int smem = tile_smem_bytes<E>(BN);
  cudaError_t err = cudaFuncSetAttribute(
      wy_apply_kernel<BN, VEC, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BN - 1) / BN, P);
  wy_apply_kernel<BN, VEC, E><<<grid, TILE_THREADS, smem, stream>>>(
      Y, T, C, c_bs, c_ld, out, m, b, n);
  return (int)cudaGetLastError();
}

template <int BN, class E>
static int launch_tile(const E* Y, const E* T, const E* C, long long c_bs,
                       long long c_ld, E* out, int P, int m, int b, int n,
                       bool vec, cudaStream_t stream) {
  return vec ? launch<BN, true>(Y, T, C, c_bs, c_ld, out, P, m, b, n, stream)
             : launch<BN, false>(Y, T, C, c_bs, c_ld, out, P, m, b, n, stream);
}

template <class E>
static int wy_apply_entry(const void* Y, const void* T, const void* C,
                          long long c_bs, long long c_ld, void* out, int P,
                          int m, int b, int n, int bn, void* stream) {
  constexpr int V = vec_elems<E>;
  const bool vec = ((uintptr_t)Y | (uintptr_t)T | (uintptr_t)C |
                    (uintptr_t)out) % 16 == 0 &&
                   b % V == 0 && n % V == 0 && c_bs % V == 0 && c_ld % V == 0;
  const auto y = (const E*)Y, t = (const E*)T, c = (const E*)C;
  const auto o = (E*)out;
  const auto s = (cudaStream_t)stream;
  switch (bn) {
    case 32: return launch_tile<32>(y, t, c, c_bs, c_ld, o, P, m, b, n, vec, s);
    case 64: return launch_tile<64>(y, t, c, c_bs, c_ld, o, P, m, b, n, vec, s);
    case 128: return launch_tile<128>(y, t, c, c_bs, c_ld, o, P, m, b, n, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Y: P (m x b), T: P (b x b), contiguous. C: P (m x n) with lane stride
// c_bs and row stride c_ld in elements, unit column stride. out: P (m x n),
// contiguous. bn: the column tile, 32, 64 or 128. All float (wy_apply_f32)
// or all bf16 (wy_apply_bf16).
extern "C" int wy_apply_f32(const void* Y, const void* T, const void* C,
                            long long c_bs, long long c_ld, void* out, int P,
                            int m, int b, int n, int bn, void* stream) {
  return wy_apply_entry<float>(Y, T, C, c_bs, c_ld, out, P, m, b, n, bn, stream);
}

extern "C" int wy_apply_bf16(const void* Y, const void* T, const void* C,
                             long long c_bs, long long c_ld, void* out, int P,
                             int m, int b, int n, int bn, void* stream) {
  return wy_apply_entry<bf16>(Y, T, C, c_bs, c_ld, out, P, m, b, n, bn, stream);
}
