// K3: QR of two stacked upper triangles [R_top; R_bot] (the FT butterfly
// combine), and K4: the fused trailing combine (paper Algorithm 2 body).
//
// K3 replaces src/repro/kernels/stacked_qr.py::stacked_qr (body
// stacked_qr_math). Bound on the H100: the column loop's latency; the
// work is only about b^3 / 3 FMAs a lane on a (2b x b) stack. The design
// (stacked_qr_lane in qr_common.cuh): one 512-thread block per lane holds
// the stack in shared memory (139 KB at b = 128) and touches only each
// reflector's support (top row j, bottom rows 0..j: LAPACK tpqrt's
// structure), four threads a column, which keep its bottom rows in
// registers during the loop and read the pivot's from shared memory as
// 16-byte accesses; one barrier a column: every column's threads form the
// pivot's norm themselves, so no thread waits for another to publish it.
// G = Y^T Y is formed inside the loop by the threads left of the pivot,
// and T by 32-column blocks. The sums depend on (the inputs, b) alone, so
// both lanes of a butterfly pair, which get identical inputs, get
// identical bits.
//
// K4 replaces src/repro/kernels/stacked_qr.py::stacked_apply (body
// stacked_apply_math):
//     W = T^T (C_top + Y2^T C_bot); C_top - W; C_bot - Y2 W.
// Bound on the H100: 3 b^2 n FP32 operations (the triangles counted once)
// against 5 b n floats moved; at b = 128 the card's FFMA rate and its
// memory rate give about the same least time. The design: grid (column
// tiles of BN, lanes), one 256-thread block per tile running apply_engine
// (qr_common.cuh), which K4 shares with K2 because it is K2's chain with
// Y = Y2 over b rows: Y2, T and C_bot come in slices of 16 to 64 rows
// through a cp.async double buffer, the intermediate and then W stay in
// shared memory, each thread keeps 8 x 8 outputs in registers (at BN =
// 128) fed by float4 reads, and the slices that meet only the zero
// triangle of Y2 or T are skipped (about half the FMAs). Each output element is one sequential fmaf
// chain in index order (the Y2^T C_bot sum first, then C_top added), so
// the bits do not depend on BN, the block or the launch size, and equal
// those of the kernel's first, one-FMA-per-load version.
//
// The per-lane and per-tile bodies (stacked_qr_lane, stacked_apply_tile)
// live in qr_common.cuh, shared with the fused K6.
//
// bf16 (stacked_qr_bf16, stacked_apply_bf16, b <= 128): K3 is the same
// kernel on bf16 tensors, widening its inputs as it loads them and rounding
// each output once, with G^T in a float scratch beside T (the `gram`
// argument), since the float kernel keeps it in T's own lower triangle: the
// float kernel's bits on the widened inputs, rounded. K4 runs K2's bf16
// engine with Y = Y2 (qr_common.cuh, wg_apply_engine: every product on
// wgmma, the order contract of wgmma_bf16.cuh); it reads all of Y2 and T
// (their zero triangles add exact zeros).
#include <cstdint>

#include "qr_common.cuh"

using namespace repro;

template <class E>
__global__ void __launch_bounds__(QR_THREADS)
stacked_qr_kernel(const E* __restrict__ Rt, const E* __restrict__ Rb, E* Y2,
                  E* T, E* R, float* gram, int b) {
  extern __shared__ __align__(16) float smem[];
  const size_t off = (size_t)blockIdx.x * b * b;
  stacked_qr_lane(Rt + off, Rb + off, Y2 + off, T + off, R + off,
                  gram_scratch(T + off, gram + off), b, smem);
}

extern "C" size_t stacked_qr_smem_bytes(int b) {
  return stacked_smem_floats(b) * sizeof(float);
}

template <class E>
static int stacked_qr_entry(const void* Rt, const void* Rb, void* Y2, void* T,
                            void* R, void* gram, int P, int b, void* stream) {
  const size_t smem = stacked_qr_smem_bytes(b);
  cudaError_t err = cudaFuncSetAttribute(
      stacked_qr_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  stacked_qr_kernel<E><<<P, QR_THREADS, smem, (cudaStream_t)stream>>>(
      (const E*)Rt, (const E*)Rb, (E*)Y2, (E*)T, (E*)R, (float*)gram, b);
  return (int)cudaGetLastError();
}

// Rt, Rb: P (b x b) triangles; Y2, T, R: P*b*b elements; all contiguous,
// all float (stacked_qr_f32) or all bf16 (stacked_qr_bf16). gram: P*b*b
// floats of scratch at bf16 (G^T); unused at float (null allowed).
extern "C" int stacked_qr_f32(const void* Rt, const void* Rb, void* Y2,
                              void* T, void* R, void* gram, int P, int b,
                              void* stream) {
  return stacked_qr_entry<float>(Rt, Rb, Y2, T, R, gram, P, b, stream);
}

extern "C" int stacked_qr_bf16(const void* Rt, const void* Rb, void* Y2,
                               void* T, void* R, void* gram, int P, int b,
                               void* stream) {
  return stacked_qr_entry<bf16>(Rt, Rb, Y2, T, R, gram, P, b, stream);
}

template <int BN, bool VEC, class E>
__global__ void __launch_bounds__(TILE_THREADS, 2)
stacked_apply_kernel(const E* __restrict__ Y2, const E* __restrict__ T,
                     const E* __restrict__ Ct, const E* __restrict__ Cb,
                     E* ot, E* ob, E* W, int b, int n) {
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.y;
  const size_t off = (size_t)p * b * n;
  stacked_apply_tile<BN, VEC>(Y2 + (size_t)p * b * b, T + (size_t)p * b * b,
                              Ct + off, Cb + off, n, ot + off, ob + off,
                              W + off, b, n, blockIdx.x * BN, threadIdx.x, 0,
                              smem);
}

template <int BN, bool VEC, class E>
static int launch_apply(const E* Y2, const E* T, const E* Ct, const E* Cb,
                        E* ot, E* ob, E* W, int P, int b, int n,
                        cudaStream_t stream) {
  const int smem = tile_smem_bytes<E>(BN);
  cudaError_t err = cudaFuncSetAttribute(
      stacked_apply_kernel<BN, VEC, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BN - 1) / BN, P);
  stacked_apply_kernel<BN, VEC, E><<<grid, TILE_THREADS, smem, stream>>>(
      Y2, T, Ct, Cb, ot, ob, W, b, n);
  return (int)cudaGetLastError();
}

template <int BN, class E>
static int launch_apply_tile(const E* Y2, const E* T, const E* Ct,
                             const E* Cb, E* ot, E* ob, E* W, int P, int b,
                             int n, bool vec, cudaStream_t stream) {
  return vec ? launch_apply<BN, true>(Y2, T, Ct, Cb, ot, ob, W, P, b, n, stream)
             : launch_apply<BN, false>(Y2, T, Ct, Cb, ot, ob, W, P, b, n, stream);
}

template <class E>
static int stacked_apply_entry(const void* Y2, const void* T, const void* Ct,
                               const void* Cb, void* ot, void* ob, void* W,
                               int P, int b, int n, int bn, void* stream) {
  const bool vec = ((uintptr_t)Y2 | (uintptr_t)T | (uintptr_t)Ct |
                    (uintptr_t)Cb | (uintptr_t)ot | (uintptr_t)ob |
                    (uintptr_t)W) % 16 == 0 &&
                   b % vec_elems<E> == 0 && n % vec_elems<E> == 0;
  const auto y = (const E*)Y2, t = (const E*)T;
  const auto ct = (const E*)Ct, cb = (const E*)Cb;
  const auto o1 = (E*)ot, o2 = (E*)ob, w = (E*)W;
  const auto s = (cudaStream_t)stream;
  switch (bn) {
    case 32: return launch_apply_tile<32>(y, t, ct, cb, o1, o2, w, P, b, n, vec, s);
    case 64: return launch_apply_tile<64>(y, t, ct, cb, o1, o2, w, P, b, n, vec, s);
    case 128: return launch_apply_tile<128>(y, t, ct, cb, o1, o2, w, P, b, n, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Y2, T: P (b x b) upper triangular; Ct, Cb, ot, ob, W: P (b x n); all
// contiguous, all float (stacked_apply_f32) or all bf16
// (stacked_apply_bf16). bn: the column tile, 32, 64 or 128.
extern "C" int stacked_apply_f32(const void* Y2, const void* T, const void* Ct,
                                 const void* Cb, void* ot, void* ob, void* W,
                                 int P, int b, int n, int bn, void* stream) {
  return stacked_apply_entry<float>(Y2, T, Ct, Cb, ot, ob, W, P, b, n, bn,
                                    stream);
}

extern "C" int stacked_apply_bf16(const void* Y2, const void* T, const void* Ct,
                                  const void* Cb, void* ot, void* ob, void* W,
                                  int P, int b, int n, int bn, void* stream) {
  return stacked_apply_entry<bf16>(Y2, T, Ct, Cb, ot, ob, W, P, b, n, bn,
                                   stream);
}
