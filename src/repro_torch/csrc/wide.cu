// The products of K1-K4 at panel widths above 128: one batched, strided
// FP32 matrix product with a fixed summation order,
//     out[p](i, j) = D[p](i, j) +/- sum_k A[p](i, k) B[p](k, j),
// the building block of the blocked routes in kernels/wide.py.
//
// Replaces the products inside the TPU kernels that the b <= 128 bodies of
// qr_common.cuh cannot hold at larger b:
//   * src/repro/kernels/panel_qr.py::panel_qr (body panel_qr_math): the
//     Gram product of the T factor, here the join of the sub-panels' T
//     blocks, T12 = -T11 (Y1^T Y2) T22;
//   * src/repro/kernels/wy_apply.py::wy_apply: Z = Y^T C, W = T^T Z,
//     out = C - Y W, with every entry of T read;
//   * src/repro/kernels/stacked_qr.py::stacked_apply: inner = Ct + Y2^T Cb,
//     W and ot = Ct - W from one product (a second store of its epilogue),
//     ob = Cb - Y2 W.
// (K3 at b > 128 is K1's blocked route on the stacked triangles.)
//
// The summation order, the tile routine and what bounds it are in
// wide_common.cuh; the launches are in wide_gemm.cuh, which this file
// instantiates at float (csrc/wide_bf16.cu at the bf16 routes' element
// types) for three tiles, chosen by the caller (kernels/wide.py::gemm_plan,
// from the shape alone):
//   bn = 128: 128 x 128 outputs, 8 x 8 a thread, the total in shared
//             memory (64 KB), one block an SM;
//   bn = 64:  64 x 64, 4 x 4 a thread, everything in registers;
//   bn = 32:  64 x 32, 4 x 2 a thread;
// each at the three copy modes. A product with few tiles and a deep sum
// splits k into ranges of kbs block sums: the tiles store their block sums
// to scratch (part) and wide_gemm_reduce adds them in block order. The
// oracle of the order, wide_gemm_order_f32, runs one thread per element.
#include <cstdint>

#include <cuda_runtime.h>

#include "wide_gemm.cuh"

using namespace repro;

// The oracle: one thread an element, the order of wide_common.cuh as loops.
__global__ void wide_gemm_order(GemmArgs g) {
  const long long mn = (long long)g.v.M * g.v.N;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= g.P * mn) return;
  const int p = (int)(e / mn), i = (int)(e % mn / g.v.N), j = (int)(e % g.v.N);
  const GemmView v = g.lane(p);
  const int slices = (v.K + WG_BK - 1) / WG_BK;
  float tot = 0.f, blk = 0.f;
  for (int s = 0; s < slices; ++s) {
    float acc = 0.f;
    for (int k = s * WG_BK; k < (s + 1) * WG_BK; ++k) {
      const float a = k < v.K ? v.A[i * v.a_rs + k * v.a_cs] : 0.f;
      const float b = k < v.K ? v.B[k * v.b_rs + j * v.b_cs] : 0.f;
      acc = fmaf(a, b, acc);
    }
    blk += acc;
    if ((s + 1) % WG_BLOCK == 0 || s == slices - 1) {
      tot += blk;
      blk = 0.f;
    }
  }
  gemm_store(v, i, j, tot);
}

// out[p](i, j) = D[p](i, j) +/- sum_k A[p](i, k) B[p](k, j) for p < P,
// i < M, j < N, k < K, and, when O2 is not null, also
// out2[p](i, j) = E[p](i, j) - sum_k A[p](i, k) B[p](k, j) from the same
// sum. Each operand is given by its pointer and its (lane, row, column)
// strides in floats; D may be null. sub: 1 subtracts the sum, 0 adds it.
// bn: the tile, 32, 64 or 128 (see the top of the file). kbs: block sums
// of k a block takes; below gemm_kblocks(K) the sum is split, and part
// (gemm_kblocks(K) * P * M * N floats) holds the block sums between the
// two passes. Neither bn nor kbs changes a bit of the result.
extern "C" int wide_gemm_f32(GEMM_PARAMS, int bn, int kbs, void* part,
                             void* stream) {
  return wide_gemm_entry<GemmView>(GEMM_ARGS, bn, kbs, part, stream);
}

// The same function through the oracle of the order (tests only).
extern "C" int wide_gemm_order_f32(GEMM_PARAMS, void* stream) {
  if (P < 1) return (int)cudaErrorInvalidValue;
  const GemmArgs g = make_args(GEMM_ARGS);
  const long long all = (long long)P * M * N;
  if (all == 0) return 0;
  wide_gemm_order<<<(unsigned)((all + 127) / 128), 128, 0,
                    (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}
