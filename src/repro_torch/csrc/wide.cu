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
// wide_common.cuh. This file instantiates the routine for three tiles,
// chosen by the caller (kernels/wide.py::gemm_plan, from the shape alone):
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

#include "wide_common.cuh"

using namespace repro;

template <int BN>
struct WideCfg;
template <>
struct WideCfg<128> {
  using T = GemmTile<128, 128, 8, 8, 4, true>;
  static constexpr int MINB = 1;
};
template <>
struct WideCfg<64> {
  using T = GemmTile<64, 64, 4, 4, 4, false>;
  static constexpr int MINB = 2;
};
template <>
struct WideCfg<32> {
  using T = GemmTile<64, 32, 4, 2, 4, false>;
  static constexpr int MINB = 2;
};

// Block z = (lane, k range); kbs block sums a range; part null when the
// sum is not split.
template <int BN, int MODE>
__global__ void __launch_bounds__(WG_THREADS, WideCfg<BN>::MINB)
wide_gemm_kernel(GemmArgs g, int nsplit, int kbs, float* part) {
  using Cfg = typename WideCfg<BN>::T;
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.z / nsplit, s = blockIdx.z % nsplit;
  const long long mn = (long long)g.v.M * g.v.N;
  const int kb0 = s * kbs, kb1 = min(gemm_kblocks(g.v.K), kb0 + kbs);
  gemm_tile<Cfg, MODE>(g.lane(p), blockIdx.y * Cfg::BM, blockIdx.x * Cfg::BN,
                       kb0, kb1, part ? part + p * mn : nullptr, g.P * mn,
                       smem, threadIdx.x, 0);
}

// The second pass of a split sum: element e = (p, i, j) adds its nblk
// block sums part[kb * P*M*N + e] in block order from +0.0f, then the
// epilogue.
__global__ void __launch_bounds__(WG_THREADS)
wide_gemm_reduce(GemmArgs g, int nblk, const float* part) {
  const long long mn = (long long)g.v.M * g.v.N, all = g.P * mn;
  const long long e = (long long)blockIdx.x * WG_THREADS + threadIdx.x;
  if (e >= all) return;
  const int p = (int)(e / mn), i = (int)(e % mn / g.v.N), j = (int)(e % g.v.N);
  float tot = 0.f;
  for (int kb = 0; kb < nblk; ++kb) tot += __ldcg(part + kb * all + e);
  gemm_store(g.lane(p), i, j, tot);
}

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

template <int BN, int MODE>
static int launch_tiles(const GemmArgs& g, int nsplit, int kbs, float* part,
                        cudaStream_t stream) {
  using Cfg = typename WideCfg<BN>::T;
  const size_t smem = Cfg::SMEM * sizeof(float);
  static bool sized = false;  // the attribute, once per instance
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        wide_gemm_kernel<BN, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  dim3 grid((g.v.N + Cfg::BN - 1) / Cfg::BN, (g.v.M + Cfg::BM - 1) / Cfg::BM,
            g.P * nsplit);
  wide_gemm_kernel<BN, MODE><<<grid, WG_THREADS, smem, stream>>>(g, nsplit, kbs,
                                                                 part);
  return (int)cudaGetLastError();
}

template <int BN>
static int launch_mode(int mode, const GemmArgs& g, int nsplit, int kbs,
                       float* part, cudaStream_t stream) {
  switch (mode) {
    case GEMM_AK: return launch_tiles<BN, GEMM_AK>(g, nsplit, kbs, part, stream);
    case GEMM_AR: return launch_tiles<BN, GEMM_AR>(g, nsplit, kbs, part, stream);
    default: return launch_tiles<BN, GEMM_ANY>(g, nsplit, kbs, part, stream);
  }
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
  const int nblk = gemm_kblocks(K);
  const int kr = kbs < 1 || kbs >= nblk ? (nblk > 0 ? nblk : 1) : kbs;
  const int nsplit = nblk > 0 ? (nblk + kr - 1) / kr : 1;
  const int tm = (M + (bn == 128 ? 128 : 64) - 1) / (bn == 128 ? 128 : 64);
  if (P < 1 || (long long)P * nsplit > 65535 || tm > 65535 ||
      (nsplit > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const GemmArgs g = make_args(GEMM_ARGS);
  const bool lane_ok = P == 1 || (a_bs % 4 == 0 && b_bs % 4 == 0);
  const int mode = gemm_mode(g.v, lane_ok);
  float* pt = nsplit > 1 ? (float*)part : nullptr;
  const auto s = (cudaStream_t)stream;
  int err;
  switch (bn) {
    case 32: err = launch_mode<32>(mode, g, nsplit, kr, pt, s); break;
    case 64: err = launch_mode<64>(mode, g, nsplit, kr, pt, s); break;
    case 128: err = launch_mode<128>(mode, g, nsplit, kr, pt, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err || !pt) return err;
  const long long all = (long long)P * M * N;
  wide_gemm_reduce<<<(unsigned)((all + WG_THREADS - 1) / WG_THREADS),
                     WG_THREADS, 0, s>>>(g, nblk, pt);
  return (int)cudaGetLastError();
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
