// The launches of the products' tile routine (wide_common.cuh) as kernels
// of their own: the tiles of csrc/wide.cu's header, the second pass of a
// split sum, and the entry that picks the tile, the copy mode and the
// split, at the element types of a view (GemmViewT). csrc/wide.cu
// instantiates it at float, csrc/wide_bf16.cu at the bf16 routes' types.
#pragma once
#include <cstdint>

#include <cuda_runtime.h>

#include "wide_common.cuh"

// The kernels stay at global scope, where the profiler's and the ptxas
// log's names match them by their own name (as csrc/wide.cu's did).
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
template <int BN, int MODE, class V>
__global__ void __launch_bounds__(WG_THREADS, WideCfg<BN>::MINB)
wide_gemm_kernel(GemmArgsT<V> g, int nsplit, int kbs, float* part) {
  using Cfg = typename WideCfg<BN>::T;
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.z / nsplit, s = blockIdx.z % nsplit;
  const long long mn = (long long)g.v.M * g.v.N;
  const int kb0 = s * kbs, kb1 = min(gemm_kblocks(g.v.K), kb0 + kbs);
  if constexpr (gemm_float_slices<V>)
    gemm_tile<Cfg, MODE>(g.lane(p), blockIdx.y * Cfg::BM, blockIdx.x * Cfg::BN,
                         kb0, kb1, part ? part + p * mn : nullptr, g.P * mn,
                         smem, threadIdx.x, 0);
  else
    gemm_tile_any<Cfg>(MODE, g.lane(p), blockIdx.y * Cfg::BM,
                       blockIdx.x * Cfg::BN, kb0, kb1,
                       part ? part + p * mn : nullptr, g.P * mn, smem,
                       threadIdx.x, 0);
}

// The second pass of a split sum: element e = (p, i, j) adds its nblk
// block sums part[kb * P*M*N + e] in block order from +0.0f, then the
// epilogue.
template <class V>
__global__ void __launch_bounds__(WG_THREADS)
wide_gemm_reduce(GemmArgsT<V> g, int nblk, const float* part) {
  const long long mn = (long long)g.v.M * g.v.N, all = g.P * mn;
  const long long e = (long long)blockIdx.x * WG_THREADS + threadIdx.x;
  if (e >= all) return;
  const int p = (int)(e / mn), i = (int)(e % mn / g.v.N), j = (int)(e % g.v.N);
  float tot = 0.f;
  for (int kb = 0; kb < nblk; ++kb) tot += __ldcg(part + kb * all + e);
  gemm_store(g.lane(p), i, j, tot);
}

template <int BN, int MODE, class V>
static int launch_tiles(const GemmArgsT<V>& g, int nsplit, int kbs, float* part,
                        cudaStream_t stream) {
  using Cfg = typename WideCfg<BN>::T;
  const size_t smem = gemm_smem_bytes<Cfg, V>();
  static bool sized = false;  // the attribute, once per instance
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        wide_gemm_kernel<BN, MODE, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  dim3 grid((g.v.N + Cfg::BN - 1) / Cfg::BN, (g.v.M + Cfg::BM - 1) / Cfg::BM,
            g.P * nsplit);
  wide_gemm_kernel<BN, MODE, V><<<grid, WG_THREADS, smem, stream>>>(g, nsplit, kbs,
                                                                 part);
  return (int)cudaGetLastError();
}

template <int BN, class V>
static int launch_mode(int mode, const GemmArgsT<V>& g, int nsplit, int kbs,
                       float* part, cudaStream_t stream) {
  if constexpr (!gemm_float_slices<V>) {
    return launch_tiles<BN, GEMM_ANY>(g, nsplit, kbs, part, stream);
  } else {
    switch (mode) {
      case GEMM_AK: return launch_tiles<BN, GEMM_AK>(g, nsplit, kbs, part, stream);
      case GEMM_AR: return launch_tiles<BN, GEMM_AR>(g, nsplit, kbs, part, stream);
      default: return launch_tiles<BN, GEMM_ANY>(g, nsplit, kbs, part, stream);
    }
  }
}

// The product at the element types of V: GEMM_PARAMS as wide_gemm_f32
// (csrc/wide.cu) takes them, element strides.
template <class V>
int wide_gemm_entry(GEMM_PARAMS, int bn, int kbs, void* part, void* stream) {
  const int nblk = gemm_kblocks(K);
  const int kr = kbs < 1 || kbs >= nblk ? (nblk > 0 ? nblk : 1) : kbs;
  const int nsplit = nblk > 0 ? (nblk + kr - 1) / kr : 1;
  const int tm = (M + (bn == 128 ? 128 : 64) - 1) / (bn == 128 ? 128 : 64);
  if (P < 1 || (long long)P * nsplit > 65535 || tm > 65535 ||
      (nsplit > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const GemmArgsT<V> g = make_args<V>(GEMM_ARGS);
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
