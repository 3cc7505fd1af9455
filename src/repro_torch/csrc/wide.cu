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
// What bounds it on the H100: FP32 FFMA throughput (67 TFLOP/s) for the
// deep products (Y^T C over m rows, Y W over b), the memory for the thin
// ones. TF32 tensor cores would break the 3e-4 tolerance, and split-K
// would make a sum's order depend on the launch.
//
// The design, simple first: a block of 256 threads per (lane, BM x BN
// output tile), BM = 64 and BN = 32 or 64 (the caller's column tile,
// backend.tile_bn by default, 128 running as 64); slices of BK = 16 of the reduction staged
// in shared memory, the next slice loaded into registers while the current
// one is multiplied; each thread holds a 4 x BN/16 block of outputs in
// registers and reads its operands as float4. Operands are read through
// general (lane, row, column) strides, so a transposed factor (Y^T, T^T)
// or a column block of a panel is passed as a view, without a copy.
//
// The sums, in three levels: each slice of 16 terms of k is one fmaf
// chain started at 0, 16 slices' chains are added in order into a block
// sum (256 terms), and the block sums in order into the total (zero
// padding past K adds fmaf(0, 0, acc)); then D + total or D - total. One
// sequential chain over a 5632-deep sum (as K2's engine runs at b <= 128)
// lost enough to move the later reflectors of an ill-conditioned Muon
// momentum (cond 6e4) by 0.14 in the blocked K1; the three levels keep the
// error at the plain version's. Neither BN, nor the thread, nor the lane
// count enters a sum, so a lane's bits are those of any launch, at any
// column tile, as the REBUILD replay and the butterfly pair need. No
// atomics, no split-K.
#include <cstdint>

#include <cuda_runtime.h>

constexpr int GEMM_THREADS = 256;
constexpr int GEMM_BM = 64;
constexpr int GEMM_BK = 16;
constexpr int GEMM_AS = GEMM_BM + 4;  // padded row of the A slice
constexpr int GEMM_BLOCK = 16;        // slices of a block sum

struct GemmArgs {
  int M, N, K;
  const float* A;
  long long a_bs, a_rs, a_cs;
  const float* B;
  long long b_bs, b_rs, b_cs;
  const float* D;  // may be null: out = +/- acc
  long long d_bs, d_rs, d_cs;
  float* O;
  long long o_bs, o_rs, o_cs;
  int sub;  // 1: D - acc (or -acc), 0: D + acc (or acc)
  const float* E;  // with O2: also O2 = E - acc; both may be null
  long long e_bs, e_rs, e_cs;
  float* O2;
  long long o2_bs, o2_rs, o2_cs;
};

// Thread (ty, tx) of a 16 x 16 grid owns rows 4 ty .. 4 ty + 3 of the
// tile and columns tx * 4 + 64 h .. + 3 (BN >= 64, h < BN / 64) or
// tx * 2 .. + 1 (BN = 32).
template <int BN>
struct GemmShape {
  static constexpr int TN = BN / 16;  // columns a thread holds
  static constexpr int A_LOADS = GEMM_BM * GEMM_BK / GEMM_THREADS;  // 4
  static constexpr int B_LOADS = BN * GEMM_BK / GEMM_THREADS;       // 2..8
  __device__ static int col(int tx, int c) {
    return BN >= 64 ? (c / 4) * 64 + tx * 4 + c % 4 : tx * 2 + c;
  }
};

template <int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 2) wide_gemm_kernel(GemmArgs g) {
  using S = GemmShape<BN>;
  __shared__ __align__(16) float As[GEMM_BK][GEMM_AS];  // k-major slice of A
  __shared__ __align__(16) float Bs[GEMM_BK][BN];       // k-major slice of B
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int i0 = blockIdx.y * GEMM_BM, j0 = blockIdx.x * BN;
  const long long p = blockIdx.z;
  const float* A = g.A + p * g.a_bs;
  const float* B = g.B + p * g.b_bs;
  // Which element of the slice each of a thread's loads takes: along the
  // operand's unit stride, so that a warp's loads are consecutive.
  const bool a_k_fast = g.a_cs == 1, b_k_fast = g.b_cs != 1 && g.b_rs == 1;
  auto a_elem = [&](int u, int& i, int& k) {
    const int e = tid + u * GEMM_THREADS;
    if (a_k_fast) i = e / GEMM_BK, k = e % GEMM_BK;
    else i = e % GEMM_BM, k = e / GEMM_BM;
  };
  auto b_elem = [&](int u, int& k, int& j) {
    const int e = tid + u * GEMM_THREADS;
    if (b_k_fast) j = e / GEMM_BK, k = e % GEMM_BK;
    else j = e % BN, k = e / BN;
  };
  float ra[S::A_LOADS], rb[S::B_LOADS];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < S::A_LOADS; ++u) {
      int i, k;
      a_elem(u, i, k);
      const int gi = i0 + i, gk = k0 + k;
      ra[u] = gi < g.M && gk < g.K ? A[gi * g.a_rs + gk * g.a_cs] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < S::B_LOADS; ++u) {
      int k, j;
      b_elem(u, k, j);
      const int gk = k0 + k, gj = j0 + j;
      rb[u] = gk < g.K && gj < g.N ? B[gk * g.b_rs + gj * g.b_cs] : 0.f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int u = 0; u < S::A_LOADS; ++u) {
      int i, k;
      a_elem(u, i, k);
      As[k][i] = ra[u];
    }
#pragma unroll
    for (int u = 0; u < S::B_LOADS; ++u) {
      int k, j;
      b_elem(u, k, j);
      Bs[k][j] = rb[u];
    }
  };

  float acc[4][S::TN], blk[4][S::TN], tot[4][S::TN];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < S::TN; ++c) blk[r][c] = tot[r][c] = 0.f;

  load(0);
  stage();
  __syncthreads();
  for (int k0 = 0, slice = 1; k0 < g.K; k0 += GEMM_BK, ++slice) {
    const bool more = k0 + GEMM_BK < g.K;
    if (more) load(k0 + GEMM_BK);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < S::TN; ++c) acc[r][c] = 0.f;
#pragma unroll
    for (int k = 0; k < GEMM_BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[S::TN];
      if constexpr (BN >= 64) {
#pragma unroll
        for (int h = 0; h < S::TN / 4; ++h) {
          const float4 b = *reinterpret_cast<const float4*>(&Bs[k][h * 64 + tx * 4]);
          bv[4 * h] = b.x, bv[4 * h + 1] = b.y, bv[4 * h + 2] = b.z,
          bv[4 * h + 3] = b.w;
        }
      } else {
        const float2 b = *reinterpret_cast<const float2*>(&Bs[k][tx * 2]);
        bv[0] = b.x, bv[1] = b.y;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < S::TN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    const bool block_done = slice % GEMM_BLOCK == 0 || !more;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < S::TN; ++c) {
        blk[r][c] += acc[r][c];
        if (block_done) tot[r][c] += blk[r][c], blk[r][c] = 0.f;
      }
    __syncthreads();  // the slice is read
    if (more) {
      stage();
      __syncthreads();
    }
  }

  const float* D = g.D ? g.D + p * g.d_bs : nullptr;
  float* O = g.O + p * g.o_bs;
  const float* E = g.O2 ? g.E + p * g.e_bs : nullptr;
  float* O2 = g.O2 ? g.O2 + p * g.o2_bs : nullptr;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= g.M) continue;
#pragma unroll
    for (int c = 0; c < S::TN; ++c) {
      const int j = j0 + S::col(tx, c);
      if (j >= g.N) continue;
      const float a = tot[r][c];
      float v;
      if (D) {
        const float d = D[i * g.d_rs + j * g.d_cs];
        v = g.sub ? d - a : d + a;
      } else {
        v = g.sub ? -a : a;
      }
      O[i * g.o_rs + j * g.o_cs] = v;
      if (O2) O2[i * g.o2_rs + j * g.o2_cs] = E[i * g.e_rs + j * g.e_cs] - a;
    }
  }
}

template <int BN>
static int launch(const GemmArgs& g, int P, cudaStream_t stream) {
  dim3 grid((g.N + BN - 1) / BN, (g.M + GEMM_BM - 1) / GEMM_BM, P);
  wide_gemm_kernel<BN><<<grid, GEMM_THREADS, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// out[p](i, j) = D[p](i, j) +/- sum_k A[p](i, k) B[p](k, j) for p < P,
// i < M, j < N, k < K, and, when O2 is not null, also
// out2[p](i, j) = E[p](i, j) - sum_k A[p](i, k) B[p](k, j) from the same
// sum. Each operand is given by its pointer and its (lane, row, column)
// strides in floats; D may be null. sub: 1 subtracts the sum, 0 adds it. bn: the column tile, 32, 64 or 128 (128 runs as 64:
// the three levels of sums hold 96 registers of a thread at 128).
extern "C" int wide_gemm_f32(const void* A, long long a_bs, long long a_rs,
                             long long a_cs, const void* B, long long b_bs,
                             long long b_rs, long long b_cs, const void* D,
                             long long d_bs, long long d_rs, long long d_cs,
                             void* O, long long o_bs, long long o_rs,
                             long long o_cs, const void* E, long long e_bs,
                             long long e_rs, long long e_cs, void* O2,
                             long long o2_bs, long long o2_rs,
                             long long o2_cs, int P, int M, int N, int K,
                             int sub, int bn, void* stream) {
  if (P < 1 || P > 65535 || (M + GEMM_BM - 1) / GEMM_BM > 65535)
    return (int)cudaErrorInvalidValue;
  const GemmArgs g{M, N, K, (const float*)A, a_bs, a_rs, a_cs,
                   (const float*)B, b_bs, b_rs, b_cs, (const float*)D,
                   d_bs, d_rs, d_cs, (float*)O, o_bs, o_rs, o_cs, sub,
                   (const float*)E, e_bs, e_rs, e_cs, (float*)O2, o2_bs,
                   o2_rs, o2_cs};
  const auto s = (cudaStream_t)stream;
  switch (bn) {
    case 32: return launch<32>(g, P, s);
    case 64:
    case 128: return launch<64>(g, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
