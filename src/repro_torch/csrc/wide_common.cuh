// The products of K1-K4 above 128 columns and of K5/K6's wide phases: one
// FP32 matrix product per lane with a fixed summation order,
//     out(i, j) = D(i, j) +/- sum_k A(i, k) B(k, j)   (and E - sum),
// as a tile routine that csrc/wide.cu (wide_gemm) and csrc/fused_sweep.cu
// (the wide phases of the cooperative K5/K6) instantiate.
//
// The order is the contract, not the layout. Every output element is
//   * a 16-term slice of k: one fmaf chain started at +0.0f, k ascending,
//     the terms past K padded as fmaf(0, 0, acc);
//   * 16 slices' chains added in order into a block sum (256 terms);
//   * the block sums added in order into the total, from +0.0f;
//   * then D + tot, D - tot, tot or -tot, and the second store E - tot.
// wide_gemm_order_f32 (csrc/wide.cu) runs it one thread per element, as
// loops: the oracle every instantiation is held to, bit for bit. Neither
// the tile, the thread, the copy path, the lane count nor a split of k at
// block boundaries enters a sum, so every launch of any tile gives a
// lane the same bits, and the fused kernels equal the stepped routes.
//
// What bounds it on the H100: FP32 FFMA throughput (67 TFLOP/s) for the
// deep products (Y^T C over m rows, Y W over b), the memory for the thin
// ones. TF32 tensor cores would break the 3e-4 tolerance.
//
// The design. 256 threads a tile of BM x BN outputs, TM x TN a thread
// (rows TY * 4 apart in groups of 4, columns TX * 4 apart in groups of 4,
// so a warp's fragment reads are 16-byte and conflict-free). Slices of 16
// terms of A and B are staged in a ring of STAGES shared-memory stages
// with cp.async, one barrier a slice: 16-byte copies along the operand's
// unit stride (A k-major when its rows are the unit stride, A row-major
// when k is, B k-major); for any other strides, loads through registers
// into the same stages. Every load of global memory bypasses L1 (cp.async.cg,
// __ldcg), so a cooperative kernel that calls the routine reads what other
// blocks wrote earlier in the same launch. acc and the
// block sum live in registers; the total in registers or, for the 8 x 8
// thread tile, in the block's shared memory, each thread touching its own
// entries once a block sum. A product with few output tiles and a deep k
// splits k at block boundaries: each part stores its block sums to
// scratch, and a second pass adds them in block order from +0.0f (the
// same additions in the same order; no atomics).
//
// Element types: each operand (A, B, D and E, out, out2) has its own, float
// or bf16 (GemmViewT); a bf16 output is rounded once as it is stored. A
// product whose A is bf16 (the mixes GemmBBF, GemmBFF, GemmBFB) runs on
// the tensor cores (wg_gemm_tile below) under wgmma_bf16.cuh's order
// contract; the order above is the f32 products'.
#pragma once
#include <cstdint>

#include <cuda_runtime.h>

#include <type_traits>

#include "async_copy.cuh"
#include "elem.cuh"
#include "wgmma_bf16.cuh"

namespace repro {

constexpr int WG_THREADS = 256;
constexpr int WG_BK = 16;                    // terms of a slice
constexpr int WG_BLOCK = 16;                 // slices of a block sum
constexpr int WG_BLOCK_K = WG_BK * WG_BLOCK; // terms of a block sum

// One lane's product: every operand by its pointer and (row, column)
// strides in elements, each of its own element type (float or bf16; D and
// E share TD). D, E and O2 may be null.
template <class TA_ = float, class TB_ = float, class TD_ = float,
          class TO_ = float, class TO2_ = float>
struct GemmViewT {
  using TA = TA_;
  using TB = TB_;
  using TD = TD_;
  using TO = TO_;
  using TO2 = TO2_;
  int M, N, K;
  const TA* A;
  long long a_rs, a_cs;
  const TB* B;
  long long b_rs, b_cs;
  const TD* D;
  long long d_rs, d_cs;
  TO* O;
  long long o_rs, o_cs;
  int sub;  // 1: D - tot (or -tot), 0: D + tot (or tot)
  const TD* E;
  long long e_rs, e_cs;
  TO2* O2;  // with E: O2 = E - tot
  long long o2_rs, o2_cs;
};
using GemmView = GemmViewT<>;

// The bf16 products of the routes above 128 columns, their intermediates
// float: a bf16 Y^T C (or Ct + Y2^T Cb) into float; T^T Z, bf16 T times a
// float Z, into float (and the second store Ct - W in bf16); C - Y W, bf16
// Y times a float W from a bf16 C, into bf16.
using GemmBBF = GemmViewT<bf16, bf16, bf16, float, bf16>;
using GemmBFF = GemmViewT<bf16, float, bf16, float, bf16>;
using GemmBFB = GemmViewT<bf16, float, bf16, bf16, bf16>;

// The element types of a product as the bf16 entries take them, a bit an
// operand (1: bf16): A, B, D and E, out, out2.
enum : int { WB_A = 1, WB_B = 2, WB_D = 4, WB_O = 8, WB_O2 = 16 };

// Which of GemmBBF (1), GemmBFF (2) and GemmBFB (3) the product of `types`
// is (a null operand's bit ignored), or 0 for a combination no route runs.
inline int gemm_bf16_kind(int types, const void* D, const void* E,
                          const void* O2) {
  const int t = types | (D || E ? 0 : WB_D) | (O2 ? 0 : WB_O2);
  if (t == (WB_A | WB_B | WB_D | WB_O2) && !O2) return 1;
  if (t == (WB_A | WB_D | WB_O2) && !D) return 2;
  if (t == (WB_A | WB_D | WB_O | WB_O2) && !O2) return 3;
  return 0;
}

// Whether a view's A and B slices are float (cp.async can fill them).
template <class V>
inline constexpr bool gemm_float_slices =
    std::is_same_v<typename V::TA, float> && std::is_same_v<typename V::TB, float>;

// The epilogue of one element from its total.
template <class V>
__device__ __forceinline__ void gemm_store(const V& g, int i, int j, float tot) {
  float v;
  if (g.D) {
    const float d = ldcg1(g.D + i * g.d_rs + j * g.d_cs);
    v = g.sub ? d - tot : d + tot;
  } else {
    v = g.sub ? -tot : tot;
  }
  g.O[i * g.o_rs + j * g.o_cs] = narrow<typename V::TO>(v);
  if (g.O2)
    g.O2[i * g.o2_rs + j * g.o2_cs] =
        narrow<typename V::TO2>(ldcg1(g.E + i * g.e_rs + j * g.e_cs) - tot);
}

// Accesses of four elements (16 bytes of float, 8 of bf16; and loads of D
// and E) in the epilogue: every output-shaped operand has unit column
// stride and rows aligned to four elements.
template <class T>
__host__ __device__ inline bool gemm_vec_ok(const T* p, long long rs,
                                            long long cs) {
  return p == nullptr ||
         (cs == 1 && rs % 4 == 0 && (uintptr_t)p % (4 * sizeof(T)) == 0);
}

template <class V>
__host__ __device__ inline bool gemm_vec_out(const V& g) {
  return gemm_vec_ok(g.O, g.o_rs, g.o_cs) && gemm_vec_ok(g.D, g.d_rs, g.d_cs) &&
         gemm_vec_ok(g.O2, g.o2_rs, g.o2_cs) &&
         (g.O2 == nullptr || gemm_vec_ok(g.E, g.e_rs, g.e_cs));
}

// The epilogue of four consecutive elements (i, j..j+3), all inside the
// output, by aligned accesses of four elements: the arithmetic of
// gemm_store.
template <class V>
__device__ __forceinline__ void gemm_store4(const V& g, int i, int j,
                                            const float* tot) {
  float4 v = make_float4(tot[0], tot[1], tot[2], tot[3]);
  if (g.sub) v = make_float4(-v.x, -v.y, -v.z, -v.w);
  if (g.D) {
    const float4 d = ldcg4(g.D + i * g.d_rs + j);
    v = g.sub ? make_float4(d.x - tot[0], d.y - tot[1], d.z - tot[2], d.w - tot[3])
              : make_float4(d.x + tot[0], d.y + tot[1], d.z + tot[2], d.w + tot[3]);
  }
  stv4(g.O + i * g.o_rs + j, v);
  if (g.O2) {
    const float4 e = ldcg4(g.E + i * g.e_rs + j);
    stv4(g.O2 + i * g.o2_rs + j,
         make_float4(e.x - tot[0], e.y - tot[1], e.z - tot[2], e.w - tot[3]));
  }
}

// How the slices of A and B are copied into shared memory.
enum GemmMode : int {
  GEMM_AK = 0,   // A rows unit stride -> k-major slice, 16-byte copies
  GEMM_AR = 1,   // A k unit stride -> row-major slice, 16-byte copies
  GEMM_ANY = 2,  // any strides: 4-byte loads into k-major slices
};

__host__ __device__ inline bool gemm_al16(const void* p) {
  return (uintptr_t)p % 16 == 0;
}

// The copy mode of a product: 16-byte copies where B's columns and one of
// A's axes are the unit stride with 16-byte aligned rows. `lane_ok` says
// the lane strides keep every lane aligned. A bf16 A or B: GEMM_ANY.
template <class V>
__host__ __device__ inline int gemm_mode(const V& g, bool lane_ok) {
  if constexpr (!gemm_float_slices<V>) {
    return GEMM_ANY;
  } else {
    const bool b16 = lane_ok && g.b_cs == 1 && g.b_rs % 4 == 0 && gemm_al16(g.B);
    if (!b16 || !gemm_al16(g.A)) return GEMM_ANY;
    if (g.a_rs == 1 && g.a_cs % 4 == 0) return GEMM_AK;
    if (g.a_cs == 1 && g.a_rs % 4 == 0) return GEMM_AR;
    return GEMM_ANY;
  }
}

template <int BM_, int BN_, int TM_, int TN_, int STAGES_, bool TOT_SMEM_>
struct GemmTile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int STAGES = STAGES_;
  static constexpr bool TOT_SMEM = TOT_SMEM_;
  static constexpr int TY = BM / TM, TX = BN / TN;
  static constexpr int AS = WG_BK + 4;  // row of a row-major A slice
  static constexpr int A_FLOATS = (WG_BK * BM > BM * AS) ? WG_BK * BM : BM * AS;
  static constexpr int STAGE = A_FLOATS + WG_BK * BN;
  // floats of shared memory a tile needs (16-byte aligned)
  static constexpr int SMEM = STAGES * STAGE + (TOT_SMEM ? BM * BN : 0);
  static_assert(TY * TX == WG_THREADS, "256 threads a tile");
  static_assert(TM % 4 == 0 && (TN % 4 == 0 || TN == 2), "fragments");
  // row r (< TM) and column c (< TN) of a thread's fragment in the tile
  __device__ static int row(int ty, int r) { return (r / 4) * TY * 4 + ty * 4 + r % 4; }
  __device__ static int col(int tx, int c) {
    return TN == 2 ? tx * 2 + c : (c / 4) * TX * 4 + tx * 4 + c % 4;
  }
};

// One tile of one lane's product: rows [i0, i0 + BM), columns [j0, j0 +
// BN), the block sums kb0 <= kb < kb1 of k. With part null the tile adds
// them into its total and stores the epilogue; else it stores block sum kb
// of element (i, j) at part[kb * part_bs + i * N + j] for the second pass
// (gemm_reduce). Runs WG_THREADS threads (tid) that synchronise on barrier
// bar_id only; needs Cfg::SMEM floats at smem. Ends with a barrier, after
// which smem may be reused. Inlined, so that it runs in the register budget
// of its caller's region (the wide phases' setmaxnreg, wide_qr.cuh).
template <class Cfg, int MODE, class V>
__device__ __forceinline__ void gemm_tile(const V& g, int i0, int j0,
                                          int kb0, int kb1,
                          float* part, long long part_bs, float* smem, int tid,
                          int bar_id) {
  constexpr int BM = Cfg::BM, BN = Cfg::BN, TM = Cfg::TM, TN = Cfg::TN;
  constexpr int STAGES = Cfg::STAGES;
  const int ty = tid / Cfg::TX, tx = tid % Cfg::TX;
  const int s0 = kb0 * WG_BLOCK;
  const int s_all = (g.K + WG_BK - 1) / WG_BK;  // slices of the whole sum
  const int s1 = min(kb1 * WG_BLOCK, s_all);
  const int ns = s1 > s0 ? s1 - s0 : 0;
  float* tot_s = smem + STAGES * Cfg::STAGE;
  // entry (r, c) of this thread's tile in tot_s
  auto at = [&](int r, int c) { return (r * TN + c) * WG_THREADS + tid; };

  // stage the slice of k starting at k0 into ring stage st
  auto issue = [&](int slice) {
    float* st = smem + (slice % STAGES) * Cfg::STAGE;
    float* sa = st;
    float* sb = st + Cfg::A_FLOATS;
    const int k0 = (s0 + slice) * WG_BK;
    if constexpr (MODE == GEMM_AK) {
      // A: WG_BK rows of BM consecutive i
      for (int u = tid; u < WG_BK * BM / 4; u += WG_THREADS) {
        const int k = u / (BM / 4), i = (u % (BM / 4)) * 4;
        const int gk = k0 + k, gi = i0 + i;
        const int n = gk < g.K ? max(0, min(4, g.M - gi)) : 0;
        cp_async16(sa + k * BM + i, n ? g.A + gk * g.a_cs + gi : g.A, 4 * n);
      }
    } else if constexpr (MODE == GEMM_AR) {
      // A: BM rows of WG_BK consecutive k
      for (int u = tid; u < BM * WG_BK / 4; u += WG_THREADS) {
        const int i = u / (WG_BK / 4), k = (u % (WG_BK / 4)) * 4;
        const int gk = k0 + k, gi = i0 + i;
        const int n = gi < g.M ? max(0, min(4, g.K - gk)) : 0;
        cp_async16(sa + i * Cfg::AS + k, n ? g.A + gi * g.a_rs + gk : g.A, 4 * n);
      }
    } else {
      // A element by element (through registers), along its unit stride
      // where it has one
      const bool i_fast = g.a_rs == 1;
      for (int u = tid; u < WG_BK * BM; u += WG_THREADS) {
        const int k = i_fast ? u / BM : u % WG_BK;
        const int i = i_fast ? u % BM : u / WG_BK;
        const int gk = k0 + k, gi = i0 + i;
        sa[k * BM + i] = gk < g.K && gi < g.M ? ldcg1(g.A + gi * g.a_rs + gk * g.a_cs) : 0.f;
      }
    }
    if constexpr (MODE != GEMM_ANY) {
      for (int u = tid; u < WG_BK * BN / 4; u += WG_THREADS) {
        const int k = u / (BN / 4), j = (u % (BN / 4)) * 4;
        const int gk = k0 + k, gj = j0 + j;
        const int n = gk < g.K ? max(0, min(4, g.N - gj)) : 0;
        cp_async16(sb + k * BN + j, n ? g.B + gk * g.b_rs + gj : g.B, 4 * n);
      }
    } else {
      const bool j_fast = g.b_cs == 1 || g.b_rs != 1;
      for (int u = tid; u < WG_BK * BN; u += WG_THREADS) {
        const int k = j_fast ? u / BN : u % WG_BK;
        const int j = j_fast ? u % BN : u / WG_BK;
        const int gk = k0 + k, gj = j0 + j;
        sb[k * BN + j] = gk < g.K && gj < g.N ? ldcg1(g.B + gk * g.b_rs + gj * g.b_cs) : 0.f;
      }
    }
  };

  constexpr int SR = Cfg::TOT_SMEM ? 1 : TM, SC = Cfg::TOT_SMEM ? 1 : TN;
  float acc[TM][TN], blk[TM][TN], tot[SR][SC];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      blk[r][c] = 0.f;
      if constexpr (Cfg::TOT_SMEM) tot_s[at(r, c)] = 0.f;
      else tot[r][c] = 0.f;
    }

  // the B fragment of slice row k
  auto b_frag = [&](const float* sb, int k, float* bv) {
    if constexpr (TN == 2) {
      const float2 t = *reinterpret_cast<const float2*>(sb + k * BN + tx * 2);
      bv[0] = t.x, bv[1] = t.y;
    } else {
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 t = *reinterpret_cast<const float4*>(
            sb + k * BN + h * Cfg::TX * 4 + tx * 4);
        bv[4 * h] = t.x, bv[4 * h + 1] = t.y, bv[4 * h + 2] = t.z,
        bv[4 * h + 3] = t.w;
      }
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ns) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<STAGES - 2>();
    bar_sync(bar_id, WG_THREADS);  // slice s landed; slice s - 1 is done
    if (s + STAGES - 1 < ns) issue(s + STAGES - 1);
    cp_async_commit();
    const float* sa = smem + (s % STAGES) * Cfg::STAGE;
    const float* sb = sa + Cfg::A_FLOATS;
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
    if constexpr (MODE == GEMM_AR) {
#pragma unroll
      for (int k4 = 0; k4 < WG_BK; k4 += 4) {
        float4 a4[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r)
          a4[r] = *reinterpret_cast<const float4*>(sa + Cfg::row(ty, r) * Cfg::AS + k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float bv[TN];
          b_frag(sb, k4 + kk, bv);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const float a = kk == 0 ? a4[r].x : kk == 1 ? a4[r].y
                          : kk == 2 ? a4[r].z : a4[r].w;
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a, bv[c], acc[r][c]);
          }
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < WG_BK; ++k) {
        float av[TM], bv[TN];
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const float4 t = *reinterpret_cast<const float4*>(
              sa + k * BM + q * Cfg::TY * 4 + ty * 4);
          av[4 * q] = t.x, av[4 * q + 1] = t.y, av[4 * q + 2] = t.z,
          av[4 * q + 3] = t.w;
        }
        b_frag(sb, k, bv);
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
    }
    const int gs = s0 + s;  // the slice's index in the whole sum
    const bool done = (gs + 1) % WG_BLOCK == 0 || gs == s_all - 1;
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) blk[r][c] += acc[r][c];
    if (done) {
      const int kb = gs / WG_BLOCK;
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          if (part) {
            const int i = i0 + Cfg::row(ty, r), j = j0 + Cfg::col(tx, c);
            if (i < g.M && j < g.N)
              part[kb * part_bs + (long long)i * g.N + j] = blk[r][c];
          } else if constexpr (Cfg::TOT_SMEM) {
            tot_s[at(r, c)] += blk[r][c];
          } else {
            tot[r][c] += blk[r][c];
          }
          blk[r][c] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
  if (!part) {
    const bool vec = TN % 4 == 0 && gemm_vec_out(g);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int i = i0 + Cfg::row(ty, r);
      if (i >= g.M) continue;
#pragma unroll
      for (int c4 = 0; c4 < TN; c4 += 4) {
        float t[4];
#pragma unroll
        for (int q = 0; q < 4 && c4 + q < TN; ++q) {
          if constexpr (Cfg::TOT_SMEM) t[q] = tot_s[at(r, c4 + q)];
          else t[q] = tot[r][c4 + q];
        }
        const int j = j0 + Cfg::col(tx, c4);
        if (vec && j + 3 < g.N) {
          gemm_store4(g, i, j, t);
          continue;
        }
#pragma unroll
        for (int q = 0; q < 4 && c4 + q < TN; ++q) {
          const int jq = j0 + Cfg::col(tx, c4 + q);
          if (jq < g.N) gemm_store(g, i, jq, t[q]);
        }
      }
    }
  }
  bar_sync(bar_id, WG_THREADS);
}

// -- the bf16 products on the tensor cores -----------------------------------
//
// A product whose A is bf16 (the mixes GemmBBF, GemmBFF, GemmBFB) runs on
// wgmma (wgmma_bf16.cuh: the layout, the split of an f32 B, the order
// contract, which replaces this file's FFMA order for them). The tile's
// 256 threads are two warpgroups: at BM = 128 each owns 64 rows and the
// BN columns (m64nBNk16), at BM = 64 all 64 rows and half the columns
// (m64n(BN/2)k16). Slices of 32 terms (two steps) of A and B go through a
// ring of three stages: bf16 operands by 16-byte cp.async straight into
// the layout (A MN-major when its rows are the unit stride, as Y^T and T^T
// are, else K-major; B MN-major) where the strides allow, element by
// element otherwise; an f32 B is loaded into registers before the current
// slice's products and split into a hi and a lo tile after them. Each block sum is a chain of wgmma steps into a
// zeroed accumulator, added in order into the total (in registers, or for
// the 128 x 128 tile in shared memory, each thread its own entries).
template <int BM_, int BN_, bool TOT_SMEM_>
struct WgTile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int BK = 32;  // terms of a staged slice
  static constexpr int STAGES = 3;
  static constexpr int NW = BM == 128 ? BN : BN / 2;  // a warpgroup's N
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + 2 * B_BYTES;  // room for a split B
  static constexpr bool TOT_SMEM = TOT_SMEM_;
  // bytes of shared memory a tile needs (16-byte aligned)
  static constexpr int SMEM = STAGES * STAGE + (TOT_SMEM ? BM * BN * 4 : 0);
  static_assert(BM == 128 || BM == 64, "one or two warpgroups of rows");
};

// The wgmma tile of an FFMA tile's shape.
template <class Cfg>
using WgTileOf = WgTile<Cfg::BM, Cfg::BN, Cfg::TOT_SMEM>;

// Bytes of shared memory the tile of Cfg's shape needs for view V.
template <class Cfg, class V>
__host__ __device__ constexpr int gemm_smem_bytes() {
  if constexpr (gemm_float_slices<V>) return Cfg::SMEM * (int)sizeof(float);
  else return WgTileOf<Cfg>::SMEM;
}

// Accesses of eight elements in the bf16 epilogue: every output-shaped
// operand has unit column stride and rows aligned to eight elements.
template <class V>
__host__ __device__ inline bool gemm_vec8_out(const V& g) {
  auto ok = [](const void* p, long long rs, long long cs) {
    return p == nullptr || (cs == 1 && rs % 8 == 0 && (uintptr_t)p % 32 == 0);
  };
  return ok(g.O, g.o_rs, g.o_cs) && ok(g.D, g.d_rs, g.d_cs) &&
         ok(g.O2, g.o2_rs, g.o2_cs) && (g.O2 == nullptr || ok(g.E, g.e_rs, g.e_cs));
}

// Eight consecutive elements through L2 (one 16-byte bf16 access), widened,
// and their stores (one 16-byte bf16 or two 16-byte float accesses).
__device__ __forceinline__ void ld8(const bf16* p, float* v) {
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(w[q] << 16);
    v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}
__device__ __forceinline__ void st8(bf16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                 pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}
__device__ __forceinline__ void st8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// The epilogue of eight consecutive elements (i, j..j+7) of a view whose D
// and E are bf16: gemm_store's arithmetic, by 16-byte accesses where vec
// (gemm_vec8_out, j a multiple of 8) and all eight are inside.
template <class V>
__device__ __forceinline__ void gemm_store8(const V& g, int i, int j,
                                            const float* tot, bool vec) {
  if (!(vec && j + 8 <= g.N)) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (j + q < g.N) gemm_store(g, i, j + q, tot[q]);
    return;
  }
  float v[8];
  if (g.D) {
    ld8(g.D + i * g.d_rs + j, v);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = g.sub ? v[q] - tot[q] : v[q] + tot[q];
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = g.sub ? -tot[q] : tot[q];
  }
  st8(g.O + i * g.o_rs + j, v);
  if (g.O2) {
    ld8(g.E + i * g.e_rs + j, v);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = v[q] - tot[q];
    st8(g.O2 + i * g.o2_rs + j, v);
  }
}

// gemm_tile's contract (tile, block sums kb0 <= kb < kb1, part, barrier
// bar_id, WG_THREADS threads, a barrier at the end) for a view whose A is
// bf16, on wgmma; A_MN: A's rows are its unit stride (an MN-major A).
template <class W, bool A_MN, class V>
__device__ __forceinline__ void wg_gemm_tile(const V& g, int i0, int j0,
                                             int kb0, int kb1, float* part,
                                             long long part_bs, float* smem,
                                             int tid, int bar_id) {
  constexpr bool SPLIT = std::is_same_v<typename V::TB, float>;
  constexpr int BM = W::BM, BN = W::BN, BK = W::BK, NA = W::NW / 2;
  constexpr int SPB = WG_CHAIN / BK;  // slices of a block sum
  char* base = reinterpret_cast<char*>(smem);
  float* tot_s = reinterpret_cast<float*>(base + W::STAGES * W::STAGE);
  const int wg = tid >> 7, t = tid & 127;
  const int mrow = BM == 128 ? wg * 64 : 0, ncol = BM == 128 ? 0 : wg * W::NW;
  const int s0 = kb0 * SPB;
  const int s_all = (g.K + BK - 1) / BK;  // slices of the whole sum
  const int s1 = min(kb1 * SPB, s_all);
  const int ns = s1 > s0 ? s1 - s0 : 0;
  const bool a_vec = gemm_al16(g.A) && (A_MN ? g.a_cs % 8 == 0
                                             : g.a_cs == 1 && g.a_rs % 8 == 0);
  const bool b_vec = gemm_al16(g.B) && g.b_cs == 1 &&
                     g.b_rs % (SPLIT ? 4 : 8) == 0;

  // an f32 B's next slice, loaded into registers before the products of
  // the current one and split into its stage after them
  SplitStage<BK, BN / 8, WG_THREADS> next_b;
  auto issue = [&](int slice) {
    char* sa = base + (slice % W::STAGES) * W::STAGE;
    char* sb = sa + W::A_BYTES;
    const int k0 = (s0 + slice) * BK;
    if constexpr (A_MN)
      wg_stage<BK, BM / 8, true, WG_THREADS>(sa, g.A, g.a_cs, g.a_rs, k0, g.K,
                                             i0, g.M, tid, a_vec);
    else
      wg_stage<BM, BK / 8, false, WG_THREADS>(sa, g.A, g.a_rs, g.a_cs, i0, g.M,
                                              k0, g.K, tid, a_vec);
    if constexpr (SPLIT)
      next_b.load(g.B, g.b_rs, g.b_cs, k0, g.K, j0, g.N, tid, b_vec);
    else
      wg_stage<BK, BN / 8, true, WG_THREADS>(sb, g.B, g.b_rs, g.b_cs, k0, g.K,
                                             j0, g.N, tid, b_vec);
  };
  auto store_b = [&](int slice) {
    if constexpr (SPLIT) {
      char* sb = base + (slice % W::STAGES) * W::STAGE + W::A_BYTES;
      next_b.store(sb, sb + W::B_BYTES, tid);
    }
  };

  float acc[NA], tot[W::TOT_SMEM ? 1 : NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    acc[j] = 0.f;
    if constexpr (W::TOT_SMEM) tot_s[j * WG_THREADS + tid] = 0.f;
    else tot[j] = 0.f;
  }

  for (int s = 0; s < W::STAGES - 1; ++s) {
    if (s < ns) {
      issue(s);
      store_b(s);
    }
    cp_async_commit();
  }
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<W::STAGES - 2>();
    fence_proxy_async();
    bar_sync(bar_id, WG_THREADS);  // slice s landed; slice s - 1 is done
    const bool more = s + W::STAGES - 1 < ns;
    if (more) issue(s + W::STAGES - 1);
    cp_async_commit();
    const char* sa = base + (s % W::STAGES) * W::STAGE;
    const char* sb = sa + W::A_BYTES;
    const int gs = s0 + s;  // the slice's index in the whole sum
    wg_fence();
#pragma unroll
    for (int h = 0; h < BK / WG_STEP; ++h) {
      const int k0 = gs * BK + h * WG_STEP;
      if (k0 < g.K) {
        const uint64_t da = wg_desc(sa, BM, mrow, h * WG_STEP);
        wg_mma<A_MN, 1>(acc, da, wg_desc(sb, BN, ncol, h * WG_STEP),
                        k0 % WG_CHAIN != 0);
        if constexpr (SPLIT)
          wg_mma<A_MN, 1>(acc, da, wg_desc(sb + W::B_BYTES, BN, ncol, h * WG_STEP), 1);
      }
    }
    wg_commit();
    if (more) store_b(s + W::STAGES - 1);
    wg_wait_all();
    wg_fence_acc(acc);
    if ((gs + 1) % SPB == 0 || gs == s_all - 1) {
      const int kb = gs / SPB;
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        if (part) {
          const int i = i0 + mrow + wg_row(j, t), jj = j0 + ncol + wg_col(j, t);
          if (i < g.M && jj < g.N)
            part[kb * part_bs + (long long)i * g.N + jj] = acc[j];
        } else if constexpr (W::TOT_SMEM) {
          tot_s[j * WG_THREADS + tid] += acc[j];
        } else {
          tot[j] += acc[j];
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!part) {
    // the epilogue through shared memory (the ring, free now): each warp
    // writes its 16 rows in pieces of PW columns and reads them back as
    // runs of PW / 2 columns a lane, so D, E, out and out2 move in 16-byte
    // accesses, whole sectors, where the accumulators' layout would touch
    // 8 rows in 4- or 8-byte pieces
    constexpr int PW = W::NW < 32 ? W::NW : 32, RUN = PW / 2;
    bar_sync(bar_id, WG_THREADS);  // both warpgroups done with the ring
    float* scr = reinterpret_cast<float*>(base) + (tid >> 5) * 16 * PW;
    const int lane = tid & 31, r = lane >> 1, cb = (lane & 1) * RUN;
    const int i = i0 + mrow + ((tid >> 5) & 3) * 16 + r;
    const bool vec = gemm_vec8_out(g);
#pragma unroll
    for (int h = 0; h < W::NW / PW; ++h) {
#pragma unroll
      for (int j = h * PW / 2; j < (h + 1) * PW / 2; j += 2) {
        const int rr = wg_row(j, t) & 15, cc = wg_col(j, t) % PW;
        float t0, t1;
        if constexpr (W::TOT_SMEM)
          t0 = tot_s[j * WG_THREADS + tid], t1 = tot_s[(j + 1) * WG_THREADS + tid];
        else
          t0 = tot[j], t1 = tot[j + 1];
        *reinterpret_cast<float2*>(scr + rr * PW + (cc ^ ((rr & 7) << 2) % PW)) =
            make_float2(t0, t1);
      }
      __syncwarp();
      float v[RUN];
#pragma unroll
      for (int q = 0; q < RUN; q += 4) {
        const float4 x = *reinterpret_cast<const float4*>(
            scr + r * PW + ((cb + q) ^ ((r & 7) << 2) % PW));
        v[q] = x.x, v[q + 1] = x.y, v[q + 2] = x.z, v[q + 3] = x.w;
      }
      const int jj = j0 + ncol + h * PW + cb;
      if (i < g.M) {
#pragma unroll
        for (int q = 0; q < RUN; q += 8) gemm_store8(g, i, jj + q, v + q, vec);
      }
      __syncwarp();
    }
  }
  bar_sync(bar_id, WG_THREADS);
}

// The tile routine at a runtime copy mode; a bf16 A: the wgmma tile of
// Cfg's shape, A MN-major when its rows are the unit stride.
template <class Cfg, class V>
__device__ __forceinline__ void gemm_tile_any(int mode, const V& g,
                                              int i0, int j0, int kb0, int kb1,
                                              float* part, long long part_bs,
                                              float* smem, int tid, int bar_id) {
  if constexpr (!gemm_float_slices<V>) {
    if (g.a_rs == 1)
      wg_gemm_tile<WgTileOf<Cfg>, true>(g, i0, j0, kb0, kb1, part, part_bs,
                                        smem, tid, bar_id);
    else
      wg_gemm_tile<WgTileOf<Cfg>, false>(g, i0, j0, kb0, kb1, part, part_bs,
                                         smem, tid, bar_id);
  } else {
    switch (mode) {
      case GEMM_AK:
        gemm_tile<Cfg, GEMM_AK>(g, i0, j0, kb0, kb1, part, part_bs, smem, tid, bar_id);
        break;
      case GEMM_AR:
        gemm_tile<Cfg, GEMM_AR>(g, i0, j0, kb0, kb1, part, part_bs, smem, tid, bar_id);
        break;
      default:
        gemm_tile<Cfg, GEMM_ANY>(g, i0, j0, kb0, kb1, part, part_bs, smem, tid, bar_id);
        break;
    }
  }
}

// A batched product: one lane's view and the operands' lane strides.
template <class V>
struct GemmArgsT {
  V v;
  int P;
  long long a_bs, b_bs, d_bs, o_bs, e_bs, o2_bs;
  __device__ V lane(int p) const {
    V w = v;
    w.A += p * a_bs;
    w.B += p * b_bs;
    if (w.D) w.D += p * d_bs;
    w.O += p * o_bs;
    if (w.O2) {
      w.E += p * e_bs;
      w.O2 += p * o2_bs;
    }
    return w;
  }
};

using GemmArgs = GemmArgsT<GemmView>;

// The batched product of GEMM_PARAMS at the view's element types.
template <class V = GemmView>
inline GemmArgsT<V> make_args(const void* A, long long a_bs, long long a_rs,
                          long long a_cs, const void* B, long long b_bs,
                          long long b_rs, long long b_cs, const void* D,
                          long long d_bs, long long d_rs, long long d_cs,
                          void* O, long long o_bs, long long o_rs,
                          long long o_cs, const void* E, long long e_bs,
                          long long e_rs, long long e_cs, void* O2,
                          long long o2_bs, long long o2_rs, long long o2_cs,
                          int P, int M, int N, int K, int sub) {
  using TA = typename V::TA;
  using TB = typename V::TB;
  using TD = typename V::TD;
  GemmArgsT<V> g{};
  g.v = V{M, N, K, (const TA*)A, a_rs, a_cs, (const TB*)B, b_rs,
          b_cs, (const TD*)D, d_rs, d_cs, (typename V::TO*)O, o_rs, o_cs,
          sub, O2 ? (const TD*)E : nullptr, e_rs, e_cs, (typename V::TO2*)O2,
          o2_rs, o2_cs};
  g.P = P;
  g.a_bs = a_bs, g.b_bs = b_bs, g.d_bs = d_bs, g.o_bs = o_bs, g.e_bs = e_bs;
  g.o2_bs = o2_bs;
  return g;
}

#define GEMM_PARAMS                                                          \
  const void *A, long long a_bs, long long a_rs, long long a_cs,            \
      const void *B, long long b_bs, long long b_rs, long long b_cs,        \
      const void *D, long long d_bs, long long d_rs, long long d_cs,        \
      void *O, long long o_bs, long long o_rs, long long o_cs,              \
      const void *E, long long e_bs, long long e_rs, long long e_cs,        \
      void *O2, long long o2_bs, long long o2_rs, long long o2_cs, int P,   \
      int M, int N, int K, int sub
#define GEMM_ARGS                                                            \
  A, a_bs, a_rs, a_cs, B, b_bs, b_rs, b_cs, D, d_bs, d_rs, d_cs, O, o_bs,    \
      o_rs, o_cs, E, e_bs, e_rs, e_cs, O2, o2_bs, o2_rs, o2_cs, P, M, N, K, sub

__host__ __device__ inline int gemm_kblocks(int K) {
  return (K + WG_BLOCK_K - 1) / WG_BLOCK_K;
}

}  // namespace repro
