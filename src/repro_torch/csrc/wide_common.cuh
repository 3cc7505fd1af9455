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
#pragma once
#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace repro {

constexpr int WG_THREADS = 256;
constexpr int WG_BK = 16;                    // terms of a slice
constexpr int WG_BLOCK = 16;                 // slices of a block sum
constexpr int WG_BLOCK_K = WG_BK * WG_BLOCK; // terms of a block sum

// One lane's product: every operand by its pointer and (row, column)
// strides in floats. D, E and O2 may be null.
struct GemmView {
  int M, N, K;
  const float* A;
  long long a_rs, a_cs;
  const float* B;
  long long b_rs, b_cs;
  const float* D;
  long long d_rs, d_cs;
  float* O;
  long long o_rs, o_cs;
  int sub;  // 1: D - tot (or -tot), 0: D + tot (or tot)
  const float* E;
  long long e_rs, e_cs;
  float* O2;  // with E: O2 = E - tot
  long long o2_rs, o2_cs;
};

// The epilogue of one element from its total.
__device__ __forceinline__ void gemm_store(const GemmView& g, int i, int j,
                                           float tot) {
  float v;
  if (g.D) {
    const float d = __ldcg(g.D + i * g.d_rs + j * g.d_cs);
    v = g.sub ? d - tot : d + tot;
  } else {
    v = g.sub ? -tot : tot;
  }
  g.O[i * g.o_rs + j * g.o_cs] = v;
  if (g.O2) g.O2[i * g.o2_rs + j * g.o2_cs] = __ldcg(g.E + i * g.e_rs + j * g.e_cs) - tot;
}

// 16-byte stores (and loads of D and E) in the epilogue: every
// output-shaped operand has unit column stride and 16-byte aligned rows.
__host__ __device__ inline bool gemm_vec_ok(const void* p, long long rs,
                                            long long cs) {
  return p == nullptr || (cs == 1 && rs % 4 == 0 && (uintptr_t)p % 16 == 0);
}

__host__ __device__ inline bool gemm_vec_out(const GemmView& g) {
  return gemm_vec_ok(g.O, g.o_rs, g.o_cs) && gemm_vec_ok(g.D, g.d_rs, g.d_cs) &&
         gemm_vec_ok(g.O2, g.o2_rs, g.o2_cs) &&
         (g.O2 == nullptr || gemm_vec_ok(g.E, g.e_rs, g.e_cs));
}

// The epilogue of four consecutive elements (i, j..j+3), all inside the
// output, by 16-byte accesses: the arithmetic of gemm_store.
__device__ __forceinline__ void gemm_store4(const GemmView& g, int i, int j,
                                            const float* tot) {
  float4 v = make_float4(tot[0], tot[1], tot[2], tot[3]);
  if (g.sub) v = make_float4(-v.x, -v.y, -v.z, -v.w);
  if (g.D) {
    const float4 d = __ldcg(reinterpret_cast<const float4*>(g.D + i * g.d_rs + j));
    v = g.sub ? make_float4(d.x - tot[0], d.y - tot[1], d.z - tot[2], d.w - tot[3])
              : make_float4(d.x + tot[0], d.y + tot[1], d.z + tot[2], d.w + tot[3]);
  }
  *reinterpret_cast<float4*>(g.O + i * g.o_rs + j) = v;
  if (g.O2) {
    const float4 e = __ldcg(reinterpret_cast<const float4*>(g.E + i * g.e_rs + j));
    *reinterpret_cast<float4*>(g.O2 + i * g.o2_rs + j) =
        make_float4(e.x - tot[0], e.y - tot[1], e.z - tot[2], e.w - tot[3]);
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
// the lane strides keep every lane aligned.
__host__ __device__ inline int gemm_mode(const GemmView& g, bool lane_ok) {
  const bool b16 = lane_ok && g.b_cs == 1 && g.b_rs % 4 == 0 && gemm_al16(g.B);
  if (!b16 || !gemm_al16(g.A)) return GEMM_ANY;
  if (g.a_rs == 1 && g.a_cs % 4 == 0) return GEMM_AK;
  if (g.a_cs == 1 && g.a_rs % 4 == 0) return GEMM_AR;
  return GEMM_ANY;
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
template <class Cfg, int MODE>
__device__ __forceinline__ void gemm_tile(const GemmView& g, int i0, int j0,
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
        sa[k * BM + i] = gk < g.K && gi < g.M ? __ldcg(g.A + gi * g.a_rs + gk * g.a_cs) : 0.f;
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
        sb[k * BN + j] = gk < g.K && gj < g.N ? __ldcg(g.B + gk * g.b_rs + gj * g.b_cs) : 0.f;
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

// The tile routine at a runtime copy mode.
template <class Cfg>
__device__ __forceinline__ void gemm_tile_any(int mode, const GemmView& g,
                                              int i0, int j0, int kb0, int kb1,
                                              float* part, long long part_bs,
                                              float* smem, int tid, int bar_id) {
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

// A batched product: one lane's view and the operands' lane strides.
struct GemmArgs {
  GemmView v;
  int P;
  long long a_bs, b_bs, d_bs, o_bs, e_bs, o2_bs;
  __device__ GemmView lane(int p) const {
    GemmView w = v;
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

inline GemmArgs make_args(const void* A, long long a_bs, long long a_rs,
                          long long a_cs, const void* B, long long b_bs,
                          long long b_rs, long long b_cs, const void* D,
                          long long d_bs, long long d_rs, long long d_cs,
                          void* O, long long o_bs, long long o_rs,
                          long long o_cs, const void* E, long long e_bs,
                          long long e_rs, long long e_cs, void* O2,
                          long long o2_bs, long long o2_rs, long long o2_cs,
                          int P, int M, int N, int K, int sub) {
  GemmArgs g{};
  g.v = GemmView{M, N, K, (const float*)A, a_rs, a_cs, (const float*)B, b_rs,
                 b_cs, (const float*)D, d_rs, d_cs, (float*)O, o_rs, o_cs,
                 sub, O2 ? (const float*)E : nullptr, e_rs, e_cs, (float*)O2,
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
