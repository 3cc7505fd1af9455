// K5 and K6 above 128 columns: the body of the wide kernel (fused_sweep.cu's
// header describes its phases), a template on the element type E of the
// window and of every output: float (fused_sweep.cu's fused_wide_kernel) or
// bf16 (fused_wide_bf16.cu's fused_wide_bf16_kernel), each in its own
// translation unit, compiled side by side.
//
// At bf16 the launch rounds where the stepped bf16 route (K1-K4 at bf16
// above 128 columns) rounds, and reads back rounded what that route's next
// kernel reads:
//   * leaf: K1 rounds once at its end, and its blocked QR reads its own Y
//     and T back, so the leaf runs the float blocked QR on the widened
//     panel with Y, T and R in float scratch, then rounds them;
//   * butterfly: each level's stacks are built from the rounded R, the
//     blocked QR runs in float with T and R in float scratch, and Y2, T and
//     R are rounded as K3 stores them; the next level reads them rounded;
//   * leaf apply and each combine: the products of K2 and K4 on the bf16
//     tensors themselves, on wgmma (wgmma_bf16.cuh, wide_common.cuh's
//     wg_gemm_tile): Z (inner) and W f32, C_local, Ct - W and Cb - Y2 W
//     rounded, W rounded into Ws, Cb - Y2 W reading W in f32.
// The products' order contract leaves the tile, the wgmma N and the thread
// out of every sum, so they equal the stepped route's (csrc/wide_bf16.cu).
// The bf16 kernel's tile phases run the 64 x 64 tile (two m64n32 warpgroup
// products) at 128 registers (PlainTiles of wide_qr.cuh): with the float
// kernel's register trade for the 128 x 128 tile, ptxas failed to allocate
// the FFMA tile ("register count of 232"). At float every step is the
// float code it was.
#pragma once
#include <type_traits>

#include "fused_panel.cuh"
#include "wide_common.cuh"
#include "wide_qr.cuh"

// The kernels that instantiate this body stay at global scope, where the
// profiler's and the ptxas log's names match them by their own name.
using namespace repro;

template <class E>
inline constexpr bool kWideFloat = std::is_same_v<E, float>;

// How the tile phases run (wide_qr.cuh): the float kernel trades registers
// for the 128 x 128 tile; the bf16 kernel, which ptxas could not allocate
// so, runs the 64 x 64 tile at its 128 registers.
template <class E>
using WideTiles = std::conditional_t<kWideFloat<E>, TradeTiles, PlainTiles>;

// The float copies of the bf16 launch's blocked QRs (none at float).
template <class E>
struct WideF32 {};
template <>
struct WideF32<bf16> {
  float* Aw;  // (P, m, b): the leaf's panel widened
  float* Yf;  // (P, m, b): the leaf's Y
  float* Tl;  // (P, b, b): the leaf's T
  float* Tb;  // (P, b, b): a blocked QR's T (level or leaf R's scratch),
  float* Rb;  // (P, b, b): its R
};

template <class E>
struct WideArgs : WideF32<E> {
  FusedArgs<E> a;
  WideQR q;
  int xch_blocks;  // arrival counters a team phase
};

// The team phases of a launch: the leaf's sub-panels, and each butterfly
// level's.
__host__ __device__ inline int fw_team_phases(int b, int L) {
  return cdiv(b, FW_NB) * (1 + L);
}

// Floats of the bf16 launch's float copies (each 128-byte aligned), carved
// from `base` into wa when both are given.
template <class E>
inline size_t fw_copies_floats(int P, int m, int w, int b, float* base,
                               WideArgs<E>* wa) {
  if constexpr (kWideFloat<E>) {
    return 0;
  } else {
    const size_t bb = (size_t)b * b;
    const size_t sizes[5] = {(size_t)m * b, (size_t)m * b, bb, bb, bb};
    float* at[5];
    size_t off = 0;
    for (int i = 0; i < 5; ++i) {
      at[i] = base ? base + off : nullptr;
      off += ((size_t)P * sizes[i] + 31) / 32 * 32;
    }
    if (wa) {
      wa->Aw = at[0], wa->Yf = at[1], wa->Tl = at[2], wa->Tb = at[3];
      wa->Rb = at[4];
    }
    return off;
  }
}

// The element-wise steps of the wide phases, by rows (grid_rows), each out
// of line so that its code stays out of the tile phases' register budget.
__device__ inline bool wide_dead(int p, int group, int t) {
  return (p & ~(group - 1)) + group <= t;
}

// bf16: every lane's panel (the window's first b columns) widened into Aw
// (row stride b).
template <class E>
__device__ __noinline__ void wide_widen_panel(const WideArgs<E>& wa) {
  const FusedArgs<E>& a = wa.a;
  const int m = a.m, b = a.b;
  grid_rows(a.P * m, [&](int row, int lane) {
    const int p = row / m, i = row % m;
    const E* src = a.win + p * a.w_bs + i * a.w_ld;
    float* dst = wa.Aw + (size_t)row * b;
    for (int c = lane; c < b; c += 32) dst[c] = widen(src[c]);
  });
}

// bf16: the leaf's Y, T and R rounded from their float copies (zero on
// the inactive lanes, which the blocked QR zeroed).
template <class E>
__device__ __noinline__ void wide_round_leaf(const WideArgs<E>& wa) {
  const FusedArgs<E>& a = wa.a;
  const int m = a.m, b = a.b, rows = m + 2 * b;
  const size_t mb = (size_t)m * b, bb = (size_t)b * b;
  grid_rows(a.P * rows, [&](int row, int lane) {
    const int p = row / rows, r = row % rows;
    float* src;
    E* dst;
    if (r < m) {
      src = wa.Yf + p * mb + (size_t)r * b, dst = a.leaf_Y + p * mb + (size_t)r * b;
    } else if (r < m + b) {
      src = wa.Tl + p * bb + (size_t)(r - m) * b;
      dst = a.leaf_T + p * bb + (size_t)(r - m) * b;
    } else {
      src = wa.Tb + p * bb + (size_t)(r - m - b) * b;
      dst = a.R_leaf + p * bb + (size_t)(r - m - b) * b;
    }
    for (int c = lane; c < b; c += 32) dst[c] = narrow<E>(__ldcg(src + c));
  });
}

// Level lvl's stacks [triu(R_top); triu(R_bot)] of the live lanes, and the
// pass-through of the others (R, and zero Y2 and T).
template <class E>
__device__ __noinline__ void wide_stacks(const WideArgs<E>& wa, int lvl) {
  const FusedArgs<E>& a = wa.a;
  const int b = a.b, t = a.t_lane, group = 1 << lvl;
  const size_t bb = (size_t)b * b, lvl_off = (size_t)lvl * a.P * bb;
  const E* Rin = lvl == 0 ? a.R_leaf : a.Rtmp + (size_t)(lvl - 1) * a.P * bb;
  E* Rout = lvl == a.L - 1 ? a.R_carry : a.Rtmp + lvl_off;
  float* stack = wa.q.s.stack + (size_t)lvl * a.P * 2 * bb;
  grid_rows(a.P * 2 * b, [&](int row, int lane) {
    const int p = row / (2 * b), q = row % (2 * b), buddy = p ^ group;
    if (!wide_dead(p, group, t) && !wide_dead(buddy, group, t)) {
      const bool is_top = ((p >> lvl) & 1) == ((t >> lvl) & 1);
      const bool low = q >= b;  // the bottom triangle
      const int r = q % b, src = (is_top != low) ? p : buddy;
      for (int c = lane; c < b; c += 32)
        stack[(size_t)row * b + c] =
            r > c ? 0.f : ldcg1(Rin + src * bb + (size_t)r * b + c);
    } else if (q < b) {
      const int from = wide_dead(p, group, t) ? buddy : p;
      const size_t o = p * bb + (size_t)q * b;
      for (int c = lane; c < b; c += 32) {
        Rout[o + c] = narrow<E>(ldcg1(Rin + from * bb + (size_t)q * b + c));
        a.level_Y2[lvl_off + o + c] = narrow<E>(0.f);
        a.level_T[lvl_off + o + c] = narrow<E>(0.f);
      }
    }
  });
}

// Level lvl's Y2 = triu(Y[b:]) of the live lanes; at bf16 also their T and
// R, rounded from the float copies.
template <class E>
__device__ __noinline__ void wide_y2(const WideArgs<E>& wa, int lvl) {
  const FusedArgs<E>& a = wa.a;
  const int b = a.b, t = a.t_lane, group = 1 << lvl;
  const size_t bb = (size_t)b * b, lvl_off = (size_t)lvl * a.P * bb;
  grid_rows(a.P * b, [&](int row, int lane) {
    const int p = row / b, r = row % b;
    if (wide_dead(p, group, t) || wide_dead(p ^ group, group, t)) return;
    for (int c = lane; c < b; c += 32)
      a.level_Y2[lvl_off + (size_t)row * b + c] = narrow<E>(
          r > c ? 0.f : __ldcg(wa.q.s.Ys + p * 2 * bb + bb + (size_t)r * b + c));
    if constexpr (!kWideFloat<E>) {
      E* Rout = lvl == a.L - 1 ? a.R_carry : a.Rtmp + lvl_off;
      for (int c = lane; c < b; c += 32) {
        a.level_T[lvl_off + (size_t)row * b + c] =
            narrow<E>(__ldcg(wa.Tb + (size_t)row * b + c));
        Rout[(size_t)row * b + c] = narrow<E>(__ldcg(wa.Rb + (size_t)row * b + c));
      }
    }
  });
}

// The C' rows entering level 0 (or K5's C'): rows [r0, r0 + b) of
// C_local at the clamped row start, zero on inactive lanes.
template <class E>
__device__ __noinline__ void wide_cprime(const WideArgs<E>& wa) {
  const FusedArgs<E>& a = wa.a;
  const int m = a.m, b = a.b, w = a.w;
  const size_t mw = (size_t)m * w;
  const E* C = a.C_local;
  E* cp_out = a.L > 0 ? a.Cs_self : a.C_prime;
  grid_rows(a.P * b, [&](int row, int lane) {
    const int p = row / b, r = row % b;
    const int r0 = min(max(a.rs[p], 0), m - b);
    const bool act = lane_active(a, p);
    for (int col = lane; col < w; col += 32)
      cp_out[(size_t)row * w + col] = narrow<E>(
          act ? ldcg1(C + p * mw + (size_t)(r0 + r) * w + col) : 0.f);
  });
}

// Combine lvl's copies: the buddy's C', and for the lanes whose pair is
// not live the pass-through C' and a zero W.
template <class E>
__device__ __noinline__ void wide_combine_copies(const WideArgs<E>& wa, int lvl) {
  const FusedArgs<E>& a = wa.a;
  const int b = a.b, w = a.w, t = a.t_lane;
  const size_t bw = (size_t)b * w, lvl_bw = (size_t)lvl * a.P * bw;
  const E* Cin = a.Cs_self + lvl_bw;
  E* Cout = lvl == a.L - 1 ? a.C_prime : a.Cs_self + lvl_bw + a.P * bw;
  grid_rows(a.P * b, [&](int row, int lane) {
    const int p = row / b, buddy = p ^ (1 << lvl);
    const size_t e0 = (size_t)row * w, i0 = e0 - p * bw;
    const bool dead = !(p >= t && buddy >= t);
    for (int col = lane; col < w; col += 32) {
      a.Cs_buddy[lvl_bw + e0 + col] = narrow<E>(ldcg1(Cin + buddy * bw + i0 + col));
      if (dead) {
        Cout[e0 + col] = narrow<E>(ldcg1(Cin + e0 + col));
        a.Ws[lvl_bw + e0 + col] = narrow<E>(0.f);
      }
    }
  });
}

// bf16, combine lvl: the live lanes' W (f32, Wm) rounded into Ws, as K4
// returns it.
template <class E>
__device__ __noinline__ void wide_round_w(const WideArgs<E>& wa, int lvl) {
  const FusedArgs<E>& a = wa.a;
  const int b = a.b, w = a.w, t = a.t_lane;
  const size_t lvl_bw = (size_t)lvl * a.P * b * w;
  grid_rows(a.P * b, [&](int row, int lane) {
    const int p = row / b, buddy = p ^ (1 << lvl);
    if (!(p >= t && buddy >= t)) return;
    const size_t e0 = (size_t)row * w;
    for (int col = lane; col < w; col += 32)
      a.Ws[lvl_bw + e0 + col] = narrow<E>(__ldcg(wa.q.s.Wm + e0 + col));
  });
}

// A batched bf16 product of a phase (lane p runs when f(p, v) fills its
// view v of type V and returns true), and its grid-wide tile phase: the
// (lane, tile) items go round the blocks, each on warpgroups 0-1 as the
// wgmma tile of PlainTiles' shape (wide_common.cuh's wg_gemm_tile); the
// whole sum in one item (no split of k), so no second pass.
template <class V, class F>
struct ProdV {
  F f;
  int P, M, N, K;
};

template <class V, class F>
__device__ ProdV<V, F> prod_v(F f, int P, int M, int N, int K) {
  return ProdV<V, F>{f, P, M, N, K};
}

template <class V, class F>
__device__ void tile_phase_wg(const ProdV<V, F>& q, float* smem) {
  using Cfg = PlainTiles::Cfg;
  const int tn = cdiv(q.N, Cfg::BN), tl = cdiv(q.M, Cfg::BM) * tn;
  if (threadIdx.x < WG_THREADS) {
    for (int it = blockIdx.x; it < q.P * tl; it += gridDim.x) {
      const int t = it % tl, p = it / tl;
      V v;
      if (!q.f(p, v)) continue;
      gemm_tile_any<Cfg>(GEMM_ANY, v, (t / tn) * Cfg::BM, (t % tn) * Cfg::BN,
                         0, gemm_kblocks(v.K), nullptr, 0, smem, threadIdx.x, 1);
    }
  }
  bar_sync(3, QR_THREADS);
}

// Phase 2 above 128, one level: the FT butterfly on the blocked QR of the
// stacks.
template <class E>
__device__ void wide_butterfly(const WideArgs<E>& wa, int lvl,
                               GlobalTeams& teams, float* smem) {
  const FusedArgs<E>& a = wa.a;
  const WideScratch& s = wa.q.s;
  const int b = a.b, t = a.t_lane, group = 1 << lvl;
  const size_t bb = (size_t)b * b, lvl_off = (size_t)lvl * a.P * bb;
  float* stack = s.stack + (size_t)lvl * a.P * 2 * bb;
  float* cur = s.cur + (size_t)a.P * ((size_t)a.m + (size_t)lvl * 2 * b) * fw_cur_ld(b);
  float *T_out, *R_out;  // the blocked QR's T and R
  if constexpr (kWideFloat<E>) {
    T_out = a.level_T + lvl_off;
    R_out = lvl == a.L - 1 ? a.R_carry : a.Rtmp + lvl_off;
  } else {
    T_out = wa.Tb, R_out = wa.Rb;
  }
  auto live = [&](int p) {
    return !wide_dead(p, group, t) && !wide_dead(p ^ group, group, t);
  };
  wide_stacks(wa, lvl);
  grid_barrier(wa.q.bar);
  blocked_qr<WideTiles<E>>(
      wa.q, teams, 2 * b, b, live,
      [&](int p) -> const float* { return stack + p * 2 * bb; },
      b, [](int) { return 0; }, s.Ys, 2 * bb, T_out, R_out, cur, false, smem);
  wide_y2(wa, lvl);
  grid_barrier(wa.q.bar);
}

// Phase 3 above 128: C_local = W - Y (T^T (Y^T W)) on every lane, then the
// C' rows. At bf16 the products of K2's wide route on the bf16 tensors
// (wgmma), Z and W f32.
template <class E>
__device__ void wide_apply(const WideArgs<E>& wa, float* smem) {
  const FusedArgs<E>& a = wa.a;
  const WideScratch& s = wa.q.s;
  const int m = a.m, b = a.b, w = a.w;
  const size_t mb = (size_t)m * b, bb = (size_t)b * b, mw = (size_t)m * w,
               bw = (size_t)b * w;
  if constexpr (kWideFloat<E>) {
    const float *Y = a.leaf_Y, *T = a.leaf_T, *win = a.win;
    float* C = a.C_local;
    const long long w_bs = a.w_bs, w_ld = a.w_ld;
    tile_phase<WideTiles<E>>(prod([&](int p, GemmView& v) {
      v = gemm_view(b, w, m, Y + p * mb, 1, b, win + p * w_bs, w_ld,
                    nullptr, 0, s.Z + p * bw, w, 0);
      return true;
    }, a.P, b, w, m), smem, wa.q.bar);
    grid_barrier(wa.q.bar);
    tile_phase<WideTiles<E>>(prod([&](int p, GemmView& v) {
      v = gemm_view(b, w, b, T + p * bb, 1, b, s.Z + p * bw, w, nullptr, 0,
                    s.Wm + p * bw, w, 0);
      return true;
    }, a.P, b, w, b), smem, wa.q.bar);
    grid_barrier(wa.q.bar);
    tile_phase<WideTiles<E>>(prod([&](int p, GemmView& v) {
      v = gemm_view(m, w, b, Y + p * mb, b, 1, s.Wm + p * bw, w,
                    win + p * w_bs, w_ld, C + p * mw, w, 1);
      return true;
    }, a.P, m, w, b), smem, wa.q.bar);
  } else {
    tile_phase_wg(prod_v<GemmBBF>([&](int p, GemmBBF& v) {
      v = GemmBBF{b, w, m, a.leaf_Y + p * mb, 1, b, a.win + p * a.w_bs, a.w_ld,
                  1, nullptr, 0, 0, s.Z + p * bw, w, 1, 0,
                  nullptr, 0, 0, nullptr, 0, 0};
      return true;
    }, a.P, b, w, m), smem);
    grid_barrier(wa.q.bar);
    tile_phase_wg(prod_v<GemmBFF>([&](int p, GemmBFF& v) {
      v = GemmBFF{b, w, b, a.leaf_T + p * bb, 1, b, s.Z + p * bw, w, 1,
                  nullptr, 0, 0, s.Wm + p * bw, w, 1, 0,
                  nullptr, 0, 0, nullptr, 0, 0};
      return true;
    }, a.P, b, w, b), smem);
    grid_barrier(wa.q.bar);
    tile_phase_wg(prod_v<GemmBFB>([&](int p, GemmBFB& v) {
      v = GemmBFB{m, w, b, a.leaf_Y + p * mb, b, 1, s.Wm + p * bw, w, 1,
                  a.win + p * a.w_bs, a.w_ld, 1, a.C_local + p * mw, w, 1, 1,
                  nullptr, 0, 0, nullptr, 0, 0};
      return true;
    }, a.P, m, w, b), smem);
  }
  grid_barrier(wa.q.bar);
  wide_cprime(wa);
}

// Phase 4 above 128, one level: the trailing combine
// (core/trailing.py::trailing_combine_level with dead_threshold = t_lane).
// At bf16 the products of K4's wide route on the bf16 tensors (wgmma),
// inner and W f32, then W rounded into Ws.
template <class E>
__device__ void wide_combine(const WideArgs<E>& wa, int lvl, float* smem) {
  const FusedArgs<E>& a = wa.a;
  const WideScratch& s = wa.q.s;
  const int b = a.b, w = a.w, t = a.t_lane;
  const size_t bb = (size_t)b * b, bw = (size_t)b * w;
  const size_t lvl_bw = (size_t)lvl * a.P * bw, lvl_bb = (size_t)lvl * a.P * bb;
  const E *Y2 = a.level_Y2 + lvl_bb, *T = a.level_T + lvl_bb,
          *Cin = a.Cs_self + lvl_bw;
  E* Cout = lvl == a.L - 1 ? a.C_prime : a.Cs_self + lvl_bw + a.P * bw;
  auto buddy = [&](int p) { return p ^ (1 << lvl); };
  auto is_top = [&](int p) { return ((p >> lvl) & 1) == ((t >> lvl) & 1); };
  auto live = [&](int p) { return p >= t && buddy(p) >= t; };
  auto top = [&](int p) { return Cin + (is_top(p) ? p : buddy(p)) * bw; };
  auto bot = [&](int p) { return Cin + (is_top(p) ? buddy(p) : p) * bw; };
  if constexpr (kWideFloat<E>) {
    float* W = a.Ws + lvl_bw;
    // inner = Ct + Y2^T Cb
    tile_phase<WideTiles<E>>(prod([&](int p, GemmView& v) {
      v = gemm_view(b, w, b, Y2 + p * bb, 1, b, bot(p), w, top(p), w,
                    s.Z + p * bw, w, 0);
      return live(p);
    }, a.P, b, w, b), smem, wa.q.bar);
    grid_barrier(wa.q.bar);
    // W = T^T inner, and on the top lane Ct - W; the buddy's C' and the
    // pass-through of the lanes whose pair is not live
    tile_phase<WideTiles<E>>(prod([&](int p, GemmView& v) {
      v = gemm_view(b, w, b, T + p * bb, 1, b, s.Z + p * bw, w, nullptr, 0,
                    W + p * bw, w, 0);
      if (is_top(p)) {
        v.E = top(p), v.e_rs = w, v.e_cs = 1;
        v.O2 = Cout + p * bw, v.o2_rs = w, v.o2_cs = 1;
      }
      return live(p);
    }, a.P, b, w, b), smem, wa.q.bar);
    wide_combine_copies(wa, lvl);
    grid_barrier(wa.q.bar);
    // the bottom lane: Cb - Y2 W
    tile_phase<WideTiles<E>>(prod([&](int p, GemmView& v) {
      v = gemm_view(b, w, b, Y2 + p * bb, b, 1, W + p * bw, w, bot(p), w,
                    Cout + p * bw, w, 1);
      return live(p) && !is_top(p);
    }, a.P, b, w, b), smem, wa.q.bar);
  } else {
    float* W = s.Wm;
    tile_phase_wg(prod_v<GemmBBF>([&](int p, GemmBBF& v) {
      v = GemmBBF{b, w, b, Y2 + p * bb, 1, b, bot(p), w, 1, top(p), w, 1,
                  s.Z + p * bw, w, 1, 0, nullptr, 0, 0, nullptr, 0, 0};
      return live(p);
    }, a.P, b, w, b), smem);
    grid_barrier(wa.q.bar);
    tile_phase_wg(prod_v<GemmBFF>([&](int p, GemmBFF& v) {
      v = GemmBFF{b, w, b, T + p * bb, 1, b, s.Z + p * bw, w, 1, nullptr, 0, 0,
                  W + p * bw, w, 1, 0, nullptr, 0, 0, nullptr, 0, 0};
      if (is_top(p)) {
        v.E = top(p), v.e_rs = w, v.e_cs = 1;
        v.O2 = Cout + p * bw, v.o2_rs = w, v.o2_cs = 1;
      }
      return live(p);
    }, a.P, b, w, b), smem);
    wide_combine_copies(wa, lvl);
    grid_barrier(wa.q.bar);
    tile_phase_wg(prod_v<GemmBFB>([&](int p, GemmBFB& v) {
      v = GemmBFB{b, w, b, Y2 + p * bb, b, 1, W + p * bw, w, 1, bot(p), w, 1,
                  Cout + p * bw, w, 1, 1, nullptr, 0, 0, nullptr, 0, 0};
      return live(p) && !is_top(p);
    }, a.P, b, w, b), smem);
    grid_barrier(wa.q.bar);
    wide_round_w(wa, lvl);
  }
}

// The whole launch: leaf, L butterfly levels, the leaf apply, L combines.
template <class E>
__device__ void fused_wide_body(const WideArgs<E>& wa, float* smem) {
  const FusedArgs<E>& a = wa.a;
  const size_t mb = (size_t)a.m * a.b;
  GlobalTeams teams{a.xch, a.arrivals, wa.xch_blocks, 0};
  if constexpr (kWideFloat<E>) {
    blocked_qr<WideTiles<E>>(
        wa.q, teams, a.m, a.b, [&](int p) { return lane_active(a, p); },
        [&](int p) -> const float* { return a.win + p * a.w_bs; }, a.w_ld,
        [&](int p) { return a.rs[p]; }, a.leaf_Y, mb, a.leaf_T, a.R_leaf,
        wa.q.s.cur, true, smem);
  } else {
    wide_widen_panel(wa);
    grid_barrier(wa.q.bar);
    blocked_qr<WideTiles<E>>(
        wa.q, teams, a.m, a.b, [&](int p) { return lane_active(a, p); },
        [&](int p) -> const float* { return wa.Aw + p * mb; }, a.b,
        [&](int p) { return a.rs[p]; }, wa.Yf, mb, wa.Tl, wa.Tb, wa.q.s.cur,
        true, smem);
    wide_round_leaf(wa);
    grid_barrier(wa.q.bar);
  }
  for (int lvl = 0; lvl < a.L; ++lvl) wide_butterfly(wa, lvl, teams, smem);
  wide_apply(wa, smem);
  for (int lvl = 0; lvl < a.L; ++lvl) {
    grid_barrier(wa.q.bar);
    wide_combine(wa, lvl, smem);
  }
}

// Above 128 columns: shared memory of a block (the largest phase), and the
// scratch of P lanes: fw_scratch_floats, the grid barrier's words, then at
// bf16 the float copies.
inline size_t fw_launch_smem_bytes(int m, int b, int L) {
  return fw_smem_floats(m, b, L > 0) * sizeof(float);
}

template <class E>
inline size_t fw_launch_scratch_floats(int P, int m, int w, int b, int L) {
  return fw_scratch_floats(P, m, w, b, L, nullptr, nullptr) + FW_BAR_FLOATS +
         fw_copies_floats<E>(P, m, w, b, nullptr, nullptr);
}

// One cooperative launch of `kernel` on every block the card holds at once
// (at most xch_blocks), scratch as fw_launch_scratch_floats<E>.
template <class E>
inline int fw_launch(void (*kernel)(WideArgs<E>), WideArgs<E>& wa,
                     float* scratch, void* stream) {
  FusedArgs<E>& a = wa.a;
  if (a.b <= FW_NB) return (int)cudaErrorInvalidValue;
  const size_t off = fw_scratch_floats(a.P, a.m, a.w, a.b, a.L, &wa.q.s, scratch);
  wa.q.bar = (unsigned*)(scratch + off);
  fw_copies_floats<E>(a.P, a.m, a.w, a.b, scratch + off + FW_BAR_FLOATS, &wa);
  wa.q.yj_bs = (size_t)fw_mm(a.m, a.b, a.L > 0) * FW_NB;
  wa.q.work = a.work;
  wa.q.P = a.P;
  const size_t smem = fw_launch_smem_bytes(a.m, a.b, a.L);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if constexpr (WideTiles<E>::kTrade) {  // the pool the trade assumes
    if ((err = fw_check_regs((const void*)kernel)) != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      QR_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  int grid = per_sm * sms < wa.xch_blocks ? per_sm * sms : wa.xch_blocks;
  if (grid < fw_max_team(a.m, a.b, a.L > 0))
    return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(a.arrivals, 0,
                        (size_t)fw_team_phases(a.b, a.L) * wa.xch_blocks *
                            sizeof(unsigned),
                        (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(wa.q.bar, 0, 4 * sizeof(unsigned), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&wa};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(QR_THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K5 above 128 columns through `kernel` (arguments: panel_qr_apply_wide_f32).
template <class E>
inline int fw_k5_entry(void (*kernel)(WideArgs<E>), const void* W,
                       long long w_bs, long long w_ld, const void* rs, void* Y,
                       void* T, void* R, void* C, void* Cp, void* work,
                       void* xch, void* arrivals, int xch_blocks,
                       void* scratch, int P, int m, int w, int b, void* stream) {
  WideArgs<E> wa{};
  FusedArgs<E>& a = wa.a;
  a.win = (const E*)W, a.w_bs = w_bs, a.w_ld = w_ld;
  a.rs = (const int*)rs, a.active = nullptr;
  a.P = P, a.m = m, a.w = w, a.b = b, a.L = 0, a.t_lane = 0;
  a.leaf_Y = (E*)Y, a.leaf_T = (E*)T, a.R_leaf = (E*)R;
  a.C_local = (E*)C, a.C_prime = (E*)Cp, a.work = (float*)work;
  a.xch = (float*)xch, a.arrivals = (unsigned*)arrivals;
  wa.xch_blocks = xch_blocks;
  return fw_launch(kernel, wa, (float*)scratch, stream);
}

// K6 above 128 columns through `kernel` (arguments: fused_panel_wide_f32).
template <class E>
inline int fw_k6_entry(void (*kernel)(WideArgs<E>), const void* W,
                       long long w_bs, long long w_ld, const void* rs,
                       const void* active, int P, int m, int w, int b, int L,
                       int t_lane, int xch_blocks, void* leaf_Y, void* leaf_T,
                       void* R_leaf, void* R_carry, void* level_Y2,
                       void* level_T, void* C_local, void* C_prime, void* Ws,
                       void* Cs_self, void* Cs_buddy, void* work, void* xch,
                       void* arrivals, void* Rtmp, void* scratch,
                       void* stream) {
  WideArgs<E> wa{};
  FusedArgs<E>& a = wa.a;
  a.win = (const E*)W, a.w_bs = w_bs, a.w_ld = w_ld;
  a.rs = (const int*)rs, a.active = (const unsigned char*)active;
  a.P = P, a.m = m, a.w = w, a.b = b, a.L = L, a.t_lane = t_lane;
  a.leaf_Y = (E*)leaf_Y, a.leaf_T = (E*)leaf_T;
  a.R_leaf = (E*)R_leaf, a.R_carry = (E*)R_carry;
  a.level_Y2 = (E*)level_Y2, a.level_T = (E*)level_T;
  a.C_local = (E*)C_local, a.C_prime = (E*)C_prime;
  a.Ws = (E*)Ws, a.Cs_self = (E*)Cs_self, a.Cs_buddy = (E*)Cs_buddy;
  a.work = (float*)work, a.xch = (float*)xch, a.arrivals = (unsigned*)arrivals;
  a.Rtmp = (E*)Rtmp;
  wa.xch_blocks = xch_blocks;
  if (L < 1) return (int)cudaErrorInvalidValue;
  return fw_launch(kernel, wa, (float*)scratch, stream);
}
