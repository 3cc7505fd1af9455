// The b <= 128 body of K5 and K6 (fused_sweep.cu's header describes it), a
// template on the element type E of the window and of every output: float
// (fused_panel_f32.cu's entries) or bf16 (fused_panel_bf16.cu's), each its
// own translation unit, compiled beside the wide kernel of fused_sweep.cu.
//
// At bf16 every tensor the stepped route writes and a later kernel reads
// back (Y, T, R after the leaf; the butterfly's R, Y2 and T at each level;
// C and C' after the apply; each combine's C' halves and W) is a bf16
// tensor here too, stored rounded and read back widened, so each phase
// goes on from the rounded values, as the stepped route's next kernel
// does; with each phase's arithmetic that of K1-K4 (qr_common.cuh), the
// launch equals the stepped route bit for bit at bf16 as at float. The
// leaf's and the butterfly's G^T go to a float scratch (`gram`, P (b x b)),
// never to the bf16 T.
#pragma once
#include <cstdint>
#include <initializer_list>

#include "qr_common.cuh"

namespace repro {

static_assert(QR_THREADS == 2 * TILE_THREADS, "two apply tiles per block");

template <class E>
struct FusedArgs {
  const E* win;                 // window (P, m, w): lane stride w_bs, row stride w_ld
  long long w_bs, w_ld;
  const int* rs;                // (P,) row starts
  const unsigned char* active;  // (P,) lane flags; null = every lane active
  int P, m, w, b, L, t_lane;
  int bn;     // column tile of phases 3-4: 32, 64 or 128
  bool vec;   // accesses of four elements allowed in phases 3-4
  int C;      // leaf team size, team_blocks(m, b)
  bool slab_in_smem;  // the leaf slabs fit in shared memory
  E* leaf_Y;    // (P, m, b)
  E* leaf_T;    // (P, b, b)
  E* R_leaf;    // (P, b, b)
  E* R_carry;   // (P, b, b)           K6 only
  E* level_Y2;  // (L, P, b, b)        K6 only
  E* level_T;   // (L, P, b, b)        K6 only
  E* C_local;   // (P, m, w)
  E* C_prime;   // (P, b, w)
  E* Ws;        // (L, P, b, w)        K6 only
  E* Cs_self;   // (L, P, b, w)        K6 only
  E* Cs_buddy;  // (L, P, b, w)        K6 only
  float* work;  // scratch: P * C slabs when not in shared memory
  float* xch;   // scratch: each leaf block's exchange slots
  unsigned* arrivals;  // scratch: each team's barrier counter, zeroed
  E* Rtmp;      // scratch (L - 1, P, b, b), K6 only
  E* sink;      // scratch (b, w): combine outputs a lane does not keep
  float* gram;  // scratch (P, b, b) floats at bf16: G^T; unused at float
};

template <class E>
__device__ inline bool lane_active(const FusedArgs<E>& a, int p) {
  return a.active == nullptr || a.active[p] != 0;
}

// Phase 1: the masked leaf QR of every lane, lane p on team p % teams.
template <class E>
__device__ void leaf_phase(const FusedArgs<E>& a, float* smem) {
  const size_t mb = (size_t)a.m * a.b, bb = (size_t)a.b * a.b;
  const int teams = gridDim.x / a.C, team = blockIdx.x / a.C;
  const int rank = blockIdx.x % a.C;
  if (team >= teams) return;  // blocks past the last whole team
  GlobalExchange ex{smem, a.xch + (size_t)team * team_slots_floats(a.b), a.b,
                    a.C, rank, a.arrivals + team, 0u};
  const size_t slab = (size_t)team_cols(a.b) * team_ld(team_rows(a.m, a.C));
  for (int p = team; p < a.P; p += teams) {
    E* Y = a.leaf_Y + p * mb;
    E* T = a.leaf_T + p * bb;
    E* R = a.R_leaf + p * bb;
    float* G = gram_scratch(T, a.gram + p * bb);
    if (lane_active(a, p)) {
      const E* W = a.win + p * a.w_bs;
      if (a.slab_in_smem) {
        team_qr<true>(W, a.w_ld, Y, T, R, G, a.m, a.b, a.rs[p], a.C, rank,
                      nullptr, smem, ex);
      } else {
        team_qr<false>(W, a.w_ld, Y, T, R, G, a.m, a.b, a.rs[p], a.C, rank,
                       a.work + ((size_t)p * a.C + rank) * slab, smem, ex);
      }
    } else {  // every rank zeroes its rows of Y; rank 0 T and R
      const int rows = team_rows(a.m, a.C);
      const int lo = min(rank * rows, a.m), hi = min(lo + rows, a.m);
      for (size_t e = (size_t)lo * a.b + threadIdx.x; e < (size_t)hi * a.b;
           e += QR_THREADS)
        Y[e] = narrow<E>(0.f);
      if (rank == 0)
        for (size_t e = threadIdx.x; e < bb; e += QR_THREADS)
          T[e] = R[e] = narrow<E>(0.f);
    }
  }
}

// Phase 2, one level: the FT butterfly (core/tsqr.py::ft_tsqr_level).
template <class E>
__device__ void butterfly_phase(const FusedArgs<E>& a, int lvl, float* smem) {
  const size_t bb = (size_t)a.b * a.b, lvl_off = (size_t)lvl * a.P * bb;
  const E* Rin = lvl == 0 ? a.R_leaf : a.Rtmp + (size_t)(lvl - 1) * a.P * bb;
  E* Rout = lvl == a.L - 1 ? a.R_carry : a.Rtmp + lvl_off;
  const int group = 1 << lvl, t = a.t_lane;
  for (int p = blockIdx.x; p < a.P; p += gridDim.x) {
    const int buddy = p ^ group;
    const bool is_top = ((p >> lvl) & 1) == ((t >> lvl) & 1);
    const bool my_dead = (p & ~(group - 1)) + group <= t;
    const bool sib_dead = (buddy & ~(group - 1)) + group <= t;
    E* Y2 = a.level_Y2 + lvl_off + p * bb;
    E* T = a.level_T + lvl_off + p * bb;
    if (!my_dead && !sib_dead) {
      stacked_qr_lane(Rin + (is_top ? p : buddy) * bb,
                      Rin + (is_top ? buddy : p) * bb, Y2, T, Rout + p * bb,
                      gram_scratch(T, a.gram + p * bb), a.b, smem);
    } else {
      const E* src = Rin + (my_dead ? buddy : p) * bb;
      for (size_t e = threadIdx.x; e < bb; e += QR_THREADS) {
        Rout[p * bb + e] = src[e];
        Y2[e] = T[e] = narrow<E>(0.f);
      }
    }
  }
}

// Phase 3: C_local = Q_leaf^T window, and the C' rows of every lane. The
// two halves of a block take tiles on their own (named barriers 1 and 2).
template <int BN, bool VEC, class E>
__device__ void apply_phase(const FusedArgs<E>& a, float* smem) {
  const int half = threadIdx.x / TILE_THREADS, tid = threadIdx.x % TILE_THREADS;
  float* tsm = smem + half * (tile_smem_bytes<E>(BN) / (int)sizeof(float));
  const int nb = (a.w + BN - 1) / BN, ntiles = a.P * nb;
  const size_t mb = (size_t)a.m * a.b, bb = (size_t)a.b * a.b;
  const size_t mw = (size_t)a.m * a.w, bw = (size_t)a.b * a.w;
  E* cp_out = a.L > 0 ? a.Cs_self : a.C_prime;  // C' entering level 0
  for (int it = 2 * blockIdx.x + half; it < ntiles; it += 2 * gridDim.x) {
    const int p = it / nb, col0 = (it % nb) * BN;
    E* Cl = a.C_local + p * mw;
    wy_apply_tile<BN, VEC>(a.leaf_Y + p * mb, a.leaf_T + p * bb,
                           a.win + p * a.w_bs, a.w_ld, Cl, a.w, a.m, a.b, a.w,
                           col0, tid, 1 + half, tsm);
    // the tile's writes are visible to its threads after its last barrier
    const int r0 = min(max(a.rs[p], 0), a.m - a.b);
    const bool act = lane_active(a, p);
    E* dst = cp_out + p * bw;
    for (int e = tid; e < a.b * BN; e += TILE_THREADS) {
      const int r = e / BN, col = col0 + e % BN;
      if (col < a.w)
        dst[(size_t)r * a.w + col] =
            act ? Cl[(size_t)(r0 + r) * a.w + col] : narrow<E>(0.f);
    }
  }
}

// Phase 4, one level: the trailing combine
// (core/trailing.py::trailing_combine_level with dead_threshold = t_lane).
template <int BN, bool VEC, class E>
__device__ void combine_phase(const FusedArgs<E>& a, int lvl, float* smem) {
  const int half = threadIdx.x / TILE_THREADS, tid = threadIdx.x % TILE_THREADS;
  float* tsm = smem + half * (tile_smem_bytes<E>(BN) / (int)sizeof(float));
  const int nb = (a.w + BN - 1) / BN, ntiles = a.P * nb;
  const size_t bb = (size_t)a.b * a.b, bw = (size_t)a.b * a.w;
  const size_t lvl_bw = (size_t)lvl * a.P * bw, lvl_bb = (size_t)lvl * a.P * bb;
  const E* Cin = a.Cs_self + lvl_bw;
  E* Cout = lvl == a.L - 1 ? a.C_prime : a.Cs_self + lvl_bw + a.P * bw;
  const int t = a.t_lane;
  for (int it = 2 * blockIdx.x + half; it < ntiles; it += 2 * gridDim.x) {
    const int p = it / nb, col0 = (it % nb) * BN;
    const int buddy = p ^ (1 << lvl);
    const bool is_top = ((p >> lvl) & 1) == ((t >> lvl) & 1);
    const bool live = p >= t && buddy >= t;
    E* own = Cout + p * bw;
    E* Wo = a.Ws + lvl_bw + p * bw;
    // the tile writes all three outputs; what this lane does not keep goes
    // to the sink, which nothing reads
    stacked_apply_tile<BN, VEC>(
        a.level_Y2 + lvl_bb + p * bb, a.level_T + lvl_bb + p * bb,
        Cin + (is_top ? p : buddy) * bw, Cin + (is_top ? buddy : p) * bw, a.w,
        live && is_top ? own : a.sink, live && !is_top ? own : a.sink,
        live ? Wo : a.sink, a.b, a.w, col0, tid, 1 + half, tsm);
    E* Cb = a.Cs_buddy + lvl_bw + p * bw;
    for (int e = tid; e < a.b * BN; e += TILE_THREADS) {
      const size_t r = e / BN;
      const int col = col0 + e % BN;
      if (col >= a.w) continue;
      const size_t i = r * a.w + col;
      Cb[i] = Cin[buddy * bw + i];
      if (!live) {
        own[i] = Cin[p * bw + i];
        Wo[i] = narrow<E>(0.f);
      }
    }
  }
}

// Phases 3 and 4 at column tile BN, with vector accesses or without.
template <int BN, class E>
__device__ void tile_phases(const FusedArgs<E>& a, float* smem) {
  cg::grid_group grid = cg::this_grid();
  if (a.vec) apply_phase<BN, true>(a, smem);
  else apply_phase<BN, false>(a, smem);
  for (int lvl = 0; lvl < a.L; ++lvl) {
    grid.sync();
    if (a.vec) combine_phase<BN, true>(a, lvl, smem);
    else combine_phase<BN, false>(a, lvl, smem);
  }
}

template <class E>
__device__ void fused_body(const FusedArgs<E>& a, float* smem) {
  cg::grid_group grid = cg::this_grid();
  leaf_phase(a, smem);
  grid.sync();
  for (int lvl = 0; lvl < a.L; ++lvl) {
    butterfly_phase(a, lvl, smem);
    grid.sync();
  }
  switch (a.bn) {
    case 32: tile_phases<32>(a, smem); break;
    case 64: tile_phases<64>(a, smem); break;
    default: tile_phases<128>(a, smem); break;
  }
}

}  // namespace repro

// The kernels sit outside the namespace, so that their names in a profile
// and in ptxas's log are the bare ones the tools look for.
template <class E>
__global__ void __launch_bounds__(repro::QR_THREADS, 1)
panel_qr_apply_kernel(repro::FusedArgs<E> a) {
  extern __shared__ __align__(16) float smem[];
  repro::fused_body(a, smem);
}

template <class E>
__global__ void __launch_bounds__(repro::QR_THREADS, 1)
fused_panel_kernel(repro::FusedArgs<E> a) {
  extern __shared__ __align__(16) float smem[];
  repro::fused_body(a, smem);
}

namespace repro {

template <class E = float>
inline size_t fused_smem_bytes(int m, int b, int bn) {
  const int C = team_blocks(m, b);
  size_t f = team_smem_floats(m, b, C, team_slab_in_smem(m, b, C));
  f = f > stacked_smem_floats(b) ? f : stacked_smem_floats(b);
  const size_t tiles = 2 * (size_t)(tile_smem_bytes<E>(bn) / (int)sizeof(float));
  f = f > tiles ? f : tiles;
  return f * sizeof(float);
}

inline bool aligned_to(size_t bytes, std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if ((uintptr_t)p % bytes != 0) return false;
  return true;
}

// One cooperative launch of `kernel` on a persistent grid: as many blocks as
// fit on the card at once, but no more than the largest phase has work for
// (the leaf's P teams of C blocks, or a block per two apply tiles). The
// exchange scratch holds xch_blocks blocks' slots and as many counters.
template <class E>
int fused_launch(const void* kernel, FusedArgs<E>& a, int xch_blocks,
                 void* stream) {
  if (a.bn != 32 && a.bn != 64 && a.bn != 128) return (int)cudaErrorInvalidValue;
  if (a.C != team_blocks(a.m, a.b)) return (int)cudaErrorInvalidValue;
  a.slab_in_smem = team_slab_in_smem(a.m, a.b, a.C);
  constexpr int V = vec_elems<E>;
  a.vec = aligned_to(16, {a.win, a.leaf_Y, a.leaf_T, a.C_local, a.C_prime,
                          a.level_Y2, a.level_T, a.Ws, a.Cs_self, a.sink}) &&
          a.b % V == 0 && a.w % V == 0 && a.w_bs % V == 0 && a.w_ld % V == 0;
  const size_t smem = fused_smem_bytes<E>(a.m, a.b, a.bn);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      QR_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int tiles = a.P * ((a.w + a.bn - 1) / a.bn);
  int grid = (tiles + 1) / 2 > a.P * a.C ? (tiles + 1) / 2 : a.P * a.C;
  if (grid > per_sm * sms) grid = per_sm * sms;
  if (grid < a.C || grid > xch_blocks) return (int)cudaErrorInvalidValue;
  err = cudaMemsetAsync(a.arrivals, 0, (size_t)grid * sizeof(unsigned),
                        (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(QR_THREADS), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K5. W: P windows (m x w), lane stride w_bs and row stride w_ld in
// elements, unit column stride; rs: P int32 row starts (device). Y: P*m*b;
// T, R: P*b*b; C: P*m*w; Cp: P*b*w elements, all contiguous. bn: the column
// tile of the apply phase, 32, 64 or 128; team: the leaf team size,
// team_blocks(m, b). Scratch: work P * fused_sweep_work_floats; xch
// fused_sweep_xch_floats(b, xch_blocks) floats and arrivals xch_blocks
// unsigned, where xch_blocks is at least the grid (the card's SMs do);
// gram P*b*b floats at bf16 (unused at float).
template <class E>
int panel_qr_apply_entry(const void* W, long long w_bs, long long w_ld,
                         const void* rs, void* Y, void* T, void* R, void* C,
                         void* Cp, void* work, void* xch, void* arrivals,
                         void* gram, int xch_blocks, int P, int m, int w, int b,
                         int bn, int team, void* stream) {
  FusedArgs<E> a{};
  a.win = (const E*)W;
  a.w_bs = w_bs;
  a.w_ld = w_ld;
  a.rs = (const int*)rs;
  a.active = nullptr;
  a.P = P, a.m = m, a.w = w, a.b = b, a.L = 0, a.t_lane = 0, a.bn = bn;
  a.C = team;
  a.leaf_Y = (E*)Y, a.leaf_T = (E*)T, a.R_leaf = (E*)R;
  a.C_local = (E*)C, a.C_prime = (E*)Cp, a.work = (float*)work;
  a.xch = (float*)xch, a.arrivals = (unsigned*)arrivals;
  a.gram = (float*)gram;
  return fused_launch((const void*)panel_qr_apply_kernel<E>, a, xch_blocks,
                      stream);
}

// K6. W, rs as for K5; active: P uint8 lane flags (device); L >= 1 levels
// over P = 2^L lanes rooted at t_lane. Outputs as in FusedArgs, all
// contiguous; scratch: work, xch, arrivals and gram as for K5, Rtmp
// (L-1)*P*b*b and sink b*w elements. bn: the column tile of phases 3-4,
// 32, 64 or 128; team: the leaf team size, team_blocks(m, b).
template <class E>
int fused_panel_entry(const void* W, long long w_bs, long long w_ld,
                      const void* rs, const void* active, int P, int m, int w,
                      int b, int L, int t_lane, int bn, int team,
                      int xch_blocks, void* leaf_Y, void* leaf_T, void* R_leaf,
                      void* R_carry, void* level_Y2, void* level_T,
                      void* C_local, void* C_prime, void* Ws, void* Cs_self,
                      void* Cs_buddy, void* work, void* xch, void* arrivals,
                      void* Rtmp, void* sink, void* gram, void* stream) {
  FusedArgs<E> a{};
  a.win = (const E*)W;
  a.w_bs = w_bs;
  a.w_ld = w_ld;
  a.rs = (const int*)rs;
  a.active = (const unsigned char*)active;
  a.P = P, a.m = m, a.w = w, a.b = b, a.L = L, a.t_lane = t_lane, a.bn = bn;
  a.C = team;
  a.leaf_Y = (E*)leaf_Y, a.leaf_T = (E*)leaf_T;
  a.R_leaf = (E*)R_leaf, a.R_carry = (E*)R_carry;
  a.level_Y2 = (E*)level_Y2, a.level_T = (E*)level_T;
  a.C_local = (E*)C_local, a.C_prime = (E*)C_prime;
  a.Ws = (E*)Ws, a.Cs_self = (E*)Cs_self, a.Cs_buddy = (E*)Cs_buddy;
  a.work = (float*)work;
  a.xch = (float*)xch, a.arrivals = (unsigned*)arrivals;
  a.Rtmp = (E*)Rtmp, a.sink = (E*)sink, a.gram = (float*)gram;
  return fused_launch((const void*)fused_panel_kernel<E>, a, xch_blocks,
                      stream);
}

}  // namespace repro
