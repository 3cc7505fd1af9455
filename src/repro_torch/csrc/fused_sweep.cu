// K5: the fused per-lane leaf (panel QR + WY apply over the window + C'
// rows), and K6: the whole-panel megakernel of the FT-CAQR sweep.
//
// K5 replaces src/repro/kernels/fused_sweep.py::panel_qr_apply (body
// panel_qr_apply_math); K6 replaces fused_panel_pallas (body
// fused_panel_math, the sweep_step bodies of one panel concatenated).
//
// One cooperative launch of a persistent grid (as many 512-thread blocks as
// fit on the card at once), phases separated by grid-wide barriers:
//   1. leaf: masked panel QR of each lane on a team of C consecutive
//      blocks (K1's body, team_qr, with the same C as K1; lanes beyond the
//      teams that fit run in waves); inactive (consumed) lanes get zero
//      Y, T, R;
//   2. (K6 only) L butterfly levels: each lane reads its own and its
//      buddy's R from global memory into a stack in shared memory and QRs
//      it (K3's body, stacked_qr_lane), or passes through under the
//      group-activity masks of core/tsqr.py;
//   3. leaf apply: the window times Q^T over (lane, BN-column) tiles (K2's
//      body), and each tile copies its columns of the C' rows at the
//      clamped row_start (zero on inactive lanes);
//   4. (K6 only) L trailing combines over (lane, BN-column) tiles (K4's
//      body) with the is_top / pair_live selects of core/trailing.py.
// K5 is phases 1 and 3 with no lane masks.
//
// Fused == stepped, bit for bit: every element is computed by the same
// device functions as K1-K4 (qr_common.cuh) in the same order. Phase 1
// runs team_qr at 512 threads and team size C, as K1 does; its teams
// exchange their partial sums through global memory behind a per-team
// barrier (GlobalExchange) where K1 uses a cluster's distributed shared
// memory, and sum them in the same rank order. (A cooperative launch with
// clusters of 16 is refused on the H100: it holds 7 such clusters, not
// the 8 a grid of 128 blocks needs.) Phase 2 runs stacked_qr_lane on one
// 512-thread block a lane, as K3 does, whose sums depend on the thread
// layout. Phases 3-4 run two independent 256-thread tiles per block
// (each with its own shared memory and its own named barrier) through the
// register-tiled body of K2 and K4, whose every output element is one
// sequential fmaf chain in index order: what keeps the bits there is that
// order, not the layout, so the tile width BN may differ from the stepped
// launch's. Work that the stepped path computes and then masks away (QR of
// consumed lanes, stacked QR of dead groups) is skipped; the selected
// values are the same.
//
// What bounds it on the H100: the same as K1-K4 (the leaf's column loop,
// then FP32 FFMA in the apply). The design keeps the intermediates between
// phases in global memory (L2 at these sizes) and uses one 512-thread
// block per SM (a leaf team block needs 180 KB of shared memory at
// m = 4096, the butterfly's stack and T scratch 149 KB at b = 128, two
// BN = 128 tiles 192 KB), so each SM runs two apply tiles at a time, as
// the stepped K2 and K4 do at BN = 128. The grid holds at least P * C
// blocks where the card has room, so the leaf runs every lane's team at
// once.
#include <cstdint>
#include <initializer_list>

#include "qr_common.cuh"
#include "wide_common.cuh"
#include "wide_qr.cuh"

using namespace repro;

static_assert(QR_THREADS == 2 * TILE_THREADS, "two apply tiles per block");

struct FusedArgs {
  const float* win;             // window (P, m, w): lane stride w_bs, row stride w_ld
  long long w_bs, w_ld;
  const int* rs;                // (P,) row starts
  const unsigned char* active;  // (P,) lane flags; null = every lane active
  int P, m, w, b, L, t_lane;
  int bn;     // column tile of phases 3-4: 32, 64 or 128
  bool vec;   // 16-byte accesses allowed in phases 3-4
  int C;      // leaf team size, team_blocks(m, b)
  bool slab_in_smem;  // the leaf slabs fit in shared memory
  float* leaf_Y;    // (P, m, b)
  float* leaf_T;    // (P, b, b)
  float* R_leaf;    // (P, b, b)
  float* R_carry;   // (P, b, b)           K6 only
  float* level_Y2;  // (L, P, b, b)        K6 only
  float* level_T;   // (L, P, b, b)        K6 only
  float* C_local;   // (P, m, w)
  float* C_prime;   // (P, b, w)
  float* Ws;        // (L, P, b, w)        K6 only
  float* Cs_self;   // (L, P, b, w)        K6 only
  float* Cs_buddy;  // (L, P, b, w)        K6 only
  float* work;      // scratch: P * C slabs when not in shared memory
  float* xch;       // scratch: each leaf block's exchange slots
  unsigned* arrivals;  // scratch: each team's barrier counter, zeroed
  float* Rtmp;      // scratch (L - 1, P, b, b), K6 only
  float* sink;      // scratch (b, w): combine outputs a lane does not keep
};

__device__ inline bool lane_active(const FusedArgs& a, int p) {
  return a.active == nullptr || a.active[p] != 0;
}

// Phase 1: the masked leaf QR of every lane, lane p on team p % teams.
__device__ void leaf_phase(const FusedArgs& a, float* smem) {
  const size_t mb = (size_t)a.m * a.b, bb = (size_t)a.b * a.b;
  const int teams = gridDim.x / a.C, team = blockIdx.x / a.C;
  const int rank = blockIdx.x % a.C;
  if (team >= teams) return;  // blocks past the last whole team
  GlobalExchange ex{smem, a.xch + (size_t)team * team_slots_floats(a.b), a.b,
                    a.C, rank, a.arrivals + team, 0u};
  const size_t slab = (size_t)team_cols(a.b) * team_ld(team_rows(a.m, a.C));
  for (int p = team; p < a.P; p += teams) {
    float* Y = a.leaf_Y + p * mb;
    float* T = a.leaf_T + p * bb;
    float* R = a.R_leaf + p * bb;
    if (lane_active(a, p)) {
      const float* W = a.win + p * a.w_bs;
      if (a.slab_in_smem) {
        team_qr<true>(W, a.w_ld, Y, T, R, a.m, a.b, a.rs[p], a.C, rank,
                      nullptr, smem, ex);
      } else {
        team_qr<false>(W, a.w_ld, Y, T, R, a.m, a.b, a.rs[p], a.C, rank,
                       a.work + ((size_t)p * a.C + rank) * slab, smem, ex);
      }
    } else {  // every rank zeroes its rows of Y; rank 0 T and R
      const int rows = team_rows(a.m, a.C);
      const int lo = min(rank * rows, a.m), hi = min(lo + rows, a.m);
      for (size_t e = (size_t)lo * a.b + threadIdx.x; e < (size_t)hi * a.b;
           e += QR_THREADS)
        Y[e] = 0.f;
      if (rank == 0)
        for (size_t e = threadIdx.x; e < bb; e += QR_THREADS) T[e] = R[e] = 0.f;
    }
  }
}

// Phase 2, one level: the FT butterfly (core/tsqr.py::ft_tsqr_level).
__device__ void butterfly_phase(const FusedArgs& a, int lvl, float* smem) {
  const size_t bb = (size_t)a.b * a.b, lvl_off = (size_t)lvl * a.P * bb;
  const float* Rin = lvl == 0 ? a.R_leaf : a.Rtmp + (size_t)(lvl - 1) * a.P * bb;
  float* Rout = lvl == a.L - 1 ? a.R_carry : a.Rtmp + lvl_off;
  const int group = 1 << lvl, t = a.t_lane;
  for (int p = blockIdx.x; p < a.P; p += gridDim.x) {
    const int buddy = p ^ group;
    const bool is_top = ((p >> lvl) & 1) == ((t >> lvl) & 1);
    const bool my_dead = (p & ~(group - 1)) + group <= t;
    const bool sib_dead = (buddy & ~(group - 1)) + group <= t;
    float* Y2 = a.level_Y2 + lvl_off + p * bb;
    float* T = a.level_T + lvl_off + p * bb;
    if (!my_dead && !sib_dead) {
      stacked_qr_lane(Rin + (is_top ? p : buddy) * bb,
                      Rin + (is_top ? buddy : p) * bb, Y2, T, Rout + p * bb,
                      a.b, smem);
    } else {
      const float* src = Rin + (my_dead ? buddy : p) * bb;
      for (size_t e = threadIdx.x; e < bb; e += QR_THREADS) {
        Rout[p * bb + e] = src[e];
        Y2[e] = T[e] = 0.f;
      }
    }
  }
}

// Phase 3: C_local = Q_leaf^T window, and the C' rows of every lane. The
// two halves of a block take tiles on their own (named barriers 1 and 2).
template <int BN, bool VEC>
__device__ void apply_phase(const FusedArgs& a, float* smem) {
  const int half = threadIdx.x / TILE_THREADS, tid = threadIdx.x % TILE_THREADS;
  float* tsm = smem + half * tile_smem_floats(BN);
  const int nb = (a.w + BN - 1) / BN, ntiles = a.P * nb;
  const size_t mb = (size_t)a.m * a.b, bb = (size_t)a.b * a.b;
  const size_t mw = (size_t)a.m * a.w, bw = (size_t)a.b * a.w;
  float* cp_out = a.L > 0 ? a.Cs_self : a.C_prime;  // C' entering level 0
  for (int it = 2 * blockIdx.x + half; it < ntiles; it += 2 * gridDim.x) {
    const int p = it / nb, col0 = (it % nb) * BN;
    float* Cl = a.C_local + p * mw;
    wy_apply_tile<BN, VEC>(a.leaf_Y + p * mb, a.leaf_T + p * bb,
                           a.win + p * a.w_bs, a.w_ld, Cl, a.w, a.m, a.b, a.w,
                           col0, tid, 1 + half, tsm);
    // the tile's writes are visible to its threads after its last barrier
    const int r0 = min(max(a.rs[p], 0), a.m - a.b);
    const bool act = lane_active(a, p);
    float* dst = cp_out + p * bw;
    for (int e = tid; e < a.b * BN; e += TILE_THREADS) {
      const int r = e / BN, col = col0 + e % BN;
      if (col < a.w)
        dst[(size_t)r * a.w + col] = act ? Cl[(size_t)(r0 + r) * a.w + col] : 0.f;
    }
  }
}

// Phase 4, one level: the trailing combine
// (core/trailing.py::trailing_combine_level with dead_threshold = t_lane).
template <int BN, bool VEC>
__device__ void combine_phase(const FusedArgs& a, int lvl, float* smem) {
  const int half = threadIdx.x / TILE_THREADS, tid = threadIdx.x % TILE_THREADS;
  float* tsm = smem + half * tile_smem_floats(BN);
  const int nb = (a.w + BN - 1) / BN, ntiles = a.P * nb;
  const size_t bb = (size_t)a.b * a.b, bw = (size_t)a.b * a.w;
  const size_t lvl_bw = (size_t)lvl * a.P * bw, lvl_bb = (size_t)lvl * a.P * bb;
  const float* Cin = a.Cs_self + lvl_bw;
  float* Cout = lvl == a.L - 1 ? a.C_prime : a.Cs_self + lvl_bw + a.P * bw;
  const int t = a.t_lane;
  for (int it = 2 * blockIdx.x + half; it < ntiles; it += 2 * gridDim.x) {
    const int p = it / nb, col0 = (it % nb) * BN;
    const int buddy = p ^ (1 << lvl);
    const bool is_top = ((p >> lvl) & 1) == ((t >> lvl) & 1);
    const bool live = p >= t && buddy >= t;
    float* own = Cout + p * bw;
    float* Wo = a.Ws + lvl_bw + p * bw;
    // the tile writes all three outputs; what this lane does not keep goes
    // to the sink, which nothing reads
    stacked_apply_tile<BN, VEC>(
        a.level_Y2 + lvl_bb + p * bb, a.level_T + lvl_bb + p * bb,
        Cin + (is_top ? p : buddy) * bw, Cin + (is_top ? buddy : p) * bw, a.w,
        live && is_top ? own : a.sink, live && !is_top ? own : a.sink,
        live ? Wo : a.sink, a.b, a.w, col0, tid, 1 + half, tsm);
    float* Cb = a.Cs_buddy + lvl_bw + p * bw;
    for (int e = tid; e < a.b * BN; e += TILE_THREADS) {
      const size_t r = e / BN;
      const int col = col0 + e % BN;
      if (col >= a.w) continue;
      const size_t i = r * a.w + col;
      Cb[i] = Cin[buddy * bw + i];
      if (!live) {
        own[i] = Cin[p * bw + i];
        Wo[i] = 0.f;
      }
    }
  }
}

// Phases 3 and 4 at column tile BN, with 16-byte accesses or without.
template <int BN>
__device__ void tile_phases(const FusedArgs& a, float* smem) {
  cg::grid_group grid = cg::this_grid();
  if (a.vec) apply_phase<BN, true>(a, smem);
  else apply_phase<BN, false>(a, smem);
  for (int lvl = 0; lvl < a.L; ++lvl) {
    grid.sync();
    if (a.vec) combine_phase<BN, true>(a, lvl, smem);
    else combine_phase<BN, false>(a, lvl, smem);
  }
}

__device__ void fused_body(const FusedArgs& a, float* smem) {
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

__global__ void __launch_bounds__(QR_THREADS, 1)
panel_qr_apply_kernel(FusedArgs a) {
  extern __shared__ __align__(16) float smem[];
  fused_body(a, smem);
}

__global__ void __launch_bounds__(QR_THREADS, 1)
fused_panel_kernel(FusedArgs a) {
  extern __shared__ __align__(16) float smem[];
  fused_body(a, smem);
}

static size_t fused_smem_bytes(int m, int b, int bn) {
  const int C = team_blocks(m, b);
  size_t f = team_smem_floats(m, b, C, team_slab_in_smem(m, b, C));
  f = f > stacked_smem_floats(b) ? f : stacked_smem_floats(b);
  const size_t tiles = 2 * (size_t)tile_smem_floats(bn);
  f = f > tiles ? f : tiles;
  return f * sizeof(float);
}

extern "C" size_t fused_sweep_smem_bytes(int m, int b, int bn) {
  return fused_smem_bytes(m, b, bn);
}

// Blocks of K6 an SM holds at once at the shared memory of an (m x b)
// panel and column tile bn.
extern "C" int fused_panel_blocks_per_sm(int m, int b, int bn, int* out) {
  const size_t smem = fused_smem_bytes(m, b, bn);
  cudaError_t err = cudaFuncSetAttribute(
      fused_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fused_panel_kernel, QR_THREADS, smem);
}

static bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16 != 0) return false;
  return true;
}

// Floats of leaf scratch (the global slabs) a lane needs: 0 when the slabs
// fit in shared memory.
extern "C" size_t fused_sweep_work_floats(int m, int b, int C) {
  return team_slab_in_smem(m, b, C) ? 0 : team_work_floats(m, b, C);
}

// Floats of exchange scratch for a grid of at most `blocks` blocks in teams
// of C (a team's slots each).
extern "C" size_t fused_sweep_xch_floats(int b, int C, int blocks) {
  return (size_t)(blocks + C - 1) / C * team_slots_floats(b);
}

// One cooperative launch of `kernel` on a persistent grid: as many blocks as
// fit on the card at once, but no more than the largest phase has work for
// (the leaf's P teams of C blocks, or a block per two apply tiles). The
// exchange scratch holds xch_blocks blocks' slots and as many counters.
static int launch(const void* kernel, FusedArgs& a, int xch_blocks,
                  void* stream) {
  if (a.bn != 32 && a.bn != 64 && a.bn != 128) return (int)cudaErrorInvalidValue;
  if (a.C != team_blocks(a.m, a.b)) return (int)cudaErrorInvalidValue;
  a.slab_in_smem = team_slab_in_smem(a.m, a.b, a.C);
  a.vec = aligned16({a.win, a.leaf_Y, a.leaf_T, a.C_local, a.C_prime,
                     a.level_Y2, a.level_T, a.Ws, a.Cs_self, a.sink}) &&
          a.b % 4 == 0 && a.w % 4 == 0 && a.w_bs % 4 == 0 && a.w_ld % 4 == 0;
  const size_t smem = fused_smem_bytes(a.m, a.b, a.bn);
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

// K5. W: P windows (m x w), lane stride w_bs and row stride w_ld in floats,
// unit column stride; rs: P int32 row starts (device). Y: P*m*b; T, R:
// P*b*b; C: P*m*w; Cp: P*b*w floats, all contiguous. bn: the column tile of
// the apply phase, 32, 64 or 128; team: the leaf team size,
// team_blocks(m, b). Scratch: work P * fused_sweep_work_floats; xch
// fused_sweep_xch_floats(b, xch_blocks) floats and arrivals xch_blocks
// unsigned, where xch_blocks is at least the grid (the card's SMs do).
extern "C" int panel_qr_apply_f32(const void* W, long long w_bs, long long w_ld,
                                  const void* rs, void* Y, void* T, void* R,
                                  void* C, void* Cp, void* work, void* xch,
                                  void* arrivals, int xch_blocks, int P, int m,
                                  int w, int b, int bn, int team, void* stream) {
  FusedArgs a{};
  a.win = (const float*)W;
  a.w_bs = w_bs;
  a.w_ld = w_ld;
  a.rs = (const int*)rs;
  a.active = nullptr;
  a.P = P, a.m = m, a.w = w, a.b = b, a.L = 0, a.t_lane = 0, a.bn = bn;
  a.C = team;
  a.leaf_Y = (float*)Y, a.leaf_T = (float*)T, a.R_leaf = (float*)R;
  a.C_local = (float*)C, a.C_prime = (float*)Cp, a.work = (float*)work;
  a.xch = (float*)xch, a.arrivals = (unsigned*)arrivals;
  return launch((const void*)panel_qr_apply_kernel, a, xch_blocks, stream);
}

// K6. W, rs as for K5; active: P uint8 lane flags (device); L >= 1 levels
// over P = 2^L lanes rooted at t_lane. Outputs as in FusedArgs, all
// contiguous; scratch: work, xch and arrivals as for K5, Rtmp
// (L-1)*P*b*b, sink b*w. bn: the column tile of phases 3-4,
// 32, 64 or 128; team: the leaf team size, team_blocks(m, b).
extern "C" int fused_panel_f32(const void* W, long long w_bs, long long w_ld,
                               const void* rs, const void* active, int P, int m,
                               int w, int b, int L, int t_lane, int bn,
                               int team, int xch_blocks, void* leaf_Y,
                               void* leaf_T, void* R_leaf, void* R_carry,
                               void* level_Y2, void* level_T, void* C_local,
                               void* C_prime, void* Ws, void* Cs_self,
                               void* Cs_buddy, void* work, void* xch,
                               void* arrivals, void* Rtmp, void* sink,
                               void* stream) {
  FusedArgs a{};
  a.win = (const float*)W;
  a.w_bs = w_bs;
  a.w_ld = w_ld;
  a.rs = (const int*)rs;
  a.active = (const unsigned char*)active;
  a.P = P, a.m = m, a.w = w, a.b = b, a.L = L, a.t_lane = t_lane, a.bn = bn;
  a.C = team;
  a.leaf_Y = (float*)leaf_Y, a.leaf_T = (float*)leaf_T;
  a.R_leaf = (float*)R_leaf, a.R_carry = (float*)R_carry;
  a.level_Y2 = (float*)level_Y2, a.level_T = (float*)level_T;
  a.C_local = (float*)C_local, a.C_prime = (float*)C_prime;
  a.Ws = (float*)Ws, a.Cs_self = (float*)Cs_self, a.Cs_buddy = (float*)Cs_buddy;
  a.work = (float*)work;
  a.xch = (float*)xch, a.arrivals = (unsigned*)arrivals;
  a.Rtmp = (float*)Rtmp, a.sink = (float*)sink;
  return launch((const void*)fused_panel_kernel, a, xch_blocks, stream);
}

// -- K5 and K6 above 128 columns ---------------------------------------------
//
// The same phases in one cooperative launch of clusters (wide_qr.cuh), each
// running the blocked routes of kernels/wide.py in-kernel, with grid
// barriers between their steps:
//   1. leaf: blocked_qr on W[:, :b] (wide_qr.cuh): team phases on the
//      cluster exchange, the T join and the apply between sub-panels as
//      grid-wide tile phases; inactive lanes get zero Y, T, R;
//   2. (K6) each butterfly level: a live lane stacks [triu(R_top);
//      triu(R_bot)] and runs phase 1's blocked QR on the (2b x b) stack at row
//      start 0 (stacked_qr_wide), Y2 = triu(Y[b:]); the group-activity masks
//      of core/tsqr.py as at b <= 128;
//   3. leaf apply: C_local = W - Y (T^T (Y^T W)) as wy_apply_wide's three
//      products, and the C' rows at the clamped row start (zero on inactive
//      lanes);
//   4. (K6) each combine: stacked_apply_wide's three products (inner = Ct +
//      Y2^T Cb; W = T^T inner with the second store Ct - W; Cb - Y2 W) for
//      the live pairs, with the is_top / pair_live selects of
//      core/trailing.py.
// Every product runs the tile routine of wide_common.cuh in the order that
// wide_gemm runs: fused == stepped by construction. Intermediates (the
// sub-panels' factors, the remaining columns, the products' Z and W, the
// stacks) live in global scratch that the wrapper allocates. The team
// phases exchange through global memory (GlobalTeams in wide_qr.cuh), each
// phase with its own arrival counters: at 8 lanes of 4096 rows the grid of
// 132 blocks runs all 8 leaf teams of 16 at once, where a launch of
// clusters of 16 (7 on the card, 112 blocks) ran them in two waves and
// took longer (PERF.md).

struct WideArgs {
  FusedArgs a;
  WideQR q;
  int xch_blocks;  // arrival counters a team phase
};

// The team phases of a launch: the leaf's sub-panels, and each butterfly
// level's.
__host__ __device__ inline int fw_team_phases(int b, int L) {
  return cdiv(b, FW_NB) * (1 + L);
}

// The element-wise steps of the wide phases, by rows (grid_rows), each out
// of line so that its code stays out of the tile phases' register budget.
__device__ inline bool wide_dead(int p, int group, int t) {
  return (p & ~(group - 1)) + group <= t;
}

// Level lvl's stacks [triu(R_top); triu(R_bot)] of the live lanes, and the
// pass-through of the others (R, and zero Y2 and T).
__device__ __noinline__ void wide_stacks(const WideArgs& wa, int lvl) {
  const FusedArgs& a = wa.a;
  const int b = a.b, t = a.t_lane, group = 1 << lvl;
  const size_t bb = (size_t)b * b, lvl_off = (size_t)lvl * a.P * bb;
  const float* Rin = lvl == 0 ? a.R_leaf : a.Rtmp + (size_t)(lvl - 1) * a.P * bb;
  float* Rout = lvl == a.L - 1 ? a.R_carry : a.Rtmp + lvl_off;
  float* stack = wa.q.s.stack + (size_t)lvl * a.P * 2 * bb;
  grid_rows(a.P * 2 * b, [&](int row, int lane) {
    const int p = row / (2 * b), q = row % (2 * b), buddy = p ^ group;
    if (!wide_dead(p, group, t) && !wide_dead(buddy, group, t)) {
      const bool is_top = ((p >> lvl) & 1) == ((t >> lvl) & 1);
      const bool low = q >= b;  // the bottom triangle
      const int r = q % b, src = (is_top != low) ? p : buddy;
      for (int c = lane; c < b; c += 32)
        stack[(size_t)row * b + c] =
            r > c ? 0.f : __ldcg(Rin + src * bb + (size_t)r * b + c);
    } else if (q < b) {
      const int from = wide_dead(p, group, t) ? buddy : p;
      const size_t o = p * bb + (size_t)q * b;
      for (int c = lane; c < b; c += 32) {
        Rout[o + c] = __ldcg(Rin + from * bb + (size_t)q * b + c);
        a.level_Y2[lvl_off + o + c] = 0.f;
        a.level_T[lvl_off + o + c] = 0.f;
      }
    }
  });
}

// Level lvl's Y2 = triu(Y[b:]) of the live lanes.
__device__ __noinline__ void wide_y2(const WideArgs& wa, int lvl) {
  const FusedArgs& a = wa.a;
  const int b = a.b, t = a.t_lane, group = 1 << lvl;
  const size_t bb = (size_t)b * b, lvl_off = (size_t)lvl * a.P * bb;
  grid_rows(a.P * b, [&](int row, int lane) {
    const int p = row / b, r = row % b;
    if (wide_dead(p, group, t) || wide_dead(p ^ group, group, t)) return;
    for (int c = lane; c < b; c += 32)
      a.level_Y2[lvl_off + (size_t)row * b + c] =
          r > c ? 0.f : __ldcg(wa.q.s.Ys + p * 2 * bb + bb + (size_t)r * b + c);
  });
}

// The C' rows entering level 0 (or K5's C'): rows [r0, r0 + b) of
// C_local at the clamped row start, zero on inactive lanes.
__device__ __noinline__ void wide_cprime(const WideArgs& wa) {
  const FusedArgs& a = wa.a;
  const int m = a.m, b = a.b, w = a.w;
  const size_t mw = (size_t)m * w;
  float* cp_out = a.L > 0 ? a.Cs_self : a.C_prime;
  grid_rows(a.P * b, [&](int row, int lane) {
    const int p = row / b, r = row % b;
    const int r0 = min(max(a.rs[p], 0), m - b);
    const bool act = lane_active(a, p);
    for (int col = lane; col < w; col += 32)
      cp_out[(size_t)row * w + col] =
          act ? __ldcg(a.C_local + p * mw + (size_t)(r0 + r) * w + col) : 0.f;
  });
}

// Combine lvl's copies: the buddy's C', and for the lanes whose pair is
// not live the pass-through C' and a zero W.
__device__ __noinline__ void wide_combine_copies(const WideArgs& wa, int lvl) {
  const FusedArgs& a = wa.a;
  const int b = a.b, w = a.w, t = a.t_lane;
  const size_t bw = (size_t)b * w, lvl_bw = (size_t)lvl * a.P * bw;
  const float* Cin = a.Cs_self + lvl_bw;
  float* Cout = lvl == a.L - 1 ? a.C_prime : a.Cs_self + lvl_bw + a.P * bw;
  grid_rows(a.P * b, [&](int row, int lane) {
    const int p = row / b, buddy = p ^ (1 << lvl);
    const size_t e0 = (size_t)row * w, i0 = e0 - p * bw;
    const bool dead = !(p >= t && buddy >= t);
    for (int col = lane; col < w; col += 32) {
      a.Cs_buddy[lvl_bw + e0 + col] = __ldcg(Cin + buddy * bw + i0 + col);
      if (dead) {
        Cout[e0 + col] = __ldcg(Cin + e0 + col);
        a.Ws[lvl_bw + e0 + col] = 0.f;
      }
    }
  });
}

// Phase 2 above 128, one level: the FT butterfly on the blocked QR of the
// stacks.
__device__ void wide_butterfly(const WideArgs& wa, int lvl, GlobalTeams& teams,
                               float* smem) {
  const FusedArgs& a = wa.a;
  const WideScratch& s = wa.q.s;
  const int b = a.b, t = a.t_lane, group = 1 << lvl;
  const size_t bb = (size_t)b * b, lvl_off = (size_t)lvl * a.P * bb;
  float* Rout = lvl == a.L - 1 ? a.R_carry : a.Rtmp + lvl_off;
  float* stack = s.stack + (size_t)lvl * a.P * 2 * bb;
  float* cur = s.cur + (size_t)a.P * ((size_t)a.m + (size_t)lvl * 2 * b) * fw_cur_ld(b);
  auto live = [&](int p) {
    return !wide_dead(p, group, t) && !wide_dead(p ^ group, group, t);
  };
  wide_stacks(wa, lvl);
  grid_barrier(wa.q.bar);
  blocked_qr(
      wa.q, teams, 2 * b, b, live,
      [&](int p) -> const float* { return stack + p * 2 * bb; },
      b, [](int) { return 0; }, s.Ys, 2 * bb, a.level_T + lvl_off, Rout, cur,
      false, smem);
  wide_y2(wa, lvl);
  grid_barrier(wa.q.bar);
}

// Phase 3 above 128: C_local = W - Y (T^T (Y^T W)) on every lane, then the
// C' rows.
__device__ void wide_apply(const WideArgs& wa, float* smem) {
  const FusedArgs& a = wa.a;
  const WideScratch& s = wa.q.s;
  const int m = a.m, b = a.b, w = a.w;
  const size_t mb = (size_t)m * b, bb = (size_t)b * b, mw = (size_t)m * w,
               bw = (size_t)b * w;
  tile_phase(prod([&](int p, GemmView& v) {
    v = gemm_view(b, w, m, a.leaf_Y + p * mb, 1, b, a.win + p * a.w_bs, a.w_ld,
                  nullptr, 0, s.Z + p * bw, w, 0);
    return true;
  }, a.P, b, w, m), smem, wa.q.bar);
  grid_barrier(wa.q.bar);
  tile_phase(prod([&](int p, GemmView& v) {
    v = gemm_view(b, w, b, a.leaf_T + p * bb, 1, b, s.Z + p * bw, w, nullptr, 0,
                  s.Wm + p * bw, w, 0);
    return true;
  }, a.P, b, w, b), smem, wa.q.bar);
  grid_barrier(wa.q.bar);
  tile_phase(prod([&](int p, GemmView& v) {
    v = gemm_view(m, w, b, a.leaf_Y + p * mb, b, 1, s.Wm + p * bw, w,
                  a.win + p * a.w_bs, a.w_ld, a.C_local + p * mw, w, 1);
    return true;
  }, a.P, m, w, b), smem, wa.q.bar);
  grid_barrier(wa.q.bar);
  wide_cprime(wa);
}

// Phase 4 above 128, one level: the trailing combine
// (core/trailing.py::trailing_combine_level with dead_threshold = t_lane).
__device__ void wide_combine(const WideArgs& wa, int lvl, float* smem) {
  const FusedArgs& a = wa.a;
  const WideScratch& s = wa.q.s;
  const int b = a.b, w = a.w, t = a.t_lane;
  const size_t bb = (size_t)b * b, bw = (size_t)b * w;
  const size_t lvl_bw = (size_t)lvl * a.P * bw, lvl_bb = (size_t)lvl * a.P * bb;
  const float* Cin = a.Cs_self + lvl_bw;
  float* Cout = lvl == a.L - 1 ? a.C_prime : a.Cs_self + lvl_bw + a.P * bw;
  auto buddy = [&](int p) { return p ^ (1 << lvl); };
  auto is_top = [&](int p) { return ((p >> lvl) & 1) == ((t >> lvl) & 1); };
  auto live = [&](int p) { return p >= t && buddy(p) >= t; };
  auto top = [&](int p) { return Cin + (is_top(p) ? p : buddy(p)) * bw; };
  auto bot = [&](int p) { return Cin + (is_top(p) ? buddy(p) : p) * bw; };
  // inner = Ct + Y2^T Cb
  tile_phase(prod([&](int p, GemmView& v) {
    v = gemm_view(b, w, b, a.level_Y2 + lvl_bb + p * bb, 1, b, bot(p), w,
                  top(p), w, s.Z + p * bw, w, 0);
    return live(p);
  }, a.P, b, w, b), smem, wa.q.bar);
  grid_barrier(wa.q.bar);
  // W = T^T inner, and on the top lane Ct - W; the buddy's C' and the
  // pass-through of the lanes whose pair is not live
  tile_phase(prod([&](int p, GemmView& v) {
    v = gemm_view(b, w, b, a.level_T + lvl_bb + p * bb, 1, b, s.Z + p * bw, w,
                  nullptr, 0, a.Ws + lvl_bw + p * bw, w, 0);
    if (is_top(p)) {
      v.E = top(p), v.e_rs = w, v.e_cs = 1;
      v.O2 = Cout + p * bw, v.o2_rs = w, v.o2_cs = 1;
    }
    return live(p);
  }, a.P, b, w, b), smem, wa.q.bar);
  wide_combine_copies(wa, lvl);
  grid_barrier(wa.q.bar);
  // the bottom lane: Cb - Y2 W
  tile_phase(prod([&](int p, GemmView& v) {
    v = gemm_view(b, w, b, a.level_Y2 + lvl_bb + p * bb, b, 1,
                  a.Ws + lvl_bw + p * bw, w, bot(p), w, Cout + p * bw, w, 1);
    return live(p) && !is_top(p);
  }, a.P, b, w, b), smem, wa.q.bar);
}

__global__ void __launch_bounds__(QR_THREADS, 1)
fused_wide_kernel(const __grid_constant__ WideArgs wa) {
  extern __shared__ __align__(16) float smem[];
  const FusedArgs& a = wa.a;
  const size_t mb = (size_t)a.m * a.b;
  GlobalTeams teams{a.xch, a.arrivals, wa.xch_blocks, 0};
  blocked_qr(
      wa.q, teams, a.m, a.b, [&](int p) { return lane_active(a, p); },
      [&](int p) -> const float* { return a.win + p * a.w_bs; }, a.w_ld,
      [&](int p) { return a.rs[p]; }, a.leaf_Y, mb, a.leaf_T, a.R_leaf,
      wa.q.s.cur, true, smem);
  for (int lvl = 0; lvl < a.L; ++lvl) wide_butterfly(wa, lvl, teams, smem);
  wide_apply(wa, smem);
  for (int lvl = 0; lvl < a.L; ++lvl) {
    grid_barrier(wa.q.bar);
    wide_combine(wa, lvl, smem);
  }
}

// The product of wide_gemm_f32 (without split) through K5/K6's in-block
// instantiation: 512-thread blocks, one tile a block on warpgroups 0-1
// under setmaxnreg (tests only; a plain launch, not cooperative).
__global__ void __launch_bounds__(QR_THREADS, 1) fused_gemm_kernel(GemmArgs g) {
  extern __shared__ __align__(16) float smem[];
  tile_phase(prod([&](int p, GemmView& v) {
    v = g.lane(p);
    return true;
  }, g.P, g.v.M, g.v.N, g.v.K), smem, nullptr);
}

extern "C" int fused_gemm_f32(GEMM_PARAMS, void* stream) {
  if (P < 1) return (int)cudaErrorInvalidValue;
  const GemmArgs g = make_args(GEMM_ARGS);
  const size_t smem = (size_t)WideTile::SMEM * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if ((err = fw_check_regs((const void*)fused_gemm_kernel)) != cudaSuccess)
    return (int)err;
  const int items = P * cdiv(M, WideTile::BM) * cdiv(N, WideTile::BN);
  const int blocks = min(items, 1024);
  if (blocks == 0) return 0;
  fused_gemm_kernel<<<blocks, QR_THREADS, smem, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// Above 128 columns: shared memory of a block (the largest phase), the
// leaf's global slabs a lane, the scratch of P lanes, and the team phases
// (arrival counter rows) of K5 (L = 0) and K6.
extern "C" size_t fused_wide_smem_bytes(int m, int b, int L) {
  return fw_smem_floats(m, b, L > 0) * sizeof(float);
}

extern "C" size_t fused_wide_work_floats(int m, int b, int L) {
  return fw_team_floats(m, b, L > 0, true);
}

extern "C" size_t fused_wide_scratch_floats(int P, int m, int w, int b, int L) {
  return fw_scratch_floats(P, m, w, b, L, nullptr, nullptr) + FW_BAR_FLOATS;
}

extern "C" int fused_wide_team_phases(int b, int L) { return fw_team_phases(b, L); }

// Blocks of the wide kernel an SM holds at once at that shared memory.
extern "C" int fused_wide_blocks_per_sm(int m, int b, int L, int* out) {
  const size_t smem = fused_wide_smem_bytes(m, b, L);
  cudaError_t err = cudaFuncSetAttribute(
      fused_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fused_wide_kernel, QR_THREADS, smem);
}

// One cooperative launch of the wide kernel on every block the card holds
// at once (at most xch_blocks).
static int launch_wide(WideArgs& wa, float* scratch, void* stream) {
  FusedArgs& a = wa.a;
  if (a.b <= FW_NB) return (int)cudaErrorInvalidValue;
  const size_t off = fw_scratch_floats(a.P, a.m, a.w, a.b, a.L, &wa.q.s, scratch);
  wa.q.bar = (unsigned*)(scratch + off);
  wa.q.yj_bs = (size_t)fw_mm(a.m, a.b, a.L > 0) * FW_NB;
  wa.q.work = a.work;
  wa.q.P = a.P;
  const size_t smem = fused_wide_smem_bytes(a.m, a.b, a.L);
  cudaError_t err = cudaFuncSetAttribute(
      fused_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if ((err = fw_check_regs((const void*)fused_wide_kernel)) != cudaSuccess)
    return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_wide_kernel,
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
  err = cudaLaunchCooperativeKernel((const void*)fused_wide_kernel, dim3(grid),
                                    dim3(QR_THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K5 above 128 columns: as panel_qr_apply_f32, with work
// P * fused_wide_work_floats(m, b, 0) floats, xch fused_sweep_xch_floats(128,
// 1, xch_blocks) floats, arrivals fused_wide_team_phases(b, 0) * xch_blocks
// unsigned and scratch fused_wide_scratch_floats(P, m, w, b, 0) floats.
extern "C" int panel_qr_apply_wide_f32(const void* W, long long w_bs,
                                       long long w_ld, const void* rs, void* Y,
                                       void* T, void* R, void* C, void* Cp,
                                       void* work, void* xch, void* arrivals,
                                       int xch_blocks, void* scratch, int P,
                                       int m, int w, int b, void* stream) {
  WideArgs wa{};
  FusedArgs& a = wa.a;
  a.win = (const float*)W, a.w_bs = w_bs, a.w_ld = w_ld;
  a.rs = (const int*)rs, a.active = nullptr;
  a.P = P, a.m = m, a.w = w, a.b = b, a.L = 0, a.t_lane = 0;
  a.leaf_Y = (float*)Y, a.leaf_T = (float*)T, a.R_leaf = (float*)R;
  a.C_local = (float*)C, a.C_prime = (float*)Cp, a.work = (float*)work;
  a.xch = (float*)xch, a.arrivals = (unsigned*)arrivals;
  wa.xch_blocks = xch_blocks;
  return launch_wide(wa, (float*)scratch, stream);
}

// K6 above 128 columns: as fused_panel_f32 (no sink), with work, xch,
// arrivals and scratch as for K5 at this L.
extern "C" int fused_panel_wide_f32(
    const void* W, long long w_bs, long long w_ld, const void* rs,
    const void* active, int P, int m, int w, int b, int L, int t_lane,
    int xch_blocks, void* leaf_Y, void* leaf_T, void* R_leaf, void* R_carry,
    void* level_Y2, void* level_T, void* C_local, void* C_prime, void* Ws,
    void* Cs_self, void* Cs_buddy, void* work, void* xch, void* arrivals,
    void* Rtmp, void* scratch, void* stream) {
  WideArgs wa{};
  FusedArgs& a = wa.a;
  a.win = (const float*)W, a.w_bs = w_bs, a.w_ld = w_ld;
  a.rs = (const int*)rs, a.active = (const unsigned char*)active;
  a.P = P, a.m = m, a.w = w, a.b = b, a.L = L, a.t_lane = t_lane;
  a.leaf_Y = (float*)leaf_Y, a.leaf_T = (float*)leaf_T;
  a.R_leaf = (float*)R_leaf, a.R_carry = (float*)R_carry;
  a.level_Y2 = (float*)level_Y2, a.level_T = (float*)level_T;
  a.C_local = (float*)C_local, a.C_prime = (float*)C_prime;
  a.Ws = (float*)Ws, a.Cs_self = (float*)Cs_self, a.Cs_buddy = (float*)Cs_buddy;
  a.work = (float*)work, a.xch = (float*)xch, a.arrivals = (unsigned*)arrivals;
  a.Rtmp = (float*)Rtmp;
  wa.xch_blocks = xch_blocks;
  if (L < 1) return (int)cudaErrorInvalidValue;
  return launch_wide(wa, (float*)scratch, stream);
}
