// The blocked QR above 128 columns in one cooperative launch: the building
// block of K1's wide launch (panel_qr_wide.cu), of K3's wide route (K1's
// launch on the stacked triangles) and of K5/K6's wide kernel
// (fused_sweep.cu). It runs kernels/wide.py::panel_qr_blocked in-kernel:
// per 128-column sub-panel j,
//   1. team phase: team_qr at row start rs + c0 on each lane's team of
//      team_blocks(m, b_j) blocks, the team K1's b <= 128 launch gives a
//      sub-panel;
//   2. the sub-panel's Y, T and R columns (R by the clamp rule);
//   3. the T join T[:c0, c0:] = -T[:c0, :c0] (Y[:, :c0]^T Y_j) T_j and the
//      apply of Q_j^T to the columns right of it, three grid-wide tile
//      phases of two independent products each,
// with grid barriers between the steps. Every product runs the tile
// routine of wide_common.cuh, whose order is the contract, so the launch
// equals the composed route (K1's team launch a sub-panel, wide_gemm
// between them) bit for bit.
//
// Two ways to run the team phases, with the same arithmetic:
//   * ClusterTeams (K1's wide launch): a cooperative launch of clusters of
//     CS blocks, CS the largest team of the launch, as many clusters as the
//     card holds at once (wide_launch); the team exchanges through the
//     cluster's distributed shared memory, as K1's b <= 128 launch does. A
//     sub-panel whose team C is smaller than CS runs CS / C teams a
//     cluster, whose column barriers are the cluster's.
//   * GlobalTeams (K5/K6's wide kernel, and K1's where one round of
//     clusters cannot take every lane's team): teams of C consecutive
//     blocks of a plain cooperative grid exchange through global memory
//     behind an arrival counter (GlobalExchange). At 8 lanes of 4096 rows
//     it runs every lane's team of 16 at once on 128 blocks, where the card
//     holds only 7 clusters of 16.
// Two rounds of lanes in a row on one team are separated by one more team
// barrier, so that the second round's first sums never overwrite slots a
// slower block still reads.
//
// Coherence: L1 is not coherent across SMs within a launch, so every read
// here of data written earlier in the launch bypasses it (__ldcg, and
// cp.async.cg in the tile routine), except team_qr's plain reads of its
// panel, which is the input (never written), or a region that was written
// once before anyone read it: each blocked QR's remaining columns (rows
// padded to 32 floats, so no cache line spans two sub-panels) and each
// stack have their own scratch.
//
// Products run wide_gemm's 128 x 128 tile (8 x 8 outputs a thread, the
// total in shared memory) on the block's warpgroups 0-1, one tile a block.
// The 512-thread block has 128 registers a thread; for the phase
// warpgroups 0-1 take 232 of them with Hopper's setmaxnreg and warpgroups
// 2-3 give theirs back down to 24, waiting at a named barrier, and all
// four return to 128 before the phase ends (each branch on its own, so
// that the code after the phase is compiled at 128). The launch checks that
// the kernel has exactly 128 registers a thread, the pool this trade
// assumes. The deep, narrow products of the T join and of the apply
// between sub-panels (k over the m rows, a 128 x 128 output) split k into
// block sums, each its own item, and a second step adds them in block
// order (wide_gemm's split).
#pragma once
#include "qr_common.cuh"
#include "wide_common.cuh"

namespace repro {

using WideTile = GemmTile<128, 128, 8, 8, 4, true>;
constexpr int FW_NB = QR_MAX_B;  // columns of a sub-panel
constexpr int FW_BLOCKS = 132;   // the split's target: the H100's SMs, a
                                 // block each (a constant of the design)
constexpr int FW_SPLIT_MIN = 2;  // block sums a sum needs before it splits
constexpr int FW_LOOKAHEAD = 32;  // idle blocks a team phase needs to take
                                  // the last sub-panel's far columns
constexpr int FW_REGS = 128;     // registers a thread of the 512-thread block
constexpr int FW_TILE_REGS = 232, FW_IDLE_REGS = 24;  // during a tile phase
static_assert(2 * FW_TILE_REGS + 2 * FW_IDLE_REGS == 4 * FW_REGS,
              "the tile phase trades registers within the block's pool");

// Hopper's setmaxnreg: this warpgroup's registers a thread to N.
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Row stride of the remaining columns: b - 128, padded to 32 floats.
__host__ __device__ inline int fw_cur_ld(int b) { return cdiv(b - FW_NB, 32) * 32; }

// The global scratch of the wide phases, lane strides in floats.
struct WideScratch {
  float* Yj;    // (P, mm, 128): a sub-panel's Y; mm = max(m, 2b)
  float* Tj;    // (P, 128, 128)
  float* Rj;    // (P, 128, 128)
  float* cur;   // the columns right of the sub-panels done, one region a
                // blocked QR: (P, m, cur_ld), then L of (P, 2b, cur_ld)
  float* G;     // (P, b, 128): Y[:, :c0]^T Y_j
  float* H;     // (P, b, 128): G T_j
  float* Za;    // (P, 128, cur_ld): Y_j^T of the columns right
  float* Wa;    // (P, 128, cur_ld)
  float* part;  // block sums of the split products: kblocks(mm) * P * 128 * b
  float* Z;     // (P, b, w): the leaf apply's Y^T W, a combine's inner
  float* Wm;    // (P, b, w): the leaf apply's T^T Z
  float* stack; // (L, P, 2b, b): the stacked triangles, a region a level
  float* Ys;    // (P, 2b, b): their Y
};

// Rows of a lane's Yj: the panel's, or (with stacks) 2b when that is more.
__host__ __device__ inline int fw_mm(int m, int b, bool stacks) {
  return stacks && 2 * b > m ? 2 * b : m;
}

// Floats of WideScratch for P lanes (L levels of stacks), carved in this
// order.
__host__ __device__ inline size_t fw_scratch_floats(int P, int m, int w, int b,
                                                   int L, WideScratch* s,
                                                   float* base) {
  const size_t mm = fw_mm(m, b, L > 0), r = fw_cur_ld(b), bb = (size_t)b * b;
  const size_t sizes[13] = {
      mm * FW_NB, (size_t)FW_NB * FW_NB, (size_t)FW_NB * FW_NB,
      (m + 2 * (size_t)b * L) * r, (size_t)b * FW_NB, (size_t)b * FW_NB,
      FW_NB * r, FW_NB * r, (size_t)gemm_kblocks((int)mm) * FW_NB * b,
      (size_t)b * w, (size_t)b * w, 2 * bb * L, L > 0 ? 2 * bb : 0};
  float** slot[13] = {nullptr};
  if (s) {
    float** fields[13] = {&s->Yj, &s->Tj, &s->Rj, &s->cur, &s->G, &s->H,
                          &s->Za, &s->Wa, &s->part, &s->Z, &s->Wm, &s->stack,
                          &s->Ys};
    for (int i = 0; i < 13; ++i) slot[i] = fields[i];
  }
  size_t off = 0;
  for (int i = 0; i < 13; ++i) {
    if (s) *slot[i] = base + off;
    off += ((size_t)P * sizes[i] + 31) / 32 * 32;  // 128-byte aligned fields
  }
  return off;
}

// Shared memory and global slabs (floats a lane) of the team phases: the
// largest over the sub-panels of the (m x b) panel and, with stacks, of
// the (2b x b) stacks.
__host__ __device__ inline size_t fw_team_floats(int m, int b, bool stacks,
                                                 bool work) {
  size_t f = 0;
  for (int c0 = 0; c0 < b; c0 += FW_NB) {
    const int bj = min(FW_NB, b - c0);
    for (int q = 0; q < (stacks ? 2 : 1); ++q) {
      const int mm = q ? 2 * b : m, C = team_blocks(mm, bj);
      const bool in = team_slab_in_smem(mm, bj, C);
      const size_t v = work ? (in ? 0 : team_work_floats(mm, bj, C))
                            : team_smem_floats(mm, bj, C, in);
      f = v > f ? v : f;
    }
  }
  return f;
}

__host__ __device__ inline size_t fw_smem_floats(int m, int b, bool stacks) {
  const size_t t = fw_team_floats(m, b, stacks, false), g = WideTile::SMEM;
  return t > g ? t : g;
}

// The largest team of the launch's team phases: the cluster size.
__host__ __device__ inline int fw_max_team(int m, int b, bool stacks) {
  int C = 0;
  for (int c0 = 0; c0 < b; c0 += FW_NB) {
    const int bj = min(FW_NB, b - c0);
    C = max(C, team_blocks(m, bj));
    if (stacks) C = max(C, team_blocks(2 * b, bj));
  }
  return C;
}

// What blocked_qr reads besides its call's panel: the lanes, the scratch
// (a lane's Yj is yj_bs floats), the team phases' global slabs and the
// grid barrier's two words.
struct WideQR {
  WideScratch s;
  size_t yj_bs;
  float* work;
  unsigned* bar;
  int P;
};

// Words of the launch's scratch after WideScratch: the grid barrier's, and
// the look-ahead blocks' (part_barrier).
constexpr int FW_BAR_FLOATS = 32;

// The grid barrier of the wide launches (every block of the cooperative
// grid calls it): bar[0] counts the blocks that arrived, bar[1] the
// barriers passed; both are zeroed before the launch, and the count is 0
// again after every barrier. Thread 0 of a block arrives after a fence
// that orders the block's writes, and the waiting blocks sleep between
// polls of bar[1]. Every read of data another block wrote before the
// barrier bypasses L1 (see Coherence above). On the H100 the team phases
// after it ran 10-15% faster than after cooperative_groups' grid sync
// (PERF.md).
__device__ void grid_barrier(unsigned* bar, unsigned blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == blocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(256);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ void grid_barrier(unsigned* bar) { grid_barrier(bar, gridDim.x); }

// The barrier of blocks [b0, gridDim.x) alone (bar[2], bar[3]; b0 = 0: the
// grid's, bar[0], bar[1]).
__device__ void part_barrier(unsigned* bar, int b0) {
  if (b0) grid_barrier(bar + 2, gridDim.x - b0);
  else grid_barrier(bar);
}

// The exchange of K1's team body (ClusterExchange) for a team of C blocks
// at ranks [base, base + C) of a larger cluster: rank r of the team is
// cluster rank base + r. The cluster barrier is the whole cluster's, so
// the cluster's teams run their columns in lockstep.
struct SubClusterExchange {
  float* slots;
  int b, C, rank, base;
  __device__ void put(int par, int i, int r, float v) const {
    cg::this_cluster().map_shared_rank(slots, base + r)[team_slot(b, par, i, rank)] = v;
  }
  __device__ void sync(int) const { cg::this_cluster().sync(); }
};

// One team block's share of a sub-panel's QR (team_qr), out of line: with
// a cluster team's exchange taken by value (a copy in registers ran the
// column loop about 10% faster on the H100 than one read through a
// reference), and with GlobalExchange by reference (its arrival target
// carries over from lane to lane).
template <class Ex>
__device__ __forceinline__ void wide_team_body(const float* A, long long a_ld,
                                               float* Y, float* T, float* R,
                                               int m, int b, int rs, int C,
                                               float* slab_g, float* smem,
                                               Ex& ex) {
  if (slab_g)
    team_qr<false>(A, a_ld, Y, T, R, m, b, rs, C, ex.rank, slab_g, smem, ex);
  else
    team_qr<true>(A, a_ld, Y, T, R, m, b, rs, C, ex.rank, nullptr, smem, ex);
}

__device__ __noinline__ void wide_team_qr(const float* A, long long a_ld,
                                          float* Y, float* T, float* R, int m,
                                          int b, int rs, int C, float* slab_g,
                                          float* smem, SubClusterExchange ex) {
  wide_team_body(A, a_ld, Y, T, R, m, b, rs, C, slab_g, smem, ex);
}

__device__ __noinline__ void wide_team_qr(const float* A, long long a_ld,
                                          float* Y, float* T, float* R, int m,
                                          int b, int rs, int C, float* slab_g,
                                          float* smem, GlobalExchange& ex) {
  wide_team_body(A, a_ld, Y, T, R, m, b, rs, C, slab_g, smem, ex);
}

// An element-wise step by rows: f(r, lane) for every row r < rows, one warp
// a row across the grid (f takes the row's columns lane, lane + 32, ...).
// Per-row index arithmetic in 32 bits, and coalesced rows.
template <class F>
__device__ __forceinline__ void grid_rows(int rows, F f) {
  const int wpb = blockDim.x >> 5;
  for (int r = blockIdx.x * wpb + (threadIdx.x >> 5); r < rows; r += gridDim.x * wpb)
    f(r, (int)(threadIdx.x & 31));
}

// One batched product of a phase: lane p runs when f(p, v) fills its view v
// (M x N outputs, a K-term sum) and returns true.
template <class F>
struct Prod {
  F f;
  int P, M, N, K;
};

template <class F>
__device__ Prod<F> prod(F f, int P, int M, int N, int K) {
  return Prod<F>{f, P, M, N, K};
}

// The k ranges (block sums) a product's items take: one when it splits
// (split asked for, a deep sum, few tiles a lane), else the whole sum.
template <class F>
__device__ int fw_parts(const Prod<F>& q, const float* part) {
  const int t = cdiv(q.M, WideTile::BM) * cdiv(q.N, WideTile::BN);
  const int nblk = gemm_kblocks(q.K);
  return part && nblk >= FW_SPLIT_MIN && 2 * t <= FW_BLOCKS ? nblk : 1;
}

// The block sums of a split product, added in block order, then its
// epilogue: element e of lane p at part[kb * P*M*N + e]; on the threads of
// blocks [b0, gridDim.x).
template <class F>
__device__ void fw_reduce(const Prod<F>& q, const float* part, int b0) {
  const size_t mn = (size_t)q.M * q.N, all = q.P * mn;
  const int nblk = gemm_kblocks(q.K);
  const size_t t0 = (size_t)(blockIdx.x - b0) * blockDim.x + threadIdx.x;
  for (size_t e = t0; e < all; e += (size_t)(gridDim.x - b0) * blockDim.x) {
    const int p = (int)(e / mn), i = (int)(e % mn / q.N), j = (int)(e % q.N);
    GemmView v;
    if (!q.f(p, v)) continue;
    float tot = 0.f;
    for (int kb = 0; kb < nblk; ++kb) tot += __ldcg(part + kb * all + e);
    gemm_store(v, i, j, tot);
  }
}

// One grid-wide phase of two independent batched products (q2.P may be 0),
// on blocks [b0, gridDim.x) (the others do not call it).
// The (product, lane, tile, k range) items go round the blocks, each on
// warpgroups 0-1 at FW_TILE_REGS registers while warpgroups 2-3 wait at
// FW_IDLE_REGS (named barrier 3). With `part` (room for both products'
// block sums) a deep, narrow product takes one item a block sum, and after
// a grid barrier its block sums are added in order.
template <class F1, class F2>
__device__ void tile_phase(const Prod<F1>& q1, const Prod<F2>& q2, float* smem,
                           unsigned* bar, float* part = nullptr, int b0 = 0) {
  constexpr int BM = WideTile::BM, BN = WideTile::BN;
  const int k1 = fw_parts(q1, part), k2 = fw_parts(q2, part);
  const int tn1 = cdiv(q1.N, BN), tl1 = cdiv(q1.M, BM) * tn1, n1 = q1.P * tl1 * k1;
  const int tn2 = cdiv(q2.N, BN), tl2 = cdiv(q2.M, BM) * tn2, n2 = q2.P * tl2 * k2;
  const long long all1 = (long long)q1.P * q1.M * q1.N;
  float* part2 = part + (k1 > 1 ? (long long)gemm_kblocks(q1.K) * all1 : 0);
  if (threadIdx.x < WG_THREADS) {
    regs_inc<FW_TILE_REGS>();
    for (int it = blockIdx.x - b0; it < n1 + n2; it += gridDim.x - b0) {
      const bool first = it < n1;
      const int rel = first ? it : it - n1, ks = first ? k1 : k2;
      const int tl = first ? tl1 : tl2, tn = first ? tn1 : tn2;
      const int kr = rel % ks, t = rel / ks % tl, p = rel / ks / tl;
      GemmView v;
      if (!(first ? q1.f(p, v) : q2.f(p, v))) continue;
      const long long pl = first ? all1 : (long long)q2.P * q2.M * q2.N;
      float* pt = ks > 1 ? (first ? part : part2) + (long long)p * v.M * v.N : nullptr;
      gemm_tile_any<WideTile>(gemm_mode(v, true), v, (t / tn) * BM, (t % tn) * BN,
                              ks > 1 ? kr : 0, ks > 1 ? kr + 1 : gemm_kblocks(v.K),
                              pt, pl, smem, threadIdx.x, 1);
    }
    regs_dec<FW_REGS>();
    bar_sync(3, QR_THREADS);
  } else {
    regs_dec<FW_IDLE_REGS>();
    bar_sync(3, QR_THREADS);
    regs_inc<FW_REGS>();
  }
  if (k1 > 1 || k2 > 1) {
    part_barrier(bar, b0);
    if (k1 > 1) fw_reduce(q1, part, b0);
    if (k2 > 1) fw_reduce(q2, part2, b0);
  }
}

template <class F>
__device__ void tile_phase(const Prod<F>& q, float* smem, unsigned* bar,
                           float* part = nullptr, int b0 = 0) {
  tile_phase(q, prod([](int, GemmView&) { return false; }, 0, 0, 0, 0), smem,
             bar, part, b0);
}

__device__ inline GemmView gemm_view(int M, int N, int K, const float* A,
                                     long long a_rs, long long a_cs,
                                     const float* B, long long b_rs,
                                     const float* D, long long d_rs, float* O,
                                     long long o_rs, int sub) {
  return GemmView{M, N, K, A, a_rs, a_cs, B, b_rs, 1, D, d_rs, 1, O, o_rs, 1,
                  sub, nullptr, 0, 0, nullptr, 0, 0};
}

// The team phases of a cooperative launch of clusters of CS blocks. A
// cluster holds CS / C teams of C blocks (both powers of two), team t at
// cluster t / (CS / C), ranks (t % (CS / C)) C + [0, C); lane p runs on
// team p % teams in round p / teams. A round's teams of one cluster run in
// lockstep: a team without a lane in the round arrives at each of the bj
// cluster barriers that team_qr takes (one a column), and a cluster with
// no lane in the round skips it.
struct ClusterTeams {
  static constexpr bool kLookahead = true;
  int CS;
  // The blocks a team phase of P lanes at team size C keeps busy (a prefix
  // of the grid): the clusters of the first round, or all blocks when the
  // lanes take more than one round.
  __device__ int busy(int P, int C) const {
    const int subs = CS / C, teams = gridDim.x / CS * subs;
    return P > teams ? (int)gridDim.x : (P + subs - 1) / subs * CS;
  }
  // body(p, ex) on every lane p with on(p), the exchange of its team
  template <class On, class Body>
  __device__ void run(int P, int bj, int C, float* smem, On on, Body body) {
    cg::cluster_group cl = cg::this_cluster();
    const int subs = CS / C, rank = (int)cl.block_rank(), sub = rank / C;
    const int teams = gridDim.x / CS * subs, team0 = blockIdx.x / CS * subs;
    SubClusterExchange ex{smem, bj, C, rank % C, sub * C};
    bool first = true;
    for (int p0 = 0; p0 < P; p0 += teams) {
      bool any = false;
      for (int s = 0; s < subs; ++s)
        any = any || (p0 + team0 + s < P && on(p0 + team0 + s));
      if (!any) continue;
      if (!first) cl.sync();  // the last round's slots are read
      first = false;
      const int p = p0 + team0 + sub;
      if (p < P && on(p)) {
        body(p, ex);
      } else {
        for (int j = 0; j < bj; ++j) cl.sync();
      }
    }
  }
};

// The team phases of a plain cooperative launch: team t is blocks
// [t C, (t + 1) C) (blocks past the last whole team idle); lane p runs on
// team p % teams. Each phase has its own row of arrival counters (xch_blocks
// of them, zeroed before the launch) and each team its exchange slots.
struct GlobalTeams {
  float* xch;
  unsigned* arrivals;
  int xch_blocks;
  int phase;  // team phases run so far
  static constexpr bool kLookahead = false;
  __device__ int busy(int, int) const { return gridDim.x; }
  template <class On, class Body>
  __device__ void run(int P, int bj, int C, float* smem, On on, Body body) {
    const int teams = gridDim.x / C, team = blockIdx.x / C, rank = blockIdx.x % C;
    if (team < teams) {
      GlobalExchange ex{smem, xch + (size_t)team * team_slots_floats(bj), bj, C,
                        rank, arrivals + (size_t)phase * xch_blocks + team, 0u};
      bool first = true;
      for (int p = team; p < P; p += teams) {
        if (!on(p)) continue;
        if (!first) ex.sync(0);  // the last lane's slots are read
        first = false;
        body(p, ex);
      }
    }
    ++phase;
  }
};

// The blocked QR (kernels/wide.py::panel_qr_blocked) of every lane p with
// on(p): the (m x b) panel at in(p) (row stride in_ld, unit column stride)
// from row start rs(p), into Y (row stride b, lane stride y_bs), T and R
// (b x b, contiguous); `cur` is this call's region of the remaining
// columns. Lanes that are not on get zero Y, T and R with zero_off, else
// are not touched. Every block calls it; it ends with a grid barrier.
//
// Look-ahead: where the next sub-panel's team phase leaves at least
// FW_LOOKAHEAD blocks without a team (teams.busy), the apply of Q_j^T
// covers only the next sub-panel's columns before it, and those idle
// blocks apply Q_j^T to the columns beyond during it (Za, Wa and the
// update on their own, with a barrier of their own between the steps;
// Y_j and T_j read from the outputs, whose sub-panel j is final). Every
// element gets the same sums in the same order: a product's column range
// enters no element's sum.
template <class Teams, class On, class In, class Rs>
__device__ void blocked_qr(const WideQR& q, Teams& teams, int m, int b, On on,
                           In in, long long in_ld, Rs rs, float* Y, size_t y_bs,
                           float* T, float* R, float* cur, bool zero_off,
                           float* smem) {
  const WideScratch& s = q.s;
  const int P = q.P;
  const size_t bb = (size_t)b * b;
  const size_t yj_bs = q.yj_bs, tj_bs = (size_t)FW_NB * FW_NB;
  const long long cur_ld = fw_cur_ld(b);
  const size_t cur_bs = (size_t)m * cur_ld, g_bs = (size_t)b * FW_NB;
  const size_t wa_bs = (size_t)FW_NB * cur_ld;
  // the source of the columns right of the sub-panel at c0 (its row stride)
  auto src_at = [&](int c, int p) -> const float* {
    return c == 0 ? in(p) : cur + p * cur_bs + (c - FW_NB);
  };
  bool deferred = false;  // the last sub-panel left its far columns to this team phase
  for (int c0 = 0; c0 < b; c0 += FW_NB) {
    const int bj = min(FW_NB, b - c0), rest = b - c0 - bj;
    const long long sld = c0 == 0 ? in_ld : cur_ld;
    auto src = [&](int p) -> const float* { return src_at(c0, p); };
    // 1. the sub-panel's QR on every lane's team; meanwhile the blocks past
    // the teams apply the last sub-panel's Q^T to the columns right of this
    // one (its far columns: x in [bj, bj + rest) past that one's)
    const int C = team_blocks(m, bj);
    const bool insm = team_slab_in_smem(m, bj, C);
    const size_t slab = (size_t)team_cols(bj) * team_ld(team_rows(m, C));
    const int busy = teams.busy(P, C);
    bool far = false;
    if constexpr (Teams::kLookahead) far = deferred && (int)blockIdx.x >= busy;
    if (far) {
      const int cp = c0 - FW_NB;  // the last sub-panel (FW_NB columns)
      const long long pld = cp == 0 ? in_ld : cur_ld;
      tile_phase(prod([&](int p, GemmView& v) {
        v = gemm_view(FW_NB, rest, m, Y + p * y_bs + cp, 1, b,
                      src_at(cp, p) + FW_NB + bj, pld, nullptr, 0,
                      s.Za + p * wa_bs + bj, cur_ld, 0);
        return on(p);
      }, P, FW_NB, rest, m), smem, q.bar, s.part, busy);
      part_barrier(q.bar, busy);
      tile_phase(prod([&](int p, GemmView& v) {
        v = gemm_view(FW_NB, rest, FW_NB, T + p * bb + (size_t)cp * b + cp, 1, b,
                      s.Za + p * wa_bs + bj, cur_ld, nullptr, 0,
                      s.Wa + p * wa_bs + bj, cur_ld, 0);
        return on(p);
      }, P, FW_NB, rest, FW_NB), smem, q.bar, nullptr, busy);
      part_barrier(q.bar, busy);
      tile_phase(prod([&](int p, GemmView& v) {
        v = gemm_view(m, rest, FW_NB, Y + p * y_bs + cp, b, 1,
                      s.Wa + p * wa_bs + bj, cur_ld, src_at(cp, p) + FW_NB + bj,
                      pld, cur + p * cur_bs + c0 + bj - FW_NB, cur_ld, 1);
        return on(p);
      }, P, m, rest, FW_NB), smem, q.bar, nullptr, busy);
    } else {
      teams.run(P, bj, C, smem, on, [&](int p, auto& ex) {
        wide_team_qr(src(p), sld, s.Yj + p * yj_bs, s.Tj + p * tj_bs,
                     s.Rj + p * tj_bs, m, bj, rs(p) + c0, C,
                     insm ? nullptr : q.work + ((size_t)p * C + ex.rank) * slab,
                     smem, ex);
      });
    }
    grid_barrier(q.bar);
    // the columns this sub-panel's Q^T updates now: all of them, or the
    // next sub-panel's alone when the next team phase takes the rest
    const int nb = min(FW_NB, rest);
    deferred = Teams::kLookahead && rest > nb &&
               teams.busy(P, team_blocks(m, nb)) + FW_LOOKAHEAD <= (int)gridDim.x;
    const int now = deferred ? nb : rest;
    // 2. the sub-panel's columns of Y and R and rows of T
    grid_rows(P * m, [&](int row, int lane) {
      const int p = row / m, i = row % m;
      if (!on(p)) return;
      for (int c = lane; c < bj; c += 32)
        Y[p * y_bs + (size_t)i * b + c0 + c] = __ldcg(s.Yj + p * yj_bs + (size_t)i * bj + c);
    });
    grid_rows(P * b, [&](int row, int lane) {
      const int p = row / b, r = row % b;
      if (!on(p)) return;
      // R[r, c0 + c]: a row above the sub-panel's first pivot keeps the
      // panel as the sub-panels before it left it; the others are rows of
      // the sub-panel's own R, whose start it clamps to m - bj
      const int rsp = rs(p), rsj = rsp + c0;
      const int i = min(max(rsp, 0), m - b) + r;
      const int own = min(max(i - min(max(rsj, 0), m - bj), 0), bj - 1);
      for (int c = lane; c < bj; c += 32) {
        const float v = i < rsj ? __ldcg(src(p) + (size_t)i * sld + c)
                                : __ldcg(s.Rj + p * tj_bs + (size_t)own * bj + c);
        R[p * bb + (size_t)r * b + c0 + c] = r > c0 + c ? 0.f : v;
      }
    });
    grid_rows(P * bj, [&](int row, int lane) {
      const int p = row / bj, r = row % bj;
      if (!on(p)) return;
      for (int col = lane; col < b; col += 32) {
        const bool in_blk = col >= c0 && col < c0 + bj;
        T[p * bb + (size_t)(c0 + r) * b + col] =
            in_blk ? __ldcg(s.Tj + p * tj_bs + (size_t)r * bj + (col - c0)) : 0.f;
      }
    });
    if (c0 == 0 && zero_off)  // inactive lanes: zero Y, T, R (rows of b)
      grid_rows(P * (m + 2 * b), [&](int row, int lane) {
        const int p = row / (m + 2 * b), r = row % (m + 2 * b);
        if (on(p)) return;
        float* dst = r < m ? Y + p * y_bs + (size_t)r * b
                     : r < m + b ? T + p * bb + (size_t)(r - m) * b
                                 : R + p * bb + (size_t)(r - m - b) * b;
        for (int c = lane; c < b; c += 32) dst[c] = 0.f;
      });
    // G = Y[:, :c0]^T Y_j; Za = Y_j^T C, C the columns right of the
    // sub-panel: k over the m rows, split into block sums
    tile_phase(
        prod([&](int p, GemmView& v) {
          v = gemm_view(c0, bj, m, Y + p * y_bs, 1, b, s.Yj + p * yj_bs, bj,
                        nullptr, 0, s.G + p * g_bs, bj, 0);
          return c0 > 0 && on(p);
        }, c0 > 0 ? P : 0, c0, bj, m),
        prod([&](int p, GemmView& v) {
          v = gemm_view(bj, now, m, s.Yj + p * yj_bs, 1, bj, src(p) + bj, sld,
                        nullptr, 0, s.Za + p * wa_bs, cur_ld, 0);
          return now > 0 && on(p);
        }, now > 0 ? P : 0, bj, now, m),
        smem, q.bar, s.part);
    grid_barrier(q.bar);
    // H = G T_j; Wa = T_j^T Za
    tile_phase(
        prod([&](int p, GemmView& v) {
          v = gemm_view(c0, bj, bj, s.G + p * g_bs, bj, 1, s.Tj + p * tj_bs, bj,
                        nullptr, 0, s.H + p * g_bs, bj, 0);
          return c0 > 0 && on(p);
        }, c0 > 0 ? P : 0, c0, bj, bj),
        prod([&](int p, GemmView& v) {
          v = gemm_view(bj, now, bj, s.Tj + p * tj_bs, 1, bj, s.Za + p * wa_bs,
                        cur_ld, nullptr, 0, s.Wa + p * wa_bs, cur_ld, 0);
          return now > 0 && on(p);
        }, now > 0 ? P : 0, bj, now, bj),
        smem, q.bar);
    grid_barrier(q.bar);
    // T[:c0, c0:c0+bj] = -(T[:c0, :c0] H), k over c0 rows, split into block
    // sums; the columns right = C - Y_j Wa, into cur (in place after the
    // first sub-panel)
    tile_phase(
        prod([&](int p, GemmView& v) {
          v = gemm_view(c0, bj, c0, T + p * bb, b, 1, s.H + p * g_bs, bj,
                        nullptr, 0, T + p * bb + c0, b, 1);
          return c0 > 0 && on(p);
        }, c0 > 0 ? P : 0, c0, bj, c0),
        prod([&](int p, GemmView& v) {
          v = gemm_view(m, now, bj, s.Yj + p * yj_bs, bj, 1, s.Wa + p * wa_bs,
                        cur_ld, src(p) + bj, sld,
                        cur + p * cur_bs + (c0 + bj - FW_NB), cur_ld, 1);
          return now > 0 && on(p);
        }, now > 0 ? P : 0, m, now, bj),
        smem, q.bar, s.part);
    grid_barrier(q.bar);
  }
}

// The register pool the tile phases trade in (FW_REGS a thread), or no
// launch: setmaxnreg.inc would wait forever for registers the block lacks.
inline cudaError_t fw_check_regs(const void* kernel) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  return fa.numRegs == FW_REGS ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// The cooperative launch of `kernel` (512-thread blocks, `smem` bytes of
// dynamic shared memory each) in clusters of CS blocks, as many clusters as
// the card holds at once (attr: room for two attributes). Fills cfg, whose
// gridDim.x is then the grid; returns cudaErrorCooperativeLaunchTooLarge
// when the card cannot hold one cluster.
inline cudaError_t wide_config(const void* kernel, int CS, size_t smem,
                               cudaStream_t stream, cudaLaunchConfig_t* cfg,
                               cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  if ((err = fw_check_regs(kernel)) != cudaSuccess) return err;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CS);
  cfg->blockDim = dim3(QR_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorCooperativeLaunchTooLarge;
  cfg->gridDim = dim3(clusters * CS);
  cfg->numAttrs = 2;
  return cudaSuccess;
}

// Launch `kernel` on `args` as wide_config sets it up: both attributes or
// no launch (a refused launch returns its error; there is no other route).
template <class Args>
inline int wide_launch(void (*kernel)(Args), const Args& args, int CS,
                       size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err = wide_config((const void*)kernel, CS, smem, stream, &cfg, attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The grid of that launch (blocks), or 0 with the error in *err.
inline int wide_grid(const void* kernel, int CS, size_t smem, int* err) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  *err = (int)wide_config(kernel, CS, smem, nullptr, &cfg, attr);
  return *err ? 0 : (int)cfg.gridDim.x;
}

}  // namespace repro
