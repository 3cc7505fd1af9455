// Shared device code of the port's kernels: K1's lane team (team_qr: a
// masked Householder QR of one (m x b) panel on C blocks, with the
// compact-WY T factor), K3's structured QR of two stacked triangles by one
// block (stacked_qr_lane), and the per-tile bodies of K2 (wy_apply_tile)
// and K4 (stacked_apply_tile). The kernels K1-K4 and the fused K5/K6
// (fused_sweep.cu) all call these bodies, so the fused kernels compute
// every element by the same operations in the same order as the stepped
// ones, which the fused == stepped bitwise contract needs.
//
// The QR arithmetic follows src/repro/kernels/panel_qr.py::panel_qr_math:
// column j pivots at row_start + j; rows above the pivot are neither read
// nor written; beta = -sign(x0)*||x|| with sign(0) = +1; a column with
// ||x|| <= 1e-30 gives tau = 0 and v = e_pivot + x_below (denom = 1); T
// comes from the forward recurrence over G = Y^T Y, applied by 32-column
// blocks (team_t). Both QR bodies update only the columns right of the
// pivot's, which are all that any output reads, and write beta as R's
// diagonal.
//
// Determinism: every sum runs in a fixed order (in the QR, per-thread
// partials over a fixed row assignment, then a fixed tree, and across a
// team in rank order; in the K2/K4 tiles, one sequential chain per
// element, see their section below); there are no atomics, and no sum
// depends on the lane or the launch size. So a lane gives the same bits in
// any launch, which the FT butterfly and recovery rely on.
//
// Element types: the bodies are templates on the type E of the tensors
// they read and write in global memory, float or bf16. In the QR bodies
// (K1, K3) only global loads and stores see E: a bf16 load widens to float
// exactly, a bf16 store rounds to nearest even; shared memory, registers,
// the team's exchange slots and every sum stay float, in the same order.
// So their bf16 instance is the float instance run on the widened inputs
// with each output rounded once: K(x) at bf16 == K(float(x)) rounded, bit
// for bit. K2's and K4's tiles at bf16 run their products on the tensor
// cores instead (wg_apply_engine, wgmma_bf16.cuh's contract). The T factor's
// strict lower triangle holds G^T during a QR (team_t's input): at bf16
// that goes to a float scratch G beside T; at float G is T itself.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "async_copy.cuh"
#include "elem.cuh"
#include "wgmma_bf16.cuh"

namespace repro {

namespace cg = cooperative_groups;

// The float scratch that holds G^T during a QR whose T is `T`: T itself at
// float, else `g` (b x b floats).
template <class E>
__device__ __forceinline__ float* gram_scratch(E* T, float* g) {
  if constexpr (std::is_same_v<E, float>) return T;
  else return g;
}

constexpr int QR_THREADS = 512;
constexpr int QR_MAX_B = 128;

// -- K1's body: the lane team ------------------------------------------------
//
// K1 (src/repro/kernels/panel_qr.py::panel_qr) runs each lane's (m x b)
// panel on a team of C blocks, each owning one slab of ceil(m / C)
// consecutive rows. A slab sits in the block's shared memory, column-major
// (a column's rows are consecutive, so a thread reads four rows of a column
// as one 16-byte access), with two more columns of per-row scratch; a slab
// too large for shared memory even at C = TEAM_MAX sits in global scratch
// with the same layout, reached through the same float*, so which memory
// holds it changes no bit. C is a function of (m, b) alone (team_blocks;
// the Python wrappers compute it by the same rule and pass it to every
// launch), so a one-lane REBUILD launch gives a lane the bits it has in an
// 8-lane launch, and K1, K5 and K6 agree.
//
// One team barrier a column. Column j, pivot p = rs + j (rows above p are
// frozen), x = A[:, j]; the reflector is v = e_p + x_below / denom, so
//   w_c = v^T A[:, c] = A[p, c] + (sum_{i > p} x_i A[i, c]) / denom,
// and a block can form its share of every such sum, and of ||x||^2, before
// the norm (and so denom) is known. Each block therefore sends, per column,
// its partial sum of x_i^2 over its rows at and below p, its partial sums
// y_c = sum over its rows i > p of x_i A[i, c] for every c != j, and, from
// the block that holds row p, that row. After the barrier every block sums
// the C partials in rank order 0..C-1 (so all hold the same bits) and
// forms beta, tau, denom, and w_c for c > j, and G[c, j] = Y_c^T v for
// c < j, where A[:, c] holds v_c (G = Y^T Y comes out of the loop, as
// LAPACK's larft forms it). It writes v over its rows of column j, with
// tau v_i and the updated column j + 1 beside the slab, and makes one pass
// over its rows at and below p: the rank-1 update of the columns c > j
// (columns c < j would receive updates that no output reads; column j
// would receive what R's diagonal holds, kept as beta, or x0 for tau = 0)
// and, from the updated values, column j + 1's sums, which it sends as
// soon as they are complete. Blocks whose slab lies wholly above the pivot
// send zeros but take part in every barrier. After the loop each block
// writes its rows of Y and R; rank 0 forms T from the gathered G
// (team_t) and writes it.
//
// The exchange is a template parameter: K1 pushes each block's sums into
// every team block's shared memory inside a thread-block cluster
// (ClusterExchange: distributed shared memory stores, one cluster barrier);
// the cooperative K5/K6 write them to global memory and, behind a per-team
// barrier, copy the team's into shared memory (GlobalExchange). Either way
// every block then reads the same values from its own shared memory and
// sums them in the same order, so the arithmetic, and every bit, is the
// same.

constexpr int TEAM_MAX = 16;            // blocks per lane, at most
constexpr size_t TEAM_SMEM_LIMIT = 232448;  // bytes a block may use (Hopper)
constexpr int QR_WARPS = QR_THREADS / 32;
constexpr int TEAM_WARP_COLS = 8;  // columns a warp takes in the pass
constexpr int TEAM_W_THREADS = QR_MAX_B;  // threads forming w, beside v
static_assert(QR_WARPS * TEAM_WARP_COLS >= QR_MAX_B, "the pass covers b");

__host__ __device__ inline int team_rows(int m, int C) { return (m + C - 1) / C; }

// Leading dimension of a column-major slab: a multiple of 4 (16-byte
// column starts), 4 more than a multiple of 8, so that the row-major copies
// in and out meet at most 4-way bank conflicts.
__host__ __device__ inline int team_ld(int rows) {
  const int r4 = (rows + 3) / 4 * 4;
  return r4 % 8 == 0 ? r4 + 4 : r4;
}

// Columns of a slab: the b of the panel, then tau v_i and column j + 1's
// updated values of the current column.
__host__ __device__ inline int team_cols(int b) { return b + 2; }

// Slots a block sends a column: ||x||^2's partial (0), the pivot row
// (1 + c), the sums y (1 + b + c); padded to a multiple of 4.
__host__ __device__ inline int team_xch_floats(int b) { return (2 * b + 4) / 4 * 4; }

// Floats of one team's exchange: two buffers (columns alternate between
// them) of TEAM_MAX ranks' rows of team_xch_floats(b) slots, so that a
// warp's stores of consecutive slots to one rank are consecutive.
__host__ __device__ inline size_t team_slots_floats(int b) {
  return 2 * (size_t)team_xch_floats(b) * TEAM_MAX;
}

// Floats of team_t's scratch: G^T, T (b x (b + 1)) and a (b x 32) product.
__host__ __device__ inline size_t team_t_floats(int b) {
  return (size_t)b * b + (size_t)b * (b + 1) + (size_t)b * 32;
}

// Floats of the region after the slots: the slab (when it is in shared
// memory) and, once the loop is over, team_t's scratch.
__host__ __device__ inline size_t team_region_floats(int m, int b, int C,
                                                     bool slab_in_smem) {
  const size_t slab =
      slab_in_smem ? (size_t)team_cols(b) * team_ld(team_rows(m, C)) : 0;
  return slab > team_t_floats(b) ? slab : team_t_floats(b);
}

// Floats of shared memory the team body needs: the exchange slots it reads
// (ClusterExchange's team stores into them; GlobalExchange copies them in
// from global memory), the region, the block's outgoing values, w, the
// taus, R's diagonal, and the column's denominator, tau and w_{j+1}.
__host__ __device__ inline size_t team_smem_floats(int m, int b, int C,
                                                   bool slab_in_smem) {
  return team_slots_floats(b) + team_region_floats(m, b, C, slab_in_smem) +
         team_xch_floats(b) + 3 * (size_t)b + 4;
}

__host__ __device__ inline bool team_slab_in_smem(int m, int b, int C) {
  return team_smem_floats(m, b, C, true) * sizeof(float) <= TEAM_SMEM_LIMIT;
}

// The team size for an (m x b) panel: the smallest power of two up to
// TEAM_MAX whose slab fits in shared memory beside the other buffers, else
// TEAM_MAX (the slab then lives in global scratch). Mirrored by
// repro_torch.kernels.backend.team_blocks.
__host__ __device__ inline int team_blocks(int m, int b) {
  for (int C = 1; C < TEAM_MAX; C *= 2)
    if (team_slab_in_smem(m, b, C)) return C;
  return TEAM_MAX;
}

// Floats of global scratch a lane needs when its slabs are not in shared
// memory: C slabs of team_cols(b) x team_ld(rows).
__host__ __device__ inline size_t team_work_floats(int m, int b, int C) {
  return (size_t)C * team_cols(b) * team_ld(team_rows(m, C));
}

// Where rank r's value of slot i of buffer par sits in a team's slots.
__host__ __device__ inline int team_slot(int b, int par, int i, int r) {
  return (par * TEAM_MAX + r) * team_xch_floats(b) + i;
}

// The exchanges keep two buffers of slots, buffer `par` for the columns of
// parity par: a block sends column j + 1's sums after the barrier of
// column j, while a slower block may still read column j's, but never
// column j - 1's (it has passed the barrier that follows them). After
// sync(par) every block reads buffer par from its own shared memory
// (`slots`, team_slots_floats(b) floats).
//
// The K1 exchange: a block stores its values into its rank's place in
// every team block's shared memory (distributed shared memory); the
// cluster barrier orders those stores before the reads.
struct ClusterExchange {
  float* slots;
  int b, C, rank;
  // value v of slot i into team block r
  __device__ void put(int par, int i, int r, float v) const {
    cg::this_cluster().map_shared_rank(slots, r)[team_slot(b, par, i, rank)] = v;
  }
  __device__ void sync(int) const { cg::this_cluster().sync(); }
};

// The K5/K6 exchange: each block stores its values once, into the team's
// slots in global memory (`team`, team_slots_floats(b) floats); after a
// barrier on the team's arrival counter (zeroed before the launch) every
// block copies buffer par into its shared memory through L2. Every block
// of a cooperative launch is resident, so the spin cannot wait on a block
// that never runs.
struct GlobalExchange {
  float* slots;
  float* team;
  int b, C, rank;
  unsigned* counter;
  unsigned target;  // arrivals the next barrier waits for
  __device__ void put(int par, int i, int r, float v) const {
    if (r == 0) team[team_slot(b, par, i, rank)] = v;
  }
  __device__ void sync(int par) {
    target += C;
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(counter, 1u);
      while (*(volatile unsigned*)counter < target) {
      }
      __threadfence();
    }
    __syncthreads();
    const int n = C * team_xch_floats(b) / 4;  // buffer par's rows 0..C-1
    const float4* src =
        reinterpret_cast<const float4*>(team + team_slot(b, par, 0, 0));
    float4* dst = reinterpret_cast<float4*>(slots + team_slot(b, par, 0, 0));
    for (int e = threadIdx.x; e < n; e += QR_THREADS) dst[e] = __ldcg(src + e);
    __syncthreads();
  }
};

// Rank r's value of slot i of buffer par, after sync(par).
__device__ __forceinline__ float team_get(const float* slots, int b, int par,
                                          int r, int i) {
  return slots[team_slot(b, par, i, r)];
}

// Slot i of the C blocks of a team summed in rank order 0..C-1 (the loads
// issued together).
__device__ __forceinline__ float rank_sum(const float* slots, int b, int C,
                                          int par, int i) {
  float part[TEAM_MAX];
#pragma unroll
  for (int r = 0; r < TEAM_MAX; ++r)
    part[r] = r < C ? team_get(slots, b, par, r, i) : 0.f;
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < TEAM_MAX; ++r)
    if (r < C) s += part[r];
  return s;
}

// The team's scratch in one block's shared memory (see team_smem_floats).
struct TeamSmem {
  float *slots, *region, *out, *w, *taus, *rdiag, *scal;
  __device__ TeamSmem(float* smem, int m, int b, int C, bool slab_in_smem)
      : slots(smem), region(smem + team_slots_floats(b)),
        out(region + team_region_floats(m, b, C, slab_in_smem)),
        w(out + team_xch_floats(b)), taus(w + b), rdiag(taus + b),
        scal(rdiag + b) {}
};

// Send the block's values of a column (sm.out: 1 + b of them, or 1 + 2b
// from the block that holds the pivot row) to the team, in buffer par:
// warp r stores them into block r, consecutive slots from consecutive
// lanes.
template <class Ex>
__device__ __forceinline__ void team_send(const Ex& ex, const TeamSmem& sm,
                                          int b, int C, int par,
                                          bool holds_pivot) {
  const int r = threadIdx.x >> 5, n = holds_pivot ? 1 + 2 * b : 1 + b;
  if (r >= C) return;
  for (int k = threadIdx.x & 31; k < n; k += 32) {
    const int i = k == 0 || holds_pivot ? k : b + k;  // the slot
    ex.put(par, i, r, sm.out[i]);
  }
}

// One pass over this block's local rows [s0, nr) after column j's
// reflector: columns c > j get A[i, c] -= tau v_i w_c (tau v_i in slab
// column b; skipped for tau = 0), and column nxt's sums are formed from the
// updated values (column nxt's in slab column b + 1) into sm.out: ||x||^2
// over rows at and below pivot np, y_c = sum_{i > np} x_i A[i, c], and
// row np's values when this block holds it.
// Warp w takes columns [8w, 8w + 8); lane (q, g) = (lane % 8, lane / 8)
// takes columns 8w + 2g and 8w + 2g + 1 of rows 4q .. 4q + 3 of every
// 32-row step, as 16-byte accesses. A column's sum is each lane's sum over
// its rows in order, then a fixed shuffle tree over the 8 lanes q. Four
// rows that all lie strictly below np and above nr take a path without
// per-row tests (the same operations in the same order).
__device__ __forceinline__ void team_pass(float* S, int ld, int lo, int nr,
                                          int s0, int b, int j, bool upd,
                                          int np, const TeamSmem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane & 7, g = lane >> 3;
  const int c0 = TEAM_WARP_COLS * warp + 2 * g;
  if (TEAM_WARP_COLS * warp >= b && warp != 0) return;
  const bool has0 = c0 < b, has1 = c0 + 1 < b, want_sq = warp == 0;
  const bool up0 = upd && has0 && c0 > j, up1 = upd && has1 && c0 + 1 > j;
  const float w0 = up0 ? sm.w[c0] : 0.f, w1 = up1 ? sm.w[c0 + 1] : 0.f;
  const float* tv = S + (size_t)b * ld;
  const float* xn = S + (size_t)(b + 1) * ld;
  float* a0p = S + (size_t)(has0 ? c0 : 0) * ld;
  float* a1p = S + (size_t)(has1 ? c0 + 1 : 0) * ld;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int full = max(np - lo + 1, s0);  // first local row of the plain path
  float y0 = 0.f, y1 = 0.f, sq = 0.f;
  for (int i = (s0 & ~3) + 4 * q; i < nr; i += 32) {
    const float4 t = *reinterpret_cast<const float4*>(tv + i);
    const float4 x = *reinterpret_cast<const float4*>(xn + i);
    const float4 a4 = has0 ? *reinterpret_cast<const float4*>(a0p + i) : zero;
    const float4 c4 = has1 ? *reinterpret_cast<const float4*>(a1p + i) : zero;
    float tk[4] = {t.x, t.y, t.z, t.w}, xk[4] = {x.x, x.y, x.z, x.w};
    float av[4] = {a4.x, a4.y, a4.z, a4.w}, cv[4] = {c4.x, c4.y, c4.z, c4.w};
    if (i >= full && i + 4 <= nr) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (up0) av[k] = fmaf(-tk[k], w0, av[k]);
        if (up1) cv[k] = fmaf(-tk[k], w1, cv[k]);
        if (want_sq) sq = fmaf(xk[k], xk[k], sq);
        y0 = fmaf(xk[k], av[k], y0);
        y1 = fmaf(xk[k], cv[k], y1);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int li = i + k, gi = lo + li;
        if (li < s0 || li >= nr) continue;
        if (up0) av[k] = fmaf(-tk[k], w0, av[k]);
        if (up1) cv[k] = fmaf(-tk[k], w1, cv[k]);
        if (want_sq && gi >= np) sq = fmaf(xk[k], xk[k], sq);
        if (gi > np) {
          y0 = fmaf(xk[k], av[k], y0);
          y1 = fmaf(xk[k], cv[k], y1);
        } else if (gi == np) {  // the next pivot's row
          if (has0) sm.out[1 + c0] = av[k];
          if (has1) sm.out[1 + c0 + 1] = cv[k];
        }
      }
    }
    if (up0)
      *reinterpret_cast<float4*>(a0p + i) = make_float4(av[0], av[1], av[2], av[3]);
    if (up1)
      *reinterpret_cast<float4*>(a1p + i) = make_float4(cv[0], cv[1], cv[2], cv[3]);
  }
  for (int o = 4; o > 0; o >>= 1) {
    y0 += __shfl_down_sync(0xffffffffu, y0, o, 8);
    y1 += __shfl_down_sync(0xffffffffu, y1, o, 8);
    sq += __shfl_down_sync(0xffffffffu, sq, o, 8);
  }
  if (q == 0) {
    if (has0) sm.out[1 + b + c0] = y0;
    if (has1) sm.out[1 + b + c0 + 1] = y1;
    if (want_sq && g == 0) sm.out[0] = sq;
  }
}

// T of the compact WY form from the taus and G = Y^T Y (T's strict lower
// triangle holds G^T on entry), by 32-column blocks: each diagonal block
// by the forward recurrence T[:j, j] = -tau_j T[:j, :j] G[:j, j],
// T[j, j] = tau_j (the blocks at once, four threads a row), then, block
// column by block column, T[:L0, L] = -T[:L0, :L0] (G[:L0, L] T[L, L])
// for the block L starting at column L0, which is the same recurrence
// applied to the blocks. Every sum runs in index order. Reads G^T from the
// strict lower triangle of G (which may be T itself), then writes T; uses
// team_t_floats(b) floats of shared memory at `work`.
template <class E>
__device__ inline void team_t(const float* G, E* T, int b, float* work,
                              const float* taus) {
  constexpr int NB = 32;
  const int tid = threadIdx.x, tb = b + 1;
  float* Gt = work;            // b * b, row j holds G[:j, j]
  float* Ts = Gt + b * b;      // b * (b + 1), padded rows
  float* M = Ts + b * tb;      // (b - NB) x NB: G[:L0, L] T[L, L]
  for (int e = tid; e < b * b; e += QR_THREADS)
    Gt[e] = e % b < e / b ? G[e] : 0.f;
  for (int e = tid; e < b * tb; e += QR_THREADS) Ts[e] = 0.f;
  __syncthreads();
  // the diagonal blocks: block k on threads [128k, 128k + 128), row
  // 32k + t on threads 4t .. 4t + 3 of them
  {
    const int k = tid / (4 * NB), t = NB * k + (tid % (4 * NB)) / 4, q = tid & 3;
    for (int jj = 0; jj < NB; ++jj) {
      const int j = NB * k + jj;
      float s = 0.f;
      if (t < j && j < b) {  // T is upper triangular: the terms i < t are 0
#pragma unroll 8
        for (int i = t + q; i < j; i += 4)
          s = fmaf(Ts[t * tb + i], Gt[j * b + i], s);
      }
      s += __shfl_down_sync(0xffffffffu, s, 2, 4);
      s += __shfl_down_sync(0xffffffffu, s, 1, 4);
      if (j < b) {
        if (t < j && q == 0) Ts[t * tb + j] = -taus[j] * s;
        if (t == j && q == 0) Ts[j * tb + j] = taus[j];
      }
      __syncthreads();
    }
  }
  for (int L0 = NB; L0 < b; L0 += NB) {
    const int nc = min(NB, b - L0);
    for (int e = tid; e < L0 * nc; e += QR_THREADS) {
      const int r = e / nc, c = L0 + e % nc;
      float s = 0.f;
      for (int k = L0; k <= c; ++k) s = fmaf(Gt[k * b + r], Ts[k * tb + c], s);
      M[e] = s;
    }
    __syncthreads();
    for (int e = tid; e < L0 * nc; e += QR_THREADS) {
      const int r = e / nc, c = e % nc;
      float s = 0.f;
      for (int k = r; k < L0; ++k) s = fmaf(Ts[r * tb + k], M[k * nc + c], s);
      Ts[r * tb + L0 + c] = -s;
    }
    __syncthreads();
  }
  for (int e = tid; e < b * b; e += QR_THREADS)
    T[e] = narrow<E>(Ts[(e / b) * tb + e % b]);
}

// One team block's share of the masked QR of the (m x b) panel A (row
// stride a_ld, unit column stride): rows [rank * rows, ...) of team_rows(m,
// C). Writes this block's rows of Y and R; rank 0 writes T (the strict
// lower triangle of G, T itself at float, holds G^T during the loop).
// kSlabInSmem =
// team_slab_in_smem(m, b, C); when false, slab_g is this block's slab in
// global scratch (team_cols(b) x team_ld floats, 16-byte aligned). Both
// instances run the same arithmetic through the same float* S; the flag
// only lets the compiler see that S is in shared memory, so that it
// addresses it as such (32-bit shared loads, not generic 64-bit ones).
// Needs team_smem_floats(m, b, C, kSlabInSmem) floats at smem (16-byte
// aligned).
template <bool kSlabInSmem, class Ex, class E>
__device__ void team_qr(const E* A, long long a_ld, E* Y, E* T, E* R,
                        float* G, int m, int b, int rs, int C, int rank,
                        float* slab_g, float* smem, Ex& ex) {
  const int tid = threadIdx.x;
  const int rows = team_rows(m, C), ld = team_ld(rows);
  const int lo = min(rank * rows, m), nr = min(rows, m - lo);
  const TeamSmem sm(smem, m, b, C, kSlabInSmem);
  float* S = kSlabInSmem ? sm.region : slab_g;
  float* tv = S + (size_t)b * ld;        // tau v_i of the current column
  float* xn = S + (size_t)(b + 1) * ld;  // column j + 1, updated
  // first local row at or below global row `row`
  auto first_local = [&](int row) { return min(max(row - lo, 0), nr); };

  for (int e = tid; e < nr * b; e += QR_THREADS) {
    const int i = e / b, c = e % b;
    S[(size_t)c * ld + i] = widen(A[(size_t)(lo + i) * a_ld + c]);
  }
  __syncthreads();
  auto holds = [&](int row) { return row >= lo && row < lo + nr; };
  // column 0's sums: a pass with no update
  for (int i = first_local(rs) + tid; i < nr; i += QR_THREADS) xn[i] = S[i];
  __syncthreads();
  team_pass(S, ld, lo, nr, first_local(rs), b, -1, false, rs, sm);
  __syncthreads();
  team_send(ex, sm, b, C, 0, holds(rs));

  for (int j = 0; j < b; ++j) {
    const int p = rs + j, par = j & 1;
    ex.sync(par);  // column j's sums are out
    const int owner = (p >= 0 && p < m) ? p / rows : -1;
    const int s0 = first_local(p), nxt = j + 1;
    // w_c = v^T A[:, c] (c > j) and G[c, j] (c < j)
    auto w_of = [&](int c, float denom) {
      const float ap = owner >= 0 ? team_get(sm.slots, b, par, owner, 1 + c) : 0.f;
      return ap + rank_sum(sm.slots, b, C, par, 1 + b + c) / denom;
    };
    if (tid < 32) {  // warp 0: the reflector's scalars, and w of column j + 1
      const float sumsq = rank_sum(sm.slots, b, C, par, 0);
      const float x0 =
          owner >= 0 ? team_get(sm.slots, b, par, owner, 1 + j) : 0.f;
      const float sigma = sumsq - x0 * x0;
      const float norm = sqrtf(x0 * x0 + sigma);
      const float beta = (x0 >= 0.f) ? -norm : norm;
      const bool degenerate = norm <= 1e-30f;
      const float denom = degenerate ? 1.f : x0 - beta;
      const float tau = degenerate ? 0.f : (beta - x0) / beta;
      const float wn = nxt < b && tau != 0.f ? w_of(nxt, denom) : 0.f;
      if (tid == 0) {
        sm.taus[j] = tau;
        sm.rdiag[j] = degenerate ? x0 : beta;
        sm.scal[0] = denom, sm.scal[1] = tau, sm.scal[2] = wn;
      }
    }
    __syncthreads();
    const float denom = sm.scal[0], tau = sm.scal[1], wn = sm.scal[2];
    if (tid < TEAM_W_THREADS) {  // w and G
      for (int c = tid; c < b; c += TEAM_W_THREADS) {
        if (c == j) continue;
        const float s = c == nxt ? wn : w_of(c, denom);
        sm.w[c] = s;
        if (rank == 0 && c < j) G[(size_t)j * b + c] = s;  // G[c, j]
      }
    } else {
      // v over this block's rows at and below the pivot, in place of
      // column j; beside it tau v_i and column j + 1 updated
      float* v = S + (size_t)j * ld;
      for (int i = s0 + tid - TEAM_W_THREADS; i < nr;
           i += QR_THREADS - TEAM_W_THREADS) {
        const float vi = lo + i == p ? 1.f : v[i] / denom;
        v[i] = vi;
        if (nxt < b) {
          const float t = tau * vi;
          tv[i] = t;
          xn[i] = tau != 0.f ? fmaf(-t, wn, S[(size_t)nxt * ld + i])
                             : S[(size_t)nxt * ld + i];
        }
      }
    }
    __syncthreads();
    if (nxt < b) {
      team_pass(S, ld, lo, nr, s0, b, j, tau != 0.f, p + 1, sm);
      __syncthreads();
      team_send(ex, sm, b, C, nxt & 1, holds(p + 1));
    }
  }
  __syncthreads();

  // Y: v below the pivots, zero above
  for (int e = tid; e < nr * b; e += QR_THREADS) {
    const int i = e / b, c = e % b;
    Y[(size_t)(lo + i) * b + c] =
        narrow<E>(lo + i < rs + c ? 0.f : S[(size_t)c * ld + i]);
  }
  // R: rows [rs', rs' + b) that this block holds, rs' = clamp(rs, 0, m - b)
  const int rstart = rs < 0 ? 0 : (rs > m - b ? m - b : rs);
  const int r0 = max(rstart, lo) - rstart, r1 = min(rstart + b, lo + nr) - rstart;
  for (int e = r0 * b + tid; e < r1 * b; e += QR_THREADS) {
    const int r = e / b, c = e % b, i = rstart + r, pv = rs + c;
    R[e] = narrow<E>(r > c ? 0.f
                     : i < pv ? S[(size_t)c * ld + (i - lo)]
                     : i == pv ? sm.rdiag[c] : 0.f);
  }

  if (rank == 0) {
    __syncthreads();  // the slab is read; the region now holds G^T and T
    team_t(G, T, b, sm.region, sm.taus);
  }
}

// -- K3's body: the structured QR of two stacked triangles ------------------
//
// K3 (src/repro/kernels/stacked_qr.py::stacked_qr) is the QR of the (2b x b)
// stack S = [triu(Rt); triu(Rb)] with row_start 0, LAPACK tpqrt's case:
// column j's reflector has support top row j and bottom rows 0..j. Its top
// rows > j start as zeros of Rt's triangle and its bottom rows > j as zeros
// of Rb's, and no earlier reflector k < j writes them (reflector k's
// support is top row k and bottom rows 0..k); so with x the bottom rows
// 0..j of column j, v_j = e_j + x / denom and every other entry of v_j is
// an exact zero. For the columns c > j, w_c = S[j, c] + sum_{i <= j} v_i
// S[b + i, c] and the rank-1 update therefore need only those j + 2 rows,
// and the columns left of the pivot, which no output reads, are skipped
// (as in team_qr).
//
// One block of QR_THREADS threads holds S in shared memory, column-major.
// Thread t takes column c = t / 4 and, of each column's bottom half, the
// four consecutive rows 16k + 4g .. 16k + 4g + 3 for k = 0, 1, ... (g = t %
// 4), as one 16-byte access; a step covers the support rounded up to whole
// 16-row chunks. The pivot's rows past the support are zeros of Rb's
// triangle, so the terms the rounding adds are fmaf(0, x, s) = s and
// x - (0 tau / denom) w = x: the rows outside the support keep their
// values, as the reference's x - tau 0 w leaves them. During the loop a
// column's bottom rows are held in its four threads' registers (loaded
// once, written back at the end), so that a step does not pass the whole
// active stack through shared memory twice; only the pivot's rows go
// through it, written back by column j + 1's threads after their update in
// step j.
//
// One barrier a column. In step j every column's group reads the pivot's
// x from shared memory and forms, each in the same order, ||x||^2 (so every
// group holds the same beta, tau and denom, and no group waits for another
// to publish them, as in team_qr) and its own sum: for c > j, y_c =
// sum x_i S[b + i, c], then w_c = S[j, c] + y_c / denom (the division after
// the sum, as team_qr does; |denom| >= |x_i| keeps the error at the
// reference's level) and the update S[b + i, c] -= (tau / denom) x_i w_c,
// S[j, c] -= tau w_c; for c < j, z = Y2[:, c]^T x, which gives G[c, j] =
// Y2[:, c]^T v_j = z / denom in T's strict lower triangle in step j + 1,
// once column j's threads have published 1 / denom (Y = [I; Y2]: the
// identity rows add nothing off the diagonal); for c = j, v = x (1 /
// denom). A thread's sum is four chains (the four rows of its chunks)
// added in a fixed order, then a fixed xor tree over its group's four
// threads, which leaves all four the same bits. After the loop S holds R's
// strict upper triangle and Y2; R's diagonal is beta (x0 for a degenerate
// column); T comes from team_t. The sums depend on (the inputs, b) alone,
// so the two lanes of a butterfly pair, which receive the same (Rt, Rb),
// give the same bits in any launch, and K6's phase 2, which runs this body,
// equals K3.

constexpr int SQ_GROUP = 4;   // threads of a column in stacked_qr_lane
constexpr int SQ_CHUNK = 16;  // rows of a column the group takes per float4
constexpr int SQ_CHUNKS = QR_MAX_B / SQ_CHUNK;  // chunks of a column, at most
static_assert(QR_THREADS == SQ_GROUP * QR_MAX_B, "a thread group per column");
static_assert(SQ_CHUNK == 4 * SQ_GROUP, "a float4 of rows per thread");

// Layout of the stack in shared memory: column c at c * ld, its top rows
// 0..b-1 from 0 and its bottom rows from bo (16-byte aligned), the bottom
// half padded with zeros to whole chunks; ld is 16 more than a multiple of
// 32, so that a quarter warp's 16-byte reads (two columns) meet 32 banks.
struct StackLayout {
  int b, bo, b16, ld;
  __host__ __device__ explicit StackLayout(int b_)
      : b(b_), bo((b_ + 3) / 4 * 4),
        b16((b_ + SQ_CHUNK - 1) / SQ_CHUNK * SQ_CHUNK),
        ld((bo + b16 - 16 + 31) / 32 * 32 + 16) {}
  // floats before the stack (16-byte aligned): the taus, R's diagonal and
  // each column's 1 / denom
  __host__ __device__ size_t head() const { return (3 * (size_t)b + 3) / 4 * 4; }
};

// Floats of shared memory stacked_qr_lane needs: the head, then the stack
// (after the loop, team_t's scratch).
__host__ __device__ inline size_t stacked_smem_floats(int b) {
  const StackLayout L(b);
  const size_t stack = (size_t)b * L.ld, tt = team_t_floats(b);
  return L.head() + (stack > tt ? stack : tt);
}

__device__ __forceinline__ float4 ld4s(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4s(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// K3's body for one lane: (Y2, T, R) of QR([triu(Rt); triu(Rb)]), all
// (b x b) row-major (the strict lower triangles of Rt and Rb are not
// used); G (b x b floats, T itself at float) holds G^T during the loop.
// Needs stacked_smem_floats(b) floats of shared memory at smem (16-byte
// aligned); ends with a barrier, after which smem may be reused.
template <class E>
__device__ inline void stacked_qr_lane(const E* Rt, const E* Rb, E* Y2, E* T,
                                       E* R, float* G, int b, float* smem) {
  const int tid = threadIdx.x;
  const StackLayout L(b);
  const int ld = L.ld, bo = L.bo, b16 = L.b16;
  const int c = tid / SQ_GROUP, g = tid % SQ_GROUP;
  float* taus = smem;       // b
  float* rdiag = taus + b;  // b: R's diagonal
  float* rinvs = rdiag + b; // b: 1 / denom
  float* S = smem + L.head();
  float* col = S + (size_t)(c < b ? c : 0) * ld;  // this thread's column
  float* bot = col + bo + SQ_GROUP * g;  // its rows 4g.. of the bottom half

  // The row-major (b x b) inputs and outputs meet the column-major stack in
  // tiles of 8 rows x 4 columns, one a warp: 16-byte segments of a row in
  // global memory, at most two threads a bank in shared memory.
  const int ct = (b + 3) / 4, tiles = (b + 7) / 8 * ct;
  auto for_tiles = [&](auto&& f) {
    for (int e = tid; e < tiles * 32; e += QR_THREADS) {
      const int t = e / 32, l = e % 32;
      const int r = t / ct * 8 + l / 4, cc = t % ct * 4 + l % 4;
      if (r < b && cc < b) f(r, cc, r * b + cc);
    }
  };
  for (int e = tid; e < b * (b16 - b); e += QR_THREADS)
    S[(size_t)(e / (b16 - b)) * ld + bo + b + e % (b16 - b)] = 0.f;
  for_tiles([&](int r, int cc, int e) {
    const bool up = r <= cc;
    S[(size_t)cc * ld + r] = up ? widen(Rt[e]) : 0.f;
    S[(size_t)cc * ld + bo + r] = up ? widen(Rb[e]) : 0.f;
  });
  __syncthreads();

  // xr: this column's chunks (its rows past c are zeros), held for the
  // whole loop; xp: the pivot's, read each step (constant indices after
  // unrolling, so both stay in registers), loaded together, so that a step
  // waits on one load latency, not one a chunk.
  float4 xp[SQ_CHUNKS], xr[SQ_CHUNKS];
#pragma unroll
  for (int k = 0; k < SQ_CHUNKS; ++k) {
    if (SQ_CHUNK * k > c || c >= b) break;
    xr[k] = ld4s(bot + SQ_CHUNK * k);
  }
  float z = 0.f;  // Y2[:, c]^T x of the step before, for G
  for (int j = 0; j < b; ++j) {
    if (g == 0 && c < j - 1) G[(size_t)(j - 1) * b + c] = z * rinvs[j - 1];
    const bool upd = c < b && c > j, gram = c < j;
    const int last = upd ? j : gram ? c : -1;  // this column's rows in play
    const int plast = gram ? c : j;            // the pivot's rows it reads
    const float* pivot = S + (size_t)j * ld;
    const float x0 = pivot[j];
    const float top = upd ? col[j] : 0.f;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f), y = q;
#pragma unroll
    for (int k = 0; k < SQ_CHUNKS; ++k) {
      if (SQ_CHUNK * k > plast) break;
      const float4 x = ld4s(pivot + bo + SQ_GROUP * g + SQ_CHUNK * k);
      xp[k] = x;
      if (!gram) {  // G needs no norm
        q.x = fmaf(x.x, x.x, q.x);
        q.y = fmaf(x.y, x.y, q.y);
        q.z = fmaf(x.z, x.z, q.z);
        q.w = fmaf(x.w, x.w, q.w);
      }
      if (last >= 0) {
        y.x = fmaf(x.x, xr[k].x, y.x);
        y.y = fmaf(x.y, xr[k].y, y.y);
        y.z = fmaf(x.z, xr[k].z, y.z);
        y.w = fmaf(x.w, xr[k].w, y.w);
      }
    }
    float sq = (q.x + q.y) + (q.z + q.w), ys = (y.x + y.y) + (y.z + y.w);
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    ys += __shfl_xor_sync(0xffffffffu, ys, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    ys += __shfl_xor_sync(0xffffffffu, ys, 2);
    __syncwarp();  // the group has read S[j, c] before g = 0 writes it
    if (upd || c == j) {
      const float norm = sqrtf(x0 * x0 + sq);
      const float beta = (x0 >= 0.f) ? -norm : norm;
      const bool degenerate = norm <= 1e-30f;
      const float denom = degenerate ? 1.f : x0 - beta;
      const float tau = degenerate ? 0.f : (beta - x0) / beta;
      const float rinv = 1.f / denom;
      if (upd) {
        const float w = top + ys * rinv;
        if (tau != 0.f) {  // tau = 0 leaves the column as it is
          const float tw = tau * rinv * w;  // x_i tw = tau v_i w_c
#pragma unroll
          for (int k = 0; k < SQ_CHUNKS; ++k) {
            if (SQ_CHUNK * k > j) break;
            float4& x = xr[k];
            x.x = fmaf(-xp[k].x, tw, x.x);
            x.y = fmaf(-xp[k].y, tw, x.y);
            x.z = fmaf(-xp[k].z, tw, x.z);
            x.w = fmaf(-xp[k].w, tw, x.w);
          }
          if (g == 0) col[j] = fmaf(-tau, w, top);
        }
        if (c == j + 1) {  // the next pivot's rows, for every group to read
#pragma unroll
          for (int k = 0; k < SQ_CHUNKS; ++k) {
            if (SQ_CHUNK * k > j) break;
            st4s(bot + SQ_CHUNK * k, xr[k]);
          }
        }
      } else {  // the pivot's v, and its scalars
#pragma unroll
        for (int k = 0; k < SQ_CHUNKS; ++k) {
          if (SQ_CHUNK * k > j) break;
          xr[k] = make_float4(xp[k].x * rinv, xp[k].y * rinv, xp[k].z * rinv,
                              xp[k].w * rinv);
        }
        if (g == 0) {
          taus[j] = tau;
          rdiag[j] = degenerate ? x0 : beta;
          rinvs[j] = rinv;
        }
      }
    } else if (gram) {
      z = ys;
    }
    __syncthreads();
  }
  if (g == 0 && c < b - 1) G[(size_t)(b - 1) * b + c] = z * rinvs[b - 1];
#pragma unroll
  for (int k = 0; k < SQ_CHUNKS; ++k) {  // Y2: every column's v
    if (SQ_CHUNK * k > c || c >= b) break;
    st4s(bot + SQ_CHUNK * k, xr[k]);
  }
  __syncthreads();

  for_tiles([&](int r, int cc, int e) {
    R[e] = narrow<E>(r < cc    ? S[(size_t)cc * ld + r]
                     : r == cc ? rdiag[r] : 0.f);
    Y2[e] = narrow<E>(r <= cc ? S[(size_t)cc * ld + bo + r] : 0.f);
  });
  __syncthreads();  // the stack is read; its region now holds team_t's scratch
  team_t(G, T, b, S, taus);
  __syncthreads();
}

// -- K2's and K4's tile: a register-tiled FFMA engine ------------------------
//
// K2 (src/repro/kernels/wy_apply.py::wy_apply) and K4
// (src/repro/kernels/stacked_qr.py::stacked_apply) are the same problem: a
// chain of three products of depth b over a slab of BN columns,
//     K2: W1 = Y^T C (over the m rows), W = T^T W1, out = C - Y W;
//     K4: inner = Ct + Y2^T Cb, W = T^T inner, ot = Ct - W, ob = Cb - Y2 W,
// which is K2's chain with Y = Y2 (b rows) and Ct added in two places. One
// engine runs both, one block of 256 threads per (lane, BN-column tile).
//
// What bounds them on the H100: at b = 128 both do far more FP32 FFMAs
// than bytes (K2 4mbn + b^2 n operations on 8mn bytes of C; K4 3b^2 n on
// 20bn bytes), so the card's 67 TFLOP/s of FFMA; TF32 tensor cores break
// the 3e-4 tolerance. An FFMA kernel reaches that rate only if each
// operand it loads from shared memory feeds several FMAs and the loads
// from L2 and HBM overlap the arithmetic. So:
//   * each thread holds a TM x TN block of the outputs in registers (8 x 8
//     at BN = 128) and reads its operands as float4 from shared memory;
//   * operands arrive in slices of 16 to 64 rows of the reduction (deeper
//     for narrower tiles) through a double buffer filled by cp.async, so
//     the next slice loads while one is multiplied; each thread's copy
//     addresses are worked out once per tile, not once per slice;
//   * W1 (then the intermediate, then W) stays in shared memory between the
//     three products, so C is read twice and written once, never W1 or W;
//   * BN (128, 64 or 32 columns) is chosen per launch so that the grid
//     fills the SMs (backend.tile_bn): late panels and one-lane replays
//     have few columns;
//   * K4 skips the slices that meet only the exact zeros of the upper
//     triangular Y2 and T, half its FMAs.
//
// The order rule that keeps the bits: every output element is one
// sequential fmaf chain in increasing index order, started at 0,
//     W1[q,c]  = sum_i Y[i,q] C[i,c]            (i = 0..m-1),
//     W[r,c]   = sum_q T[q,r] W1[q,c],
//     out[i,c] = C[i,c] - sum_q Y[i,q] W[q,c];
//     K4: inner[r,c] = Ct[r,c] + (sum_q Y2[q,r] Cb[q,c]) (the sum first),
//         W = sum_q T[q,r] inner[q,c], ot = Ct - W, ob = Cb - sum_q Y2[r,q] W[q,c].
// Which thread computes an element, BN, the lane and the launch size do not
// enter any sum, so a lane gives the same bits alone as in any launch and
// the fused K5/K6, which run these bodies two to a block, agree bit for
// bit with K2 and K4. Zero padding (rows past m, columns past n or b) and
// the skipped triangle add fmaf(0, x, acc) == acc for finite inputs. No
// split of the reduction, no atomics, no tensor cores.

constexpr int TILE_THREADS = 256;
constexpr int TILE_M = 128;          // the b side of every product (b <= 128)
constexpr int TILE_STAGES = 2;       // slices in the cp.async ring

// Reduction rows of one staged slice: a narrower tile takes deeper slices,
// so that its arithmetic per slice still outweighs the slice's fixed cost
// (the copies' issue, the barrier).
__host__ __device__ constexpr int tile_bk(int bn) {
  return bn >= 128 ? 16 : bn >= 64 ? 32 : 64;
}

// Row stride of a row-layout slice (padded against bank conflicts).
__host__ __device__ constexpr int tile_as(int bn) { return tile_bk(bn) + 4; }

// Floats of one ring stage: a k-major slice of the b side plus a slice of
// BN columns (W1 = Y^T C), or a row-layout block of Y (out = C - Y W).
__host__ __device__ constexpr int tile_stage_floats(int bn) {
  return tile_bk(bn) * (TILE_M + bn) > TILE_M * tile_as(bn)
             ? tile_bk(bn) * (TILE_M + bn)
             : TILE_M * tile_as(bn);
}

// Floats of shared memory one tile needs: the b x BN intermediate and the ring.
__host__ __device__ constexpr int tile_smem_floats(int bn) {
  return TILE_M * bn + TILE_STAGES * tile_stage_floats(bn);
}

// The thread layout of a BN-column tile: TY x TX threads, each with TM rows
// (TM / 4 groups of 4 consecutive rows, TY * 4 apart) and TN columns (TN / 4
// groups of 4, TX * 4 apart), so a warp's float4 reads of a slice row are
// consecutive in shared memory.
template <int BN>
struct TileShape {
  static constexpr int TN = BN >= 64 ? 8 : 4;
  static constexpr int TX = BN / TN;
  static constexpr int TY = TILE_THREADS / TX;
  static constexpr int TM = TILE_M / TY;
  static constexpr int BK = tile_bk(BN);
  static constexpr int AS = tile_as(BN);
  static constexpr int STAGE = tile_stage_floats(BN);
  static_assert(TM % 4 == 0 && TN % 4 == 0 && TY * TM == TILE_M,
                "float4 fragments covering the tile");
  static_assert(BK % 8 == 0 && BK * BN % 1024 == 0,
                "each thread copies whole rows' worth of 16-byte units");
};

template <int BN>
using TileAcc = float[TileShape<BN>::TM][TileShape<BN>::TN];

__device__ __forceinline__ float lane4(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The slices a tile stages, each a block of an (nrows x ncols) matrix with
// row stride ld, zero outside the matrix:
//   rows   rows [row0, row0 + BK), columns [0, TILE_M) -> dst[BK][TILE_M];
//   cols   rows [row0, row0 + BK), columns [col0, col0 + BN) -> dst[BK][BN];
//   block  rows [row0, row0 + TILE_M), columns [col0, col0 + BK)
//          -> dst[TILE_M][AS].
// CopyPlan copies them in units of four elements when every stride,
// width and pointer allows: unit u of a thread covers row first + u * step
// of the slice and four columns from its fixed column, all worked out once
// per tile. A unit is one 16-byte cp.async. load_scalar copies any of them
// element by element through L2.
struct CopyPlan {
  int first, step, col;
  __device__ CopyPlan(int per_row, int tid)
      : first(tid / per_row), step(TILE_THREADS / per_row),
        col((tid % per_row) * 4) {}

  // UNITS copies of four elements into dst (row stride dld) from src: row
  // k of the slice is row row0 + k of src, column c is column col0 + c.
  template <int UNITS>
  __device__ __forceinline__ void copy(float* dst, int dld, const float* src,
                                       long long ld, int row0, int nrows,
                                       int col0, int ncols) const {
    const bool col_ok = col0 + col < ncols;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int k = first + u * step, r = row0 + k;
      const bool ok = col_ok && r < nrows;
      cp_async16(dst + k * dld + col,
                 ok ? src + (size_t)r * ld + col0 + col : src, ok ? 16 : 0);
    }
  }
};

template <class E>
__device__ inline void load_scalar(float* dst, int dld, int rows, int cols,
                                   const E* src, long long ld, int row0,
                                   int nrows, int col0, int ncols, int tid) {
  for (int u = tid; u < rows * cols; u += TILE_THREADS) {
    const int k = u / cols, c = u % cols, r = row0 + k, col = col0 + c;
    dst[k * dld + c] =
        (r < nrows && col < ncols) ? ldcg1(src + (size_t)r * ld + col) : 0.f;
  }
}

// acc[row][col] += sum over the slice's k of A[k][row] * B[k][col], in k
// order: A is k-major (a slice row holds the b side), B is k-major with row
// stride BN. TRI: A is the slice of an upper triangular factor (A[k][row]
// = 0 for q0 + k > row), so a group of rows that the slice meets only in
// that triangle is skipped.
template <int BN, bool TRI>
__device__ __forceinline__ void mma_kmajor(TileAcc<BN>& acc, const float* A,
                                           const float* B, int q0, int ty,
                                           int tx) {
  using S = TileShape<BN>;
  constexpr int G = S::TM / 4, H = S::TN / 4;
#pragma unroll
  for (int g = 0; g < (TRI ? G : 1); ++g) {
    if (TRI && q0 > g * S::TY * 4 + ty * 4 + 3) continue;
#pragma unroll
    for (int k = 0; k < S::BK; ++k) {
      float a[S::TM], bv[S::TN];
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        if (TRI && gg != g) continue;
        const float4 t = *reinterpret_cast<const float4*>(
            A + k * TILE_M + gg * S::TY * 4 + ty * 4);
        a[4 * gg] = t.x, a[4 * gg + 1] = t.y, a[4 * gg + 2] = t.z,
        a[4 * gg + 3] = t.w;
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float4 t = *reinterpret_cast<const float4*>(
            B + k * BN + h * S::TX * 4 + tx * 4);
        bv[4 * h] = t.x, bv[4 * h + 1] = t.y, bv[4 * h + 2] = t.z,
        bv[4 * h + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < S::TM; ++i) {
        if (TRI && i / 4 != g) continue;
#pragma unroll
        for (int j = 0; j < S::TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
  }
}

// acc[row][col] += sum over the slice's k of A[row][k] * B[k][col], in k
// order: A is a row-layout block (row stride S::AS), B k-major with row
// stride BN. TRI: A is a slice of columns q0.. of an upper triangular
// factor (A[row][k] = 0 for q0 + k < row), so a group of rows the slice
// meets only below the diagonal is skipped.
template <int BN, bool TRI>
__device__ __forceinline__ void mma_rows(TileAcc<BN>& acc, const float* A,
                                         const float* B, int q0, int ty,
                                         int tx) {
  using S = TileShape<BN>;
  constexpr int G = S::TM / 4, H = S::TN / 4;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int r0 = g * S::TY * 4 + ty * 4;
    if (TRI && q0 + S::BK - 1 < r0) continue;
#pragma unroll
    for (int k4 = 0; k4 < S::BK; k4 += 4) {
      float4 a4[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        a4[jj] = *reinterpret_cast<const float4*>(A + (r0 + jj) * S::AS + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[S::TN];
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float4 t = *reinterpret_cast<const float4*>(
              B + (k4 + kk) * BN + h * S::TX * 4 + tx * 4);
          bv[4 * h] = t.x, bv[4 * h + 1] = t.y, bv[4 * h + 2] = t.z,
          bv[4 * h + 3] = t.w;
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float a = lane4(a4[jj], kk);
#pragma unroll
          for (int j = 0; j < S::TN; ++j)
            acc[4 * g + jj][j] = fmaf(a, bv[j], acc[4 * g + jj][j]);
        }
      }
    }
  }
}

// Four consecutive elements at (r, col..col+3) of an (nrows x ncols)
// matrix with row stride ld, zero outside; vec: one aligned access.
template <class E>
__device__ __forceinline__ float4 ld4(const E* p, long long ld, int r,
                                      int nrows, int col, int ncols, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= nrows || col >= ncols) return v;
  const E* q = p + (size_t)r * ld + col;
  if (vec) return ldcg4(q);
  v.x = ldcg1(q);
  if (col + 1 < ncols) v.y = ldcg1(q + 1);
  if (col + 2 < ncols) v.z = ldcg1(q + 2);
  if (col + 3 < ncols) v.w = ldcg1(q + 3);
  return v;
}

// Store the elements of v that fall inside the matrix (see ld4).
template <class E>
__device__ __forceinline__ void st4(E* p, long long ld, int r, int nrows,
                                    int col, int ncols, bool vec, float4 v) {
  if (r >= nrows || col >= ncols) return;
  E* q = p + (size_t)r * ld + col;
  if (vec) {
    stv4(q, v);
    return;
  }
  q[0] = narrow<E>(v.x);
  if (col + 1 < ncols) q[1] = narrow<E>(v.y);
  if (col + 2 < ncols) q[2] = narrow<E>(v.z);
  if (col + 3 < ncols) q[3] = narrow<E>(v.w);
}

// The engine. Yf: R x b reflectors (row stride b); T: b x b; Cin: R x n
// (row stride c_ld) from column col0; out: R x n (row stride o_ld) gets
// Cin - Yf W. K4 (R = b): Ct, ot and Wout share Cin's row stride, and
// the intermediate is Ct + Yf^T Cin. Runs TILE_THREADS threads (tid) that
// synchronise on barrier bar_id only; needs tile_smem_floats(BN) floats at
// smem (16-byte aligned). VEC: every row stride, n, b and pointer allow
// accesses of four elements (a compile-time choice: the scalar path's
// registers would otherwise spill the vector path's). E: float (at bf16
// the tiles run wg_apply_engine below). Ends with a barrier, after which
// smem may be reused and the tile's global writes are visible to its
// threads.
template <int BN, bool K4, bool VEC, class E>
__device__ void apply_engine(const E* Yf, int R, const E* T, int b,
                             const E* Cin, long long c_ld, E* out,
                             long long o_ld, const E* Ct, E* ot, E* Wout,
                             int n, int col0, int tid, int bar_id,
                             float* smem) {
  using S = TileShape<BN>;
  float* buf = smem;                // TILE_M x BN: W1 (or inner), then W
  float* ring = smem + TILE_M * BN; // TILE_STAGES slices
  const int ty = tid / S::TX, tx = tid % S::TX;
  constexpr int BK = S::BK;
  const int nA = (R + BK - 1) / BK;  // slices of W1 = Y^T C
  const int nB = (b + BK - 1) / BK;  // slices of W = T^T W1, and of each
                                     // row block of Y W
  const int total = nA + nB + ((R + TILE_M - 1) / TILE_M) * nB;

  // The copy plans of the three kinds of slice, and the next phase-C
  // slice to issue (row block, slice of q): slices are issued in order.
  const CopyPlan rows_plan(TILE_M / 4, tid), cols_plan(BN / 4, tid),
      block_plan(BK / 4, tid);
  int issue_blk = 0, issue_qs = 0;
  auto issue = [&](int s) {
    float* st = ring + (s % TILE_STAGES) * S::STAGE;
    float* st_c = st + BK * TILE_M;
    if (s < nA) {
      if constexpr (VEC) {
        rows_plan.copy<BK / 8>(st, TILE_M, Yf, b, s * BK, R, 0, b);
        cols_plan.copy<BK * BN / 1024>(st_c, BN, Cin, c_ld, s * BK, R, col0, n);
      } else {
        load_scalar(st, TILE_M, BK, TILE_M, Yf, b, s * BK, R, 0, b, tid);
        load_scalar(st_c, BN, BK, BN, Cin, c_ld, s * BK, R, col0, n, tid);
      }
    } else if (s < nA + nB) {
      const int q0 = (s - nA) * BK;
      if constexpr (VEC) rows_plan.copy<BK / 8>(st, TILE_M, T, b, q0, b, 0, b);
      else load_scalar(st, TILE_M, BK, TILE_M, T, b, q0, b, 0, b, tid);
    } else {
      const int row0 = issue_blk * TILE_M, q0 = issue_qs * BK;
      if constexpr (VEC) block_plan.copy<BK / 8>(st, S::AS, Yf, b, row0, R, q0, b);
      else load_scalar(st, S::AS, TILE_M, BK, Yf, b, row0, R, q0, b, tid);
      if (++issue_qs == nB) issue_qs = 0, ++issue_blk;
    }
  };
  // acc -> buf (plus Ct for K4's intermediate), and K4's W and ot.
  auto to_buf = [&](TileAcc<BN>& acc, bool add_ct, bool emit_w) {
#pragma unroll
    for (int i = 0; i < S::TM; ++i) {
      const int r = (i / 4) * S::TY * 4 + ty * 4 + i % 4;
#pragma unroll
      for (int h = 0; h < S::TN / 4; ++h) {
        const int c = h * S::TX * 4 + tx * 4;
        float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                               acc[i][4 * h + 2], acc[i][4 * h + 3]);
        if (K4 && (add_ct || emit_w)) {
          const float4 ct = ld4(Ct, c_ld, r, b, col0 + c, n, VEC);
          if (add_ct) {
            v = make_float4(ct.x + v.x, ct.y + v.y, ct.z + v.z, ct.w + v.w);
          } else {
            st4(Wout, c_ld, r, b, col0 + c, n, VEC, v);
            st4(ot, c_ld, r, b, col0 + c, n, VEC,
                make_float4(ct.x - v.x, ct.y - v.y, ct.z - v.z, ct.w - v.w));
          }
        }
        *reinterpret_cast<float4*>(buf + r * BN + c) = v;
        acc[i][4 * h] = acc[i][4 * h + 1] = acc[i][4 * h + 2] =
            acc[i][4 * h + 3] = 0.f;
      }
    }
  };

  TileAcc<BN> acc;
#pragma unroll
  for (int i = 0; i < S::TM; ++i)
#pragma unroll
    for (int j = 0; j < S::TN; ++j) acc[i][j] = 0.f;

  int blk = 0, qs = 0;  // the phase-C slice being multiplied
  for (int s = 0; s < TILE_STAGES - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<TILE_STAGES - 2>();
    bar_sync(bar_id, TILE_THREADS);  // slice s landed; slice s - 1 is done
    if (s + TILE_STAGES - 1 < total) issue(s + TILE_STAGES - 1);
    cp_async_commit();
    const float* st = ring + (s % TILE_STAGES) * S::STAGE;
    if (s < nA) {  // W1 (K4: Y2^T Cb) += slice^T C-slice
      mma_kmajor<BN, K4>(acc, st, st + BK * TILE_M, s * BK, ty, tx);
    } else if (s < nA + nB) {  // W += T-slice^T buf-rows
      if (s == nA) {
        to_buf(acc, true, false);
        bar_sync(bar_id, TILE_THREADS);
      }
      const int q0 = (s - nA) * BK;
      mma_kmajor<BN, K4>(acc, st, buf + q0 * BN, q0, ty, tx);
    } else {  // a row block of Y W, then out = C - Y W
      if (s == nA + nB) {
        to_buf(acc, false, true);
        bar_sync(bar_id, TILE_THREADS);
      }
      mma_rows<BN, K4>(acc, st, buf + qs * BK * BN, qs * BK, ty, tx);
      if (++qs == nB) {
#pragma unroll
        for (int i = 0; i < S::TM; ++i) {
          const int r = blk * TILE_M + (i / 4) * S::TY * 4 + ty * 4 + i % 4;
#pragma unroll
          for (int h = 0; h < S::TN / 4; ++h) {
            const int col = col0 + h * S::TX * 4 + tx * 4;
            const float4 cv = ld4(Cin, c_ld, r, R, col, n, VEC);
            st4(out, o_ld, r, R, col, n, VEC,
                make_float4(cv.x - acc[i][4 * h], cv.y - acc[i][4 * h + 1],
                            cv.z - acc[i][4 * h + 2], cv.w - acc[i][4 * h + 3]));
            acc[i][4 * h] = acc[i][4 * h + 1] = acc[i][4 * h + 2] =
                acc[i][4 * h + 3] = 0.f;
          }
        }
        qs = 0;
        ++blk;
      }
    }
  }
  cp_async_wait<0>();
  bar_sync(bar_id, TILE_THREADS);
}

// -- K2's and K4's tile at bf16: the wgmma engine ---------------------------
//
// The same chain of three products as apply_engine, on Hopper's tensor
// cores (wgmma_bf16.cuh: the layout, the split, the order contract). The
// tile's 256 threads are two warpgroups, each owning 64 of the 128 rows
// of the b side and every one of the BN columns: one m64nBNk16 step a
// warpgroup.
//   A: Z = Y^T C (K4: Y2^T Cb) over the R rows, in slices of 32 rows of Y
//      (MN-major A) and C (MN-major B) that cp.async copies raw into a
//      ring of three 16 KB stages; a block sum every 256 rows, added in
//      order into a total kept in shared memory (the thread's own entries);
//   B: W = T^T Z' with Z' = Z (K4: Ct + Z) split into hi and lo bf16 tiles
//      (MN-major B, 128 x BN each, where the total was), T in slices of 32
//      rows (MN-major A); K4 stores W rounded and Ct - W;
//   C: out = C - Y W' with W split the same way, Y in blocks of 128 rows
//      and 64 columns (K-major A); the epilogue reads C again.
// So C is read twice and written once, and neither Z nor W leaves shared
// memory. A row block's epilogue goes through shared memory (the stage its
// last slice was read from, 2 KB a warp): each warp writes its 16 rows of
// C - Y W' in 32-column pieces and reads them back as runs of 16 columns,
// so C is read and out written 32 bytes a row and thread, whole sectors,
// where the accumulators' own layout touches 8 rows in 4-byte pieces. A warpgroup whose 64 rows lie past b (or past R in phase C)
// skips its steps. Shared memory: the ring and the 512 BN bytes of the
// total / split tiles (112 KB at BN = 128, so K5/K6's two tiles a block
// fit). VEC: 16-byte copies (every row stride, b and n multiples of 8,
// every pointer 16-byte aligned); else element by element into the same
// layout.
constexpr int WE_BK = 32;      // rows of a phase-A or phase-B slice
constexpr int WE_QK = 64;      // columns of Y in a phase-C slice
constexpr int WE_STAGES = 3;
constexpr int WE_STAGE = TILE_M * WE_QK * 2;  // bytes of a ring stage

__host__ __device__ constexpr int wg_tile_bytes(int bn) {
  return WE_STAGES * WE_STAGE + TILE_M * bn * 4;
}

// Bytes of shared memory one K2/K4 tile needs at element type E.
template <class E>
__host__ __device__ constexpr int tile_smem_bytes(int bn) {
  return std::is_same_v<E, float> ? tile_smem_floats(bn) * (int)sizeof(float)
                                  : wg_tile_bytes(bn);
}

// Elements of one 16-byte access at element type E (the VEC paths' unit).
template <class E>
inline constexpr int vec_elems = 16 / (int)sizeof(E);

template <int BN, bool K4, bool VEC>
__device__ void wg_apply_engine(const bf16* Yf, int R, const bf16* T, int b,
                                const bf16* Cin, long long c_ld, bf16* out,
                                long long o_ld, const bf16* Ct, bf16* ot,
                                bf16* Wout, int n, int col0, int tid,
                                int bar_id, float* smem) {
  constexpr int NA = BN / 2;  // accumulators a thread
  char* ring = reinterpret_cast<char*>(smem);
  float* tot = reinterpret_cast<float*>(ring + WE_STAGES * WE_STAGE);
  char* xhi = reinterpret_cast<char*>(tot);   // the split tiles, where the
  char* xlo = xhi + TILE_M * BN * 2;          // total was
  const int wg = tid >> 7, t = tid & 127;
  const int nA = (R + WE_BK - 1) / WE_BK, nB = (b + WE_BK - 1) / WE_BK;
  const int nC = (b + WE_QK - 1) / WE_QK;
  const int total = nA + nB + ((R + TILE_M - 1) / TILE_M) * nC;
  const bool b_rows = wg * 64 < b;  // this warpgroup's rows hold any of b

  int issue_blk = 0, issue_qs = 0;
  auto issue = [&](int s) {
    char* st = ring + (s % WE_STAGES) * WE_STAGE;
    if (s < nA) {
      wg_stage<WE_BK, TILE_M / 8, true, TILE_THREADS>(st, Yf, b, 1, s * WE_BK, R,
                                                      0, b, tid, VEC);
      wg_stage<WE_BK, BN / 8, true, TILE_THREADS>(st + TILE_M * WE_BK * 2, Cin,
                                                  c_ld, 1, s * WE_BK, R, col0, n,
                                                  tid, VEC);
    } else if (s < nA + nB) {
      wg_stage<WE_BK, TILE_M / 8, true, TILE_THREADS>(st, T, b, 1,
                                                      (s - nA) * WE_BK, b, 0, b,
                                                      tid, VEC);
    } else {
      wg_stage<TILE_M, WE_QK / 8, false, TILE_THREADS>(
          st, Yf, b, 1, issue_blk * TILE_M, R, issue_qs * WE_QK, b, tid, VEC);
      if (++issue_qs == nC) issue_qs = 0, ++issue_blk;
    }
  };
  // acc (rows of this warpgroup, columns of the tile) split into the tiles
  auto put_split = [&](float (&a)[NA]) {
#pragma unroll
    for (int j = 0; j < NA; j += 2)
      wg_put_split2(xhi, xlo, BN, wg * 64 + wg_row(j, t), wg_col(j, t), a[j],
                    a[j + 1]);
  };

  float acc[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    acc[j] = 0.f;
    tot[j * TILE_THREADS + tid] = 0.f;
  }

  int blk = 0, qs = 0;  // the phase-C slice being multiplied
  for (int s = 0; s < WE_STAGES - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<WE_STAGES - 2>();
    fence_proxy_async();
    bar_sync(bar_id, TILE_THREADS);  // slice s landed; slice s - 1 is done
    if (s + WE_STAGES - 1 < total) issue(s + WE_STAGES - 1);
    cp_async_commit();
    const char* st = ring + (s % WE_STAGES) * WE_STAGE;
    if (s < nA) {  // Z (K4: Y2^T Cb) += slice^T C-slice
      if (b_rows) {
        wg_fence();
#pragma unroll
        for (int h = 0; h < WE_BK / WG_STEP; ++h) {
          const int k0 = s * WE_BK + h * WG_STEP;
          if (k0 < R)
            wg_mma<1, 1>(acc, wg_desc(st, TILE_M, wg * 64, h * WG_STEP),
                         wg_desc(st + TILE_M * WE_BK * 2, BN, 0, h * WG_STEP),
                         k0 % WG_CHAIN != 0);
        }
        wg_commit();
        wg_wait_all();
        wg_fence_acc(acc);
        if (((s + 1) * WE_BK) % WG_CHAIN == 0 || s == nA - 1) {
#pragma unroll
          for (int j = 0; j < NA; ++j) tot[j * TILE_THREADS + tid] += acc[j];
        }
      }
      continue;
    }
    if (s < nA + nB) {  // W += T-slice^T Z'
      if (s == nA) {  // Z' = Z (K4: Ct + Z), split
#pragma unroll
        for (int j = 0; j < NA; j += 2) {
          float v0 = tot[j * TILE_THREADS + tid], v1 = tot[(j + 1) * TILE_THREADS + tid];
          if (K4) {
            const float2 ct = ld2(Ct, c_ld, wg * 64 + wg_row(j, t), b,
                                  col0 + wg_col(j, t), n, VEC);
            v0 = ct.x + v0, v1 = ct.y + v1;
          }
          acc[j] = v0, acc[j + 1] = v1;
        }
        bar_sync(bar_id, TILE_THREADS);  // every total read
        put_split(acc);
        fence_proxy_async();
        bar_sync(bar_id, TILE_THREADS);
#pragma unroll
        for (int j = 0; j < NA; ++j) acc[j] = 0.f;
      }
      if (b_rows) {
        wg_fence();
#pragma unroll
        for (int h = 0; h < WE_BK / WG_STEP; ++h) {
          const int k0 = (s - nA) * WE_BK + h * WG_STEP;
          if (k0 < b) {
            const uint64_t da = wg_desc(st, TILE_M, wg * 64, h * WG_STEP);
            wg_mma<1, 1>(acc, da, wg_desc(xhi, BN, 0, k0), k0 != 0);
            wg_mma<1, 1>(acc, da, wg_desc(xlo, BN, 0, k0), 1);
          }
        }
        wg_commit();
        wg_wait_all();
        wg_fence_acc(acc);
      }
      continue;
    }
    if (s == nA + nB) {  // W = 0 + the block sum; K4's W and ot; W split
#pragma unroll
      for (int j = 0; j < NA; ++j) acc[j] = 0.f + acc[j];
      if (K4) {
#pragma unroll
        for (int j = 0; j < NA; j += 2) {
          const int r = wg * 64 + wg_row(j, t), c = col0 + wg_col(j, t);
          const float2 ct = ld2(Ct, c_ld, r, b, c, n, VEC);
          st2(Wout, c_ld, r, b, c, n, VEC, make_float2(acc[j], acc[j + 1]));
          st2(ot, c_ld, r, b, c, n, VEC,
              make_float2(ct.x - acc[j], ct.y - acc[j + 1]));
        }
      }
      put_split(acc);
      fence_proxy_async();
      bar_sync(bar_id, TILE_THREADS);
    }
    // a slice of a row block of Y W', then out = C - Y W'
    const bool c_rows = blk * TILE_M + wg * 64 < R;
    if (c_rows) {
      wg_fence();
#pragma unroll
      for (int h = 0; h < WE_QK / WG_STEP; ++h) {
        const int k0 = qs * WE_QK + h * WG_STEP;
        if (k0 < b) {
          const uint64_t da = wg_desc(st, TILE_M, wg * 64, h * WG_STEP);
          wg_mma<0, 1>(acc, da, wg_desc(xhi, BN, 0, k0), k0 != 0);
          wg_mma<0, 1>(acc, da, wg_desc(xlo, BN, 0, k0), 1);
        }
      }
      wg_commit();
      wg_wait_all();
      wg_fence_acc(acc);
    }
    if (++qs == nC) {
      bar_sync(bar_id, TILE_THREADS);  // both warpgroups done with the stage
      float* scr = reinterpret_cast<float*>(const_cast<char*>(st)) + (tid >> 5) * 512;
      const int lane = tid & 31;
      const int r = lane >> 1, cb = (lane & 1) << 4;  // this lane's row, columns
      const int gr = blk * TILE_M + wg * 64 + ((tid >> 5) & 3) * 16 + r;
#pragma unroll
      for (int h = 0; h < BN / 32; ++h) {
        if (c_rows) {
#pragma unroll
          for (int j = 16 * h; j < 16 * h + 16; j += 2) {
            const int rr = wg_row(j, t) & 15, cc = wg_col(j, t) & 31;
            *reinterpret_cast<float2*>(scr + rr * 32 + (cc ^ ((rr & 7) << 2))) =
                make_float2(0.f + acc[j], 0.f + acc[j + 1]);
          }
        }
        __syncwarp();
        if (c_rows) {
          float v[16];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 x = *reinterpret_cast<const float4*>(
                scr + r * 32 + ((cb + 4 * q) ^ ((r & 7) << 2)));
            v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z, v[4 * q + 3] = x.w;
          }
          wg_sub_store16(out, o_ld, Cin, c_ld, gr, R, col0 + h * 32 + cb, n, VEC, v);
        }
        __syncwarp();
      }
      qs = 0;
      ++blk;
    }
  }
  cp_async_wait<0>();
  bar_sync(bar_id, TILE_THREADS);
}

// K2's tile: out = C - Y (T^T (Y^T C)) for columns [col0, col0 + BN) of one
// lane: Y (m x b) and T (b x b) contiguous, C (m x n) with row stride c_ld,
// out with row stride o_ld.
template <int BN, bool VEC, class E>
__device__ inline void wy_apply_tile(const E* Y, const E* T, const E* C,
                                     long long c_ld, E* out, long long o_ld,
                                     int m, int b, int n, int col0, int tid,
                                     int bar_id, float* smem) {
  if constexpr (std::is_same_v<E, bf16>)
    wg_apply_engine<BN, false, VEC>(Y, m, T, b, C, c_ld, out, o_ld, nullptr,
                                    nullptr, nullptr, n, col0, tid, bar_id, smem);
  else
    apply_engine<BN, false, VEC, E>(Y, m, T, b, C, c_ld, out, o_ld, nullptr,
                                    nullptr, nullptr, n, col0, tid, bar_id, smem);
}

// K4's tile: W = T^T (Ct + Y2^T Cb); ot = Ct - W; ob = Cb - Y2 W for columns
// [col0, col0 + BN) of one lane: Y2 and T (b x b) upper triangular and
// contiguous (their lower triangles are not read), Ct, Cb and the three
// outputs (b x n) with row stride ld. All three outputs are written (a
// caller that keeps only some passes a scratch sink for the rest).
template <int BN, bool VEC, class E>
__device__ inline void stacked_apply_tile(const E* Y2, const E* T, const E* Ct,
                                          const E* Cb, long long ld, E* ot,
                                          E* ob, E* W, int b, int n, int col0,
                                          int tid, int bar_id, float* smem) {
  if constexpr (std::is_same_v<E, bf16>)
    wg_apply_engine<BN, true, VEC>(Y2, b, T, b, Cb, ld, ob, ld, Ct, ot, W, n,
                                   col0, tid, bar_id, smem);
  else
    apply_engine<BN, true, VEC, E>(Y2, b, T, b, Cb, ld, ob, ld, Ct, ot, W, n,
                                   col0, tid, bar_id, smem);
}

}  // namespace repro
