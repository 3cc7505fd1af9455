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
//
// The b <= 128 body is fused_panel.cuh, a template on the element type,
// instantiated in fused_panel_f32.cu and fused_panel_bf16.cu; the wide
// body is fused_wide.cuh, instantiated here at float and in
// fused_wide_bf16.cu at bf16; this file also holds the size queries they
// use. The four compile side by side (one nvcc each), so no other
// instance adds to the float wide kernel's compile.
#include "fused_panel.cuh"
#include "fused_wide.cuh"

using namespace repro;

extern "C" size_t fused_sweep_smem_bytes(int m, int b, int bn) {
  return fused_smem_bytes(m, b, bn);
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

__global__ void __launch_bounds__(QR_THREADS, 1)
fused_wide_kernel(const __grid_constant__ WideArgs<float> wa) {
  extern __shared__ __align__(16) float smem[];
  fused_wide_body(wa, smem);
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
  return fw_launch_smem_bytes(m, b, L);
}

extern "C" size_t fused_wide_work_floats(int m, int b, int L) {
  return fw_team_floats(m, b, L > 0, true);
}

extern "C" size_t fused_wide_scratch_floats(int P, int m, int w, int b, int L) {
  return fw_launch_scratch_floats<float>(P, m, w, b, L);
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
  return fw_k5_entry(fused_wide_kernel, W, w_bs, w_ld, rs, Y, T, R, C, Cp,
                     work, xch, arrivals, xch_blocks, scratch, P, m, w, b,
                     stream);
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
  return fw_k6_entry(fused_wide_kernel, W, w_bs, w_ld, rs, active, P, m, w, b,
                     L, t_lane, xch_blocks, leaf_Y, leaf_T, R_leaf, R_carry,
                     level_Y2, level_T, C_local, C_prime, Ws, Cs_self,
                     Cs_buddy, work, xch, arrivals, Rtmp, scratch, stream);
}
