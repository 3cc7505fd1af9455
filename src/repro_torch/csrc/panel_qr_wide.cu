// K1 above 128 columns in one launch, and K3 above 128 columns through it.
//
// Replaces, at panel widths the team body (qr_common.cuh, at most 128
// columns) cannot hold, the TPU kernels src/repro/kernels/panel_qr.py::
// panel_qr (body panel_qr_math, any (m, b) in one block) and
// src/repro/kernels/stacked_qr.py::stacked_qr (K3 is K1's route on the
// stacked triangles [triu(R_top); triu(R_bot)] at row start 0, whose
// reflectors keep the stack's exact zeros, so Y[:b] is I and Y2 = Y[b:]
// upper triangular).
//
// What bounds it on the H100: the team's column loop, one or two cluster
// barriers a column, sub-panel after sub-panel; its FP32 work (about
// 3 m b^2 operations a lane, most of it in the products between
// sub-panels) would take the card well under a tenth of that time. The
// composed route (kernels/wide.py::panel_qr_blocked with K1's team launch
// a sub-panel and wide_gemm between them) added, for every 128-column
// sub-panel, six product launches, the glue between them and the host's
// time to issue all of it.
//
// The design: blocked_qr of wide_qr.cuh in one cooperative launch of
// thread-block clusters (ClusterTeams): the team phases on K1's cluster
// exchange at the composed route's team sizes (several teams a cluster
// where a sub-panel's team is smaller than the cluster), the T join and
// the apply between sub-panels as grid-wide tile phases of the products'
// routine on 128 x 128 tiles under setmaxnreg, whose order is the
// contract, R by the clamp rule, so every output equals the composed
// route's bit for bit. Where one round of the clusters the card holds
// cannot take every lane's team but a plain cooperative grid can (8 lanes
// of 4096 rows: teams of 16, 7 clusters of 16 on the H100, 132 blocks),
// the launch takes that grid and the team phases exchange through global
// memory (GlobalTeams, as K5/K6 do): the same sums in the same order, one
// round of teams instead of two. In stacked mode (K3) the launch first
// copies each lane's two triangles into its stack and last writes
// Y2 = triu(Y[b:]).
#include "panel_qr_wide.cuh"

using namespace repro;

__global__ void __launch_bounds__(QR_THREADS, 1)
panel_qr_wide_kernel(const __grid_constant__ PanelWideArgs k) {
  extern __shared__ __align__(16) float smem[];
  ClusterTeams teams{k.CS};
  panel_qr_wide_body(k, teams, smem);
}

__global__ void __launch_bounds__(QR_THREADS, 1)
panel_qr_wide_global_kernel(const __grid_constant__ PanelWideArgs k) {
  extern __shared__ __align__(16) float smem[];
  GlobalTeams teams{k.xch, k.arrivals, k.xch_blocks, 0};
  panel_qr_wide_body(k, teams, smem);
}

// The launch's numbers at an (m x b) panel (stacked: m = 2b, the stack's
// rows): shared memory of a block, the team phases' global slabs a lane,
// the scratch of P lanes, the cluster size, and the grid in blocks (0 with
// the error in *err when the card cannot hold one cluster).
extern "C" size_t panel_qr_wide_smem_bytes(int m, int b) {
  return pqw_smem_bytes(m, b);
}

extern "C" size_t panel_qr_wide_work_floats(int m, int b) {
  return fw_team_floats(m, b, false, true);
}

// Stacked: the scratch holds the stack and its Y too (one level of
// stacks); then the grid barrier's words.
extern "C" size_t panel_qr_wide_scratch_floats(int P, int m, int b,
                                               int stacked) {
  return pqw_scratch_floats(P, m, b, stacked != 0);
}

// Floats of the global exchange's slots for a grid of `blocks` blocks
// (teams of one block at most), and its team phases (rows of counters).
extern "C" size_t panel_qr_wide_xch_floats(int blocks) {
  return (size_t)blocks * team_slots_floats(FW_NB);
}

extern "C" int panel_qr_wide_team_phases(int b) { return cdiv(b, FW_NB); }

// The launch of P lanes at an (m x b) panel (pqw_shape).
extern "C" int panel_qr_wide_shape(int P, int m, int b, int* cluster, int* grid) {
  return pqw_shape((const void*)panel_qr_wide_kernel,
                   (const void*)panel_qr_wide_global_kernel, P, m, b, cluster,
                   grid);
}

// K1 at b > 128: A (P panels m x b, lane stride a_bs and row stride a_ld
// in floats, unit column stride), rs (P int32 row starts, device), Y
// (P*m*b floats), T and R (P*b*b). K3 at b > 128 (A2 not null): A and A2
// the top and bottom triangles (P*b*b floats each, contiguous), m = 2b, rs
// null, Y receives Y2 (P*b*b). work: P * panel_qr_wide_work_floats(m, b)
// floats; scratch: panel_qr_wide_scratch_floats(P, m, b, A2 != null);
// xch: panel_qr_wide_xch_floats(xch_blocks) floats and arrivals
// panel_qr_wide_team_phases(b) * xch_blocks unsigned, xch_blocks at least
// the card's SMs (used when the launch takes the plain grid).
extern "C" int panel_qr_wide_f32(const void* A, long long a_bs, long long a_ld,
                                 const void* A2, const void* rs, void* Y,
                                 void* T, void* R, void* work, void* scratch,
                                 void* xch, void* arrivals, int xch_blocks,
                                 int P, int m, int b, void* stream) {
  if (P < 1 || b <= FW_NB || m < b || (A2 && m != 2 * b) || (!A2 && !rs))
    return (int)cudaErrorInvalidValue;
  PanelWideArgs k{};
  k.A = (const float*)A, k.a_bs = a_bs, k.a_ld = a_ld;
  k.A2 = (const float*)A2, k.rs = (const int*)rs;
  k.Y = (float*)Y, k.T = (float*)T, k.R = (float*)R;
  return pqw_launch(panel_qr_wide_kernel, panel_qr_wide_global_kernel, k, k,
                    work, scratch, xch, arrivals, xch_blocks, P, m, b, stream);
}
