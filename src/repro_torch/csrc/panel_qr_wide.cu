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
#include "wide_qr.cuh"

using namespace repro;

struct PanelWideArgs {
  const float* A;    // (P, m, b): lane stride a_bs, row stride a_ld; stacked:
  long long a_bs, a_ld;  // the top triangles (P, b, b), contiguous
  const float* A2;   // stacked: the bottom triangles (P, b, b); else null
  const int* rs;     // (P,) row starts; null when stacked (row start 0)
  float* Y;          // (P, m, b); stacked: Y2 (P, b, b)
  float* T;          // (P, b, b)
  float* R;          // (P, b, b)
  int m, b;          // the panel's rows (stacked: 2b) and columns
  int CS;            // the cluster size: the largest team of the sub-panels
  float* xch;        // GlobalTeams: the teams' exchange slots
  unsigned* arrivals;  // GlobalTeams: a row of xch_blocks counters a phase
  int xch_blocks;
  WideQR q;
};

template <class Teams>
__device__ void panel_qr_wide_body(const PanelWideArgs& k, Teams& teams,
                                   float* smem) {
  const WideScratch& s = k.q.s;
  const int P = k.q.P, b = k.b;
  const size_t bb = (size_t)b * b;
  const bool stacked = k.A2 != nullptr;
  if (stacked) {  // [triu(R_top); triu(R_bot)], each lane's own stack
    grid_rows(P * 2 * b, [&](int row, int lane) {
      const int p = row / (2 * b), q = row % (2 * b), r = q % b;
      const float* src = (q < b ? k.A : k.A2) + p * bb + (size_t)r * b;
      for (int c = lane; c < b; c += 32)
        s.stack[(size_t)row * b + c] = r > c ? 0.f : src[c];
    });
    grid_barrier(k.q.bar);
  }
  blocked_qr(
      k.q, teams, k.m, b, [](int) { return true; },
      [&](int p) -> const float* {
        return stacked ? s.stack + p * 2 * bb : k.A + p * k.a_bs;
      },
      stacked ? b : k.a_ld, [&](int p) { return stacked ? 0 : k.rs[p]; },
      stacked ? s.Ys : k.Y, (size_t)k.m * b, k.T, k.R, s.cur, false, smem);
  if (stacked)  // Y2 = triu(Y[b:])
    grid_rows(P * b, [&](int row, int lane) {
      const int p = row / b, r = row % b;
      for (int c = lane; c < b; c += 32)
        k.Y[(size_t)row * b + c] =
            r > c ? 0.f : __ldcg(s.Ys + p * 2 * bb + bb + (size_t)r * b + c);
    });
}

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
  return fw_smem_floats(m, b, false) * sizeof(float);
}

extern "C" size_t panel_qr_wide_work_floats(int m, int b) {
  return fw_team_floats(m, b, false, true);
}

// Stacked: the scratch holds the stack and its Y too (one level of
// stacks); then the grid barrier's words.
extern "C" size_t panel_qr_wide_scratch_floats(int P, int m, int b,
                                               int stacked) {
  return fw_scratch_floats(P, m, 0, b, stacked ? 1 : 0, nullptr, nullptr) +
         FW_BAR_FLOATS;
}

// Floats of the global exchange's slots for a grid of `blocks` blocks
// (teams of one block at most), and its team phases (rows of counters).
extern "C" size_t panel_qr_wide_xch_floats(int blocks) {
  return (size_t)blocks * team_slots_floats(FW_NB);
}

extern "C" int panel_qr_wide_team_phases(int b) { return cdiv(b, FW_NB); }

// The launch of P lanes at an (m x b) panel: *cluster the cluster size (0:
// the plain cooperative grid, GlobalTeams) and *grid its blocks. Clusters
// when one round of them takes every lane's largest team, else the plain
// grid when it does, else the clusters in rounds. Returns the error of a
// launch the card cannot hold.
extern "C" int panel_qr_wide_shape(int P, int m, int b, int* cluster, int* grid) {
  const int CS = fw_max_team(m, b, false);
  const size_t smem = panel_qr_wide_smem_bytes(m, b);
  int err = 0;
  const int gc = wide_grid((const void*)panel_qr_wide_kernel, CS, smem, &err);
  *cluster = CS, *grid = gc;
  if (err == 0 && (long long)(gc / CS) >= P) return 0;
  const void* kg = (const void*)panel_qr_wide_global_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kg, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = fw_check_regs(kg);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kg, QR_THREADS, smem);
  if (e != cudaSuccess) return err ? err : (int)e;
  const int gg = per_sm * sms < sms ? per_sm * sms : sms;
  if ((long long)gg >= (long long)P * CS) {
    *cluster = 0, *grid = gg;
    return 0;
  }
  return err ? err : (gc >= CS ? 0 : (int)cudaErrorCooperativeLaunchTooLarge);
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
  int CS = 0, grid = 0;
  int err = panel_qr_wide_shape(P, m, b, &CS, &grid);
  if (err) return err;
  if (CS == 0 && grid > xch_blocks) return (int)cudaErrorInvalidValue;
  PanelWideArgs k{};
  k.A = (const float*)A, k.a_bs = a_bs, k.a_ld = a_ld;
  k.A2 = (const float*)A2, k.rs = (const int*)rs;
  k.Y = (float*)Y, k.T = (float*)T, k.R = (float*)R;
  k.m = m, k.b = b;
  const size_t off = fw_scratch_floats(P, m, 0, b, A2 ? 1 : 0, &k.q.s,
                                       (float*)scratch);
  k.q.yj_bs = (size_t)m * FW_NB;
  k.q.work = (float*)work;
  k.q.bar = (unsigned*)((float*)scratch + off);
  k.q.P = P;
  k.CS = CS;
  k.xch = (float*)xch, k.arrivals = (unsigned*)arrivals, k.xch_blocks = xch_blocks;
  const auto st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(k.q.bar, 0, 4 * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = panel_qr_wide_smem_bytes(m, b);
  if (CS) return wide_launch(panel_qr_wide_kernel, k, CS, smem, st);
  e = cudaMemsetAsync(arrivals, 0,
                      (size_t)cdiv(b, FW_NB) * xch_blocks * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&k};
  e = cudaLaunchCooperativeKernel((const void*)panel_qr_wide_global_kernel,
                                  dim3(grid), dim3(QR_THREADS), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
