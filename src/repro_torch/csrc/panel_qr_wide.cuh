// K1's (and K3's) wide launch, shared by its float instance
// (panel_qr_wide.cu) and its bf16 instance (panel_qr_wide_bf16.cu): the
// arguments, the body (blocked_qr of wide_qr.cuh on the panel or on the
// stacked triangles), and the host side of the launch (its shape: clusters
// or the plain cooperative grid, and the launch itself). What the launch
// does and why is in panel_qr_wide.cu's header.
#pragma once
#include "wide_qr.cuh"

namespace repro {

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

// Shared memory of a block, the team phases' global slabs a lane, and the
// scratch of P lanes (stacked: one level of stacks, then the grid
// barrier's words) of the launch at an (m x b) panel (stacked: m = 2b).
inline size_t pqw_smem_bytes(int m, int b) {
  return fw_smem_floats(m, b, false) * sizeof(float);
}

inline size_t pqw_scratch_floats(int P, int m, int b, bool stacked) {
  return fw_scratch_floats(P, m, 0, b, stacked ? 1 : 0, nullptr, nullptr) +
         FW_BAR_FLOATS;
}

// The launch of P lanes at an (m x b) panel through the kernel pair
// (clusters, plain grid): *cluster the cluster size (0: the plain
// cooperative grid, GlobalTeams) and *grid its blocks. Clusters when one
// round of them takes every lane's largest team, else the plain grid when
// it does, else the clusters in rounds. Returns the error of a launch the
// card cannot hold.
inline int pqw_shape(const void* kc, const void* kg, int P, int m, int b,
                     int* cluster, int* grid) {
  const int CS = fw_max_team(m, b, false);
  const size_t smem = pqw_smem_bytes(m, b);
  int err = 0;
  const int gc = wide_grid(kc, CS, smem, &err);
  *cluster = CS, *grid = gc;
  if (err == 0 && (long long)(gc / CS) >= P) return 0;
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

// Fill k's sizes, scratch carving and team arguments for P lanes at an
// (m x b) panel (stacked when k.A2 is set) and launch it through the kernel
// pair: the arguments and the pointers as panel_qr_wide_f32 takes them.
template <class Args>
inline int pqw_launch(void (*kc)(Args), void (*kg)(Args), Args& args,
                      PanelWideArgs& k, void* work, void* scratch, void* xch,
                      void* arrivals, int xch_blocks, int P, int m, int b,
                      void* stream) {
  int CS = 0, grid = 0;
  int err = pqw_shape((const void*)kc, (const void*)kg, P, m, b, &CS, &grid);
  if (err) return err;
  if (CS == 0 && grid > xch_blocks) return (int)cudaErrorInvalidValue;
  k.m = m, k.b = b;
  const size_t off = fw_scratch_floats(P, m, 0, b, k.A2 ? 1 : 0, &k.q.s,
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
  const size_t smem = pqw_smem_bytes(m, b);
  if (CS) return wide_launch(kc, args, CS, smem, st);
  e = cudaMemsetAsync(arrivals, 0,
                      (size_t)cdiv(b, FW_NB) * xch_blocks * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kg, dim3(grid), dim3(QR_THREADS),
                                  params, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace repro
