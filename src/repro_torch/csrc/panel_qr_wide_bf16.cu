// K1 above 128 columns at bf16 in one launch, and K3 above 128 columns at
// bf16 through it: panel_qr_wide.cu's launch on a bf16 panel (or bf16
// triangles).
//
// Replaces, at bf16, src/repro/kernels/panel_qr.py::panel_qr and
// src/repro/kernels/stacked_qr.py::stacked_qr above 128 columns, whose
// Pallas bodies compute in f32 and store in the panel's dtype.
//
// The contract: the outputs equal the float launch on the widened panel,
// each rounded once. The blocked QR reads its own outputs back as operands
// (the look-ahead products read Y's and T's finished sub-panels, the T
// join reads Y and T), so a bf16 Y or T inside the launch would feed
// rounded values into later sums. The launch therefore runs the float
// body unchanged on float copies: it widens the panel (or the two
// triangles) into float scratch, runs panel_qr_wide_body with Y, T and R
// in float scratch, and last rounds them into the bf16 outputs. Widening
// is exact, and the float body is the same device code as the float
// launch's at the same team sizes, so the bits are the float launch's
// rounded once. The widened panel is written once, before any block reads
// it, so team_qr's plain reads of it are coherent (wide_qr.cuh).
//
// What bounds it on the H100: as at float (the team's column loop); the
// widening and the rounding move 6 bytes an element of the panel and 6 of
// Y, about 0.02 ms of HBM time at (8, 4096, 256).
#include "panel_qr_wide.cuh"

using namespace repro;

struct PanelWideBf16Args {
  PanelWideArgs f;   // the float launch: f.A (f.A2) the widened panel
                     // (triangles), f.Y, f.T, f.R its float outputs
  const bf16* A;     // (P, m, b): lane stride a_bs, row stride a_ld; stacked:
  long long a_bs, a_ld;  // the top triangles (P, b, b), contiguous
  const bf16* A2;    // stacked: the bottom triangles; else null
  float* Aw;         // the widened panel (P, m, b) or triangles (2, P, b, b)
  bf16* Y;           // (P, m, b); stacked: Y2 (P, b, b)
  bf16* T;           // (P, b, b)
  bf16* R;           // (P, b, b)
};

// Floats of the bf16 launch's own scratch after the float launch's: the
// widened input, and Y, T and R in float (each 128-byte aligned).
__host__ __device__ inline size_t pqw_bf16_floats(int P, int m, int b,
                                                  bool stacked, float* base,
                                                  PanelWideBf16Args* k) {
  const size_t bb = (size_t)b * b, ym = stacked ? b : m;
  const size_t sizes[4] = {stacked ? 2 * bb : (size_t)m * b, ym * b, bb, bb};
  size_t off = 0;
  float* at[4];
  for (int i = 0; i < 4; ++i) {
    at[i] = base ? base + off : nullptr;
    off += ((size_t)P * sizes[i] + 31) / 32 * 32;
  }
  if (k) {
    k->Aw = at[0];
    k->f.Y = at[1], k->f.T = at[2], k->f.R = at[3];
  }
  return off;
}

template <class Teams>
__device__ void panel_qr_wide_bf16_body(const PanelWideBf16Args& k,
                                        Teams& teams, float* smem) {
  const PanelWideArgs& f = k.f;
  const int P = f.q.P, m = f.m, b = f.b;
  const size_t bb = (size_t)b * b;
  const bool stacked = k.A2 != nullptr;
  // the input, widened: the panel as (P, m, b) contiguous, or the top and
  // the bottom triangles as (P, b, b) each
  if (stacked) {
    grid_rows(P * 2 * b, [&](int row, int lane) {
      const int p = row / (2 * b), q = row % (2 * b), r = q % b;
      const bf16* src = (q < b ? k.A : k.A2) + p * bb + (size_t)r * b;
      float* dst = k.Aw + (q < b ? 0 : (size_t)P * bb) + p * bb + (size_t)r * b;
      for (int c = lane; c < b; c += 32) dst[c] = widen(src[c]);
    });
  } else {
    grid_rows(P * m, [&](int row, int lane) {
      const int p = row / m, i = row % m;
      const bf16* src = k.A + p * k.a_bs + i * k.a_ld;
      float* dst = k.Aw + (size_t)row * b;
      for (int c = lane; c < b; c += 32) dst[c] = widen(src[c]);
    });
  }
  grid_barrier(f.q.bar);
  panel_qr_wide_body(f, teams, smem);
  grid_barrier(f.q.bar);
  // Y (Y2), T and R rounded once
  const int ym = stacked ? b : m, rows = ym + 2 * b;
  grid_rows(P * rows, [&](int row, int lane) {
    const int p = row / rows, r = row % rows;
    const float* src;
    bf16* dst;
    if (r < ym) {
      src = f.Y + ((size_t)p * ym + r) * b, dst = k.Y + ((size_t)p * ym + r) * b;
    } else if (r < ym + b) {
      src = f.T + p * bb + (size_t)(r - ym) * b, dst = k.T + p * bb + (size_t)(r - ym) * b;
    } else {
      src = f.R + p * bb + (size_t)(r - ym - b) * b;
      dst = k.R + p * bb + (size_t)(r - ym - b) * b;
    }
    for (int c = lane; c < b; c += 32) dst[c] = narrow<bf16>(__ldcg(src + c));
  });
}

__global__ void __launch_bounds__(QR_THREADS, 1)
panel_qr_wide_bf16_kernel(const __grid_constant__ PanelWideBf16Args k) {
  extern __shared__ __align__(16) float smem[];
  ClusterTeams teams{k.f.CS};
  panel_qr_wide_bf16_body(k, teams, smem);
}

__global__ void __launch_bounds__(QR_THREADS, 1)
panel_qr_wide_bf16_global_kernel(const __grid_constant__ PanelWideBf16Args k) {
  extern __shared__ __align__(16) float smem[];
  GlobalTeams teams{k.f.xch, k.f.arrivals, k.f.xch_blocks, 0};
  panel_qr_wide_bf16_body(k, teams, smem);
}

// The scratch of the bf16 launch: the float launch's, then its own.
extern "C" size_t panel_qr_wide_scratch_floats_bf16(int P, int m, int b,
                                                    int stacked) {
  return pqw_scratch_floats(P, m, b, stacked != 0) +
         pqw_bf16_floats(P, m, b, stacked != 0, nullptr, nullptr);
}

// The launch shape of the bf16 kernels (as panel_qr_wide_shape).
extern "C" int panel_qr_wide_shape_bf16(int P, int m, int b, int* cluster,
                                        int* grid) {
  return pqw_shape((const void*)panel_qr_wide_bf16_kernel,
                   (const void*)panel_qr_wide_bf16_global_kernel, P, m, b,
                   cluster, grid);
}

// As panel_qr_wide_f32 on bf16 tensors (strides in elements), with scratch
// panel_qr_wide_scratch_floats_bf16(P, m, b, A2 != null) floats.
extern "C" int panel_qr_wide_bf16(const void* A, long long a_bs, long long a_ld,
                                  const void* A2, const void* rs, void* Y,
                                  void* T, void* R, void* work, void* scratch,
                                  void* xch, void* arrivals, int xch_blocks,
                                  int P, int m, int b, void* stream) {
  if (P < 1 || b <= FW_NB || m < b || (A2 && m != 2 * b) || (!A2 && !rs))
    return (int)cudaErrorInvalidValue;
  const bool stacked = A2 != nullptr;
  PanelWideBf16Args k{};
  k.A = (const bf16*)A, k.a_bs = a_bs, k.a_ld = a_ld, k.A2 = (const bf16*)A2;
  k.Y = (bf16*)Y, k.T = (bf16*)T, k.R = (bf16*)R;
  pqw_bf16_floats(P, m, b, stacked,
                  (float*)scratch + pqw_scratch_floats(P, m, b, stacked), &k);
  PanelWideArgs& f = k.f;
  f.A = k.Aw, f.a_bs = stacked ? (long long)b * b : (long long)m * b;
  f.a_ld = b;
  f.A2 = stacked ? k.Aw + (size_t)P * b * b : nullptr;
  f.rs = (const int*)rs;
  return pqw_launch(panel_qr_wide_bf16_kernel, panel_qr_wide_bf16_global_kernel,
                    k, f, work, scratch, xch, arrivals, xch_blocks, P, m, b,
                    stream);
}
