// K5 and K6 at panel widths up to 128 on float windows: the b <= 128 body
// of fused_panel.cuh instantiated at float (fused_sweep.cu's header says
// what it computes, what bounds it and how its phases run; the bf16
// instance is fused_panel_bf16.cu's, the wide kernel fused_sweep.cu's).
//
// Replaces src/repro/kernels/fused_sweep.py::panel_qr_apply (body
// panel_qr_apply_math) and fused_panel_pallas (body fused_panel_math).
#include "fused_panel.cuh"

using namespace repro;

// Blocks of K6 an SM holds at once at the shared memory of an (m x b)
// panel and column tile bn (the f32 instance; the bf16 instance's wgmma
// tiles take more shared memory, fused_smem_bytes<bf16>, under the same
// launch bounds).
extern "C" int fused_panel_blocks_per_sm(int m, int b, int bn, int* out) {
  const size_t smem = fused_smem_bytes(m, b, bn);
  cudaError_t err = cudaFuncSetAttribute(
      fused_panel_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fused_panel_kernel<float>, QR_THREADS, smem);
}

// K5 and K6 at float (arguments: panel_qr_apply_entry and
// fused_panel_entry in fused_panel.cuh; gram may be null).
extern "C" int panel_qr_apply_f32(const void* W, long long w_bs, long long w_ld,
                                  const void* rs, void* Y, void* T, void* R,
                                  void* C, void* Cp, void* work, void* xch,
                                  void* arrivals, void* gram, int xch_blocks,
                                  int P, int m, int w, int b, int bn, int team,
                                  void* stream) {
  return panel_qr_apply_entry<float>(W, w_bs, w_ld, rs, Y, T, R, C, Cp, work,
                                     xch, arrivals, gram, xch_blocks, P, m, w,
                                     b, bn, team, stream);
}

extern "C" int fused_panel_f32(const void* W, long long w_bs, long long w_ld,
                               const void* rs, const void* active, int P, int m,
                               int w, int b, int L, int t_lane, int bn,
                               int team, int xch_blocks, void* leaf_Y,
                               void* leaf_T, void* R_leaf, void* R_carry,
                               void* level_Y2, void* level_T, void* C_local,
                               void* C_prime, void* Ws, void* Cs_self,
                               void* Cs_buddy, void* work, void* xch,
                               void* arrivals, void* Rtmp, void* sink,
                               void* gram, void* stream) {
  return fused_panel_entry<float>(
      W, w_bs, w_ld, rs, active, P, m, w, b, L, t_lane, bn, team, xch_blocks,
      leaf_Y, leaf_T, R_leaf, R_carry, level_Y2, level_T, C_local, C_prime, Ws,
      Cs_self, Cs_buddy, work, xch, arrivals, Rtmp, sink, gram, stream);
}
