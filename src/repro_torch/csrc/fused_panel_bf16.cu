// K5 and K6 on bf16 windows at panel widths up to 128: the b <= 128 body
// of fused_panel.cuh instantiated at bf16 (the float instance is
// fused_panel_f32.cu's, the wide kernel fused_sweep.cu's; the three compile
// side by side).
//
// Replaces src/repro/kernels/fused_sweep.py::panel_qr_apply and
// fused_panel_pallas at bf16, where the JAX package's fused kernels run in
// the dtype of the window. Every tensor the stepped route passes between
// its kernels is bf16 here too, stored rounded and read back widened
// (fused_panel.cuh), so the launch equals the stepped bf16 route (K1-K4 at
// bf16) bit for bit. What bounds it on the H100 and how the phases run: as
// at float (fused_sweep.cu's header), except that the apply and combine
// phases run K2's and K4's bf16 engine, on wgmma (qr_common.cuh,
// wg_apply_engine; wgmma_bf16.cuh).
#include "fused_panel.cuh"

using namespace repro;

// As panel_qr_apply_f32 on bf16 tensors; gram: P*b*b floats of scratch.
extern "C" int panel_qr_apply_bf16(const void* W, long long w_bs,
                                   long long w_ld, const void* rs, void* Y,
                                   void* T, void* R, void* C, void* Cp,
                                   void* work, void* xch, void* arrivals,
                                   void* gram, int xch_blocks, int P, int m,
                                   int w, int b, int bn, int team,
                                   void* stream) {
  return panel_qr_apply_entry<bf16>(W, w_bs, w_ld, rs, Y, T, R, C, Cp, work,
                                    xch, arrivals, gram, xch_blocks, P, m, w,
                                    b, bn, team, stream);
}

// As fused_panel_f32 on bf16 tensors (Rtmp and sink bf16 too); gram: P*b*b
// floats of scratch.
extern "C" int fused_panel_bf16(const void* W, long long w_bs, long long w_ld,
                                const void* rs, const void* active, int P,
                                int m, int w, int b, int L, int t_lane, int bn,
                                int team, int xch_blocks, void* leaf_Y,
                                void* leaf_T, void* R_leaf, void* R_carry,
                                void* level_Y2, void* level_T, void* C_local,
                                void* C_prime, void* Ws, void* Cs_self,
                                void* Cs_buddy, void* work, void* xch,
                                void* arrivals, void* Rtmp, void* sink,
                                void* gram, void* stream) {
  return fused_panel_entry<bf16>(
      W, w_bs, w_ld, rs, active, P, m, w, b, L, t_lane, bn, team, xch_blocks,
      leaf_Y, leaf_T, R_leaf, R_carry, level_Y2, level_T, C_local, C_prime, Ws,
      Cs_self, Cs_buddy, work, xch, arrivals, Rtmp, sink, gram, stream);
}
