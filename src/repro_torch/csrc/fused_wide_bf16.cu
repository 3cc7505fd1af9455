// K5 and K6 above 128 columns on bf16 windows: the wide body of
// fused_wide.cuh instantiated at bf16 (its float instance is fused_sweep.cu's
// fused_wide_kernel; the two compile side by side, so this one adds nothing
// to the float kernel's nvcc).
//
// Replaces src/repro/kernels/fused_sweep.py::panel_qr_apply and
// fused_panel_pallas at bf16 above 128 columns, where the JAX package's
// fused kernels run in the dtype of the window. The launch rounds where the
// stepped bf16 route rounds and reads back rounded what it reads back
// (fused_wide.cuh's header), so it equals that route (K1-K4 at bf16 above
// 128 columns) bit for bit. What bounds it on the H100 and how the phases
// run: as at float (fused_sweep.cu's header), every product on float
// copies of its operands; the passes that widen the window and round
// C_local move 12 bytes an element of the window (about 0.5 ms of HBM time
// at the (8, 4096, 4096) window).
#include "fused_wide.cuh"

using namespace repro;

__global__ void __launch_bounds__(QR_THREADS, 1)
fused_wide_bf16_kernel(const __grid_constant__ WideArgs<bf16> wa) {
  extern __shared__ __align__(16) float smem[];
  fused_wide_body(wa, smem);
}

// The scratch of the bf16 launch: the float launch's, then its float
// copies (fused_wide.cuh, WideF32<bf16>).
extern "C" size_t fused_wide_scratch_floats_bf16(int P, int m, int w, int b,
                                                 int L) {
  return fw_launch_scratch_floats<bf16>(P, m, w, b, L);
}

// As panel_qr_apply_wide_f32 on bf16 tensors (strides in elements), with
// scratch fused_wide_scratch_floats_bf16(P, m, w, b, 0) floats.
extern "C" int panel_qr_apply_wide_bf16(const void* W, long long w_bs,
                                        long long w_ld, const void* rs, void* Y,
                                        void* T, void* R, void* C, void* Cp,
                                        void* work, void* xch, void* arrivals,
                                        int xch_blocks, void* scratch, int P,
                                        int m, int w, int b, void* stream) {
  return fw_k5_entry(fused_wide_bf16_kernel, W, w_bs, w_ld, rs, Y, T, R, C, Cp,
                     work, xch, arrivals, xch_blocks, scratch, P, m, w, b,
                     stream);
}

// As fused_panel_wide_f32 on bf16 tensors (Rtmp bf16 too), with scratch
// fused_wide_scratch_floats_bf16(P, m, w, b, L) floats.
extern "C" int fused_panel_wide_bf16(
    const void* W, long long w_bs, long long w_ld, const void* rs,
    const void* active, int P, int m, int w, int b, int L, int t_lane,
    int xch_blocks, void* leaf_Y, void* leaf_T, void* R_leaf, void* R_carry,
    void* level_Y2, void* level_T, void* C_local, void* C_prime, void* Ws,
    void* Cs_self, void* Cs_buddy, void* work, void* xch, void* arrivals,
    void* Rtmp, void* scratch, void* stream) {
  return fw_k6_entry(fused_wide_bf16_kernel, W, w_bs, w_ld, rs, active, P, m,
                     w, b, L, t_lane, xch_blocks, leaf_Y, leaf_T, R_leaf,
                     R_carry, level_Y2, level_T, C_local, C_prime, Ws, Cs_self,
                     Cs_buddy, work, xch, arrivals, Rtmp, scratch, stream);
}
