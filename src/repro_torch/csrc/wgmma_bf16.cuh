// The bf16 products of K2 and K4 (and of K5/K6, which contain them) on
// Hopper's tensor cores: the building blocks of a warpgroup's wgmma
// product with bf16 operands read from shared memory and f32 accumulators
// in registers, shared by the b <= 128 engine (qr_common.cuh,
// apply_engine's bf16 body) and the products above 128 columns
// (wide_common.cuh, wg_gemm_tile).
//
// Replaces, at bf16, the products inside src/repro/kernels/wy_apply.py::
// wy_apply (Z = Y^T C, W = T^T Z, out = C - Y W) and src/repro/kernels/
// stacked_qr.py::stacked_apply (inner = C_top + Y2^T C_bot, W = T^T inner,
// C_bot - Y2 W), whose tile programs accumulate in f32. Y, T, C and their
// outputs are bf16; the intermediates Z (inner) and W stay f32, as the
// reference keeps them. What bounds them on the H100: the bytes of C
// (K2: 4 m n bytes read and written, about b / 2 operations a byte; at b =
// 128-256 far below the 295 a byte where the card's 989 TFLOP/s of bf16
// would bound it), once the products run on the tensor cores; on the FP32
// FFMA body they ran at 67 TFLOP/s and were bound by it.
//
// The split of an f32 operand. A product of a bf16 A with an f32 X (T^T Z,
// Y W) runs as two bf16 products into one f32 accumulator:
//     X_hi = bf16(X), X_lo = bf16(X - X_hi)   (round to nearest even),
//     A X = A X_hi + A X_lo,
// which carries X to about 16 significant bits (2^-8 of the bf16 output's
// own rounding); X - X_hi is exact in f32. kernels/ref.py::split_bf16 is
// the same rule in PyTorch.
//
// The order contract (the f32 products' is csrc/wide_common.cuh's header).
// For every output element:
//   * each 256-term block of k is a chain of wgmma k16 steps in ascending
//     k, the first step starting from a zeroed accumulator (scale-d 0), a
//     step on a split operand running the X_hi pass and then the X_lo pass;
//     a chain takes exactly the steps that hold at least one term (k0 <
//     K), each zero-padded past K;
//   * the block sums are added in block order from +0.0f in FP32;
//   * then the epilogue (D + tot, D - tot, tot or -tot, and E - tot),
//     rounded once where a bf16 tensor is stored.
// Neither the tile, the wgmma N, the thread, the copy path, the lane count
// nor a split of k at block boundaries enters a sum, so a lane gives the
// same bits alone as in any launch, and the fused K5/K6 equal K1-K4. The
// sum inside one k16 step is the tensor core's own, which no CPU oracle
// reproduces bit for bit: the tests hold the kernels to a split emulation
// in f32 (kernels/ref.py) within one bf16 ulp, to the plain version within
// the bf16 tolerance, and to the float64 error of the f32 kernel on the
// widened inputs (the witness).
//
// Shared memory layout (no swizzle): an operand tile of MN extent EXT and
// K extent KX is a grid of core matrices of 8 x 8 elements, each 128
// contiguous bytes: core (kg, mg) at byte (kg * EXT / 8 + mg) * 128, so
// core matrices adjacent along MN are 128 bytes apart (the descriptor's
// stride byte offset) and along K EXT * 16 (its leading byte offset).
// Inside a core matrix each 16-byte row holds 8 elements that are
// consecutive along K (a K-major operand, wgmma's transpose bit 0) or
// along MN (MN-major, bit 1). A 16-byte run of a row-major global matrix
// is then one core-matrix row in either order, so cp.async copies raw
// bf16 bytes straight into place (Y^T, T^T and C MN-major, Y K-major),
// eight consecutive threads filling one core matrix (no bank conflict);
// an f32 operand is loaded through registers, split, and stored the same
// way. Copies read through L2 only (cp.async.cg, __ldcg), so a cooperative
// kernel reads what other blocks wrote earlier in the launch; rows and
// columns outside the matrix are zero-filled, so padding adds exact zeros.
// Writes by the generic proxy (st.shared, cp.async) are made visible to
// wgmma (the async proxy) by fence.proxy.async before the barrier that
// precedes the wgmma; each slice's wgmmas are committed as a group and
// waited for before its stage is refilled or its accumulators read.
#pragma once
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "elem.cuh"

namespace repro {

constexpr int WG_STEP = 16;   // k of one wgmma step (bf16)
constexpr int WG_CHAIN = 256; // k of one block sum (16 steps)

// -- descriptors and the layout -------------------------------------------

// Byte offset of core matrix (kg, mg) in a tile of MN extent ext.
__device__ __forceinline__ int wg_core(int ext, int kg, int mg) {
  return (kg * (ext >> 3) + mg) << 7;
}

// Byte offset of element (mn, k) in a tile of MN extent ext.
template <bool MN_MAJOR>
__device__ __forceinline__ int wg_off(int ext, int mn, int k) {
  return wg_core(ext, k >> 3, mn >> 3) +
         (MN_MAJOR ? ((k & 7) << 4) + ((mn & 7) << 1)
                   : ((mn & 7) << 4) + ((k & 7) << 1));
}

// The wgmma shared-memory descriptor of the sub-tile at (mn0, k0) of a
// tile of MN extent ext at `tile` (no swizzle: layout type 0, base offset
// 0): start address, leading byte offset (K direction) ext * 16, stride
// byte offset (MN direction) 128, each in 16-byte units.
__device__ __forceinline__ uint64_t wg_desc(const void* tile, int ext, int mn0,
                                            int k0) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(tile) +
                     wg_core(ext, k0 >> 3, mn0 >> 3);
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)(((uint32_t)ext * 16u >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((128u >> 4) & 0x3FFF) << 32);
}

// -- the warpgroup's instructions ------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory (st.shared, landed cp.async) made
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of the accumulators across a
// wgmma wait (the registers change behind its back until then).
template <int R>
__device__ __forceinline__ void wg_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B for a 64 x N x 16 step: A and B by their descriptors, TA / TB
// 1 for an MN-major operand; accumulate 0 starts from zero (scale-d 0).
// d holds N / 2 floats a thread (wg_row / wg_col).
template <int TA, int TB>
__device__ __forceinline__ void wg_mma(float (&d)[8], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wg_mma(float (&d)[16], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wg_mma(float (&d)[32], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wg_mma(float (&d)[64], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}


// Row and column, in the warpgroup's 64 x N tile, of accumulator j of the
// thread t (0..127) of the warpgroup: warp t / 32 holds rows 16 (t / 32)
// up, each 8-column group c holding j = 4c..4c+3 at rows l / 4 and l / 4 +
// 8, columns 2 (l % 4) and the next (l the lane).
__device__ __forceinline__ int wg_row(int j, int t) {
  return ((t >> 5) << 4) + ((t & 31) >> 2) + (((j >> 1) & 1) << 3);
}
__device__ __forceinline__ int wg_col(int j, int t) {
  return ((j >> 2) << 3) + ((t & 3) << 1) + (j & 1);
}

// -- staging ----------------------------------------------------------------

// 16 bytes from global to shared memory through L2 only; the first
// src_bytes come from src, the rest are zero (src_bytes 0 reads nothing).
__device__ __forceinline__ void cp_async16b(void* dst, const void* src,
                                            int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ unsigned short bf16_bits(const bf16* p) {
  return __ldcg(reinterpret_cast<const unsigned short*>(p));
}

// The split of one f32 value (see the top): hi = bf16(x), lo = bf16(x -
// hi), as bits.
__device__ __forceinline__ void split_bf16(float x, unsigned short& hi,
                                           unsigned short& lo) {
  const bf16 h = __float2bfloat16_rn(x);
  hi = __bfloat16_as_ushort(h);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(x - __bfloat162float(h)));
}

// Stages rows [r0, r0 + ROWS) and columns [c0, c0 + 8 CH) of a matrix
// (nrows x ncols; element (r, c) at src[r * ld_r + c * ld_c]) into an
// operand tile at dst, zero outside the matrix. MN: the rows are the K
// index and the columns the MN index (an MN-major tile of extent 8 CH);
// else the rows are MN (a K-major tile of extent ROWS) and the columns K.
// Each unit is 8 consecutive columns of one row, one core-matrix row: by
// one 16-byte cp.async where `vec` (ld_c 1, ld_r and c0 multiples of 8, a
// 16-byte aligned src), else element by element. NT threads (tid).
template <int ROWS, int CH, bool MN, int NT>
__device__ __forceinline__ void wg_stage(void* dst, const bf16* src,
                                         long long ld_r, long long ld_c,
                                         int r0, int nrows, int c0, int ncols,
                                         int tid, bool vec) {
  constexpr int EXT = MN ? 8 * CH : ROWS;
  constexpr int UNITS = ROWS * CH;
#pragma unroll
  for (int u0 = 0; u0 < UNITS; u0 += NT) {
    const int u = u0 + tid;
    if (UNITS % NT != 0 && u >= UNITS) break;
    const int r = (u & 7) + ((u >> 3) / CH) * 8, ch = (u >> 3) % CH;
    char* d = (char*)dst + (MN ? wg_core(EXT, r >> 3, ch) : wg_core(EXT, ch, r >> 3)) +
              ((r & 7) << 4);
    const int gr = r0 + r, gc = c0 + ch * 8;
    if (vec) {
      const int n = gr < nrows ? max(0, min(8, ncols - gc)) : 0;
      cp_async16b(d, n ? (const void*)(src + gr * ld_r + gc) : (const void*)src,
                  2 * n);
    } else {
      unsigned w[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const unsigned short lo =
            gr < nrows && gc + e < ncols ? bf16_bits(src + gr * ld_r + (gc + e) * ld_c) : 0;
        const unsigned short hi =
            gr < nrows && gc + e + 1 < ncols
                ? bf16_bits(src + gr * ld_r + (gc + e + 1) * ld_c) : 0;
        w[e >> 1] = (unsigned)lo | ((unsigned)hi << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The split staging of rows [r0, r0 + ROWS) (K) and columns [c0, c0 + 8
// CH) (MN) of an f32 matrix (element (r, c) at src[r * ld_r + c * ld_c])
// into two MN-major tiles, hi and lo, zero outside the matrix, in two
// halves: load() brings this thread's units (8 floats each) into
// registers, by two 16-byte loads where `vec` (ld_c 1, ld_r and c0
// multiples of 4, a 16-byte aligned src), else one by one; store() splits
// and writes them. A caller issues load() before it multiplies the current
// slice and store() after, so the loads' latency overlaps the products.
template <int ROWS, int CH, int NT>
struct SplitStage {
  static constexpr int UNITS = ROWS * CH;
  static constexpr int U = (UNITS + NT - 1) / NT;  // units a thread
  float x[U][8];

  __device__ __forceinline__ void load(const float* src, long long ld_r,
                                       long long ld_c, int r0, int nrows,
                                       int c0, int ncols, int tid, bool vec) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = i * NT + tid;
      const int r = (u & 7) + ((u >> 3) / CH) * 8, ch = (u >> 3) % CH;
      const int gr = r0 + r, gc = c0 + ch * 8;
      if (UNITS % NT != 0 && u >= UNITS) continue;
      if (vec && gr < nrows && gc + 8 <= ncols) {
        const float4 a = __ldcg(reinterpret_cast<const float4*>(src + gr * ld_r + gc));
        const float4 b = __ldcg(reinterpret_cast<const float4*>(src + gr * ld_r + gc + 4));
        x[i][0] = a.x, x[i][1] = a.y, x[i][2] = a.z, x[i][3] = a.w;
        x[i][4] = b.x, x[i][5] = b.y, x[i][6] = b.z, x[i][7] = b.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          x[i][e] = gr < nrows && gc + e < ncols
                        ? __ldcg(src + gr * ld_r + (gc + e) * ld_c) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(void* hi, void* lo, int tid) const {
    constexpr int EXT = 8 * CH;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = i * NT + tid;
      if (UNITS % NT != 0 && u >= UNITS) continue;
      const int r = (u & 7) + ((u >> 3) / CH) * 8, ch = (u >> 3) % CH;
      const int off = wg_core(EXT, r >> 3, ch) + ((r & 7) << 4);
      unsigned h[4], l[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        unsigned short h0, l0, h1, l1;
        split_bf16(x[i][e], h0, l0);
        split_bf16(x[i][e + 1], h1, l1);
        h[e >> 1] = (unsigned)h0 | ((unsigned)h1 << 16);
        l[e >> 1] = (unsigned)l0 | ((unsigned)l1 << 16);
      }
      *reinterpret_cast<uint4*>((char*)hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>((char*)lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
};

// The split of two f32 values at (k, mn) and (k, mn + 1) (mn even) stored
// into MN-major tiles hi and lo of extent ext (one 4-byte store each).
__device__ __forceinline__ void wg_put_split2(void* hi, void* lo, int ext,
                                              int k, int mn, float x0,
                                              float x1) {
  unsigned short h0, l0, h1, l1;
  split_bf16(x0, h0, l0);
  split_bf16(x1, h1, l1);
  const int off = wg_off<true>(ext, mn, k);
  *reinterpret_cast<unsigned*>((char*)hi + off) = (unsigned)h0 | ((unsigned)h1 << 16);
  *reinterpret_cast<unsigned*>((char*)lo + off) = (unsigned)l0 | ((unsigned)l1 << 16);
}

// Two consecutive elements through L2 (an 8-byte float or 4-byte bf16
// access, aligned), widened, and their store (bf16 rounded).
__device__ __forceinline__ float2 ldcg2(const float* p) {
  return __ldcg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldcg2(const bf16* p) {
  const unsigned u = __ldcg(reinterpret_cast<const unsigned*>(p));
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ void stv2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void stv2(bf16* p, float2 v) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16x2(v.x, v.y);
}

// Two consecutive elements (r, col) and (r, col + 1) of an (nrows x ncols)
// bf16 matrix with row stride ld, widened, zero outside; vec: one aligned
// 4-byte access (col even, ld even, the base 4-byte aligned).
__device__ __forceinline__ float2 ld2(const bf16* p, long long ld, int r,
                                      int nrows, int col, int ncols, bool vec) {
  float2 v = make_float2(0.f, 0.f);
  if (r >= nrows || col >= ncols) return v;
  const bf16* q = p + (size_t)r * ld + col;
  if (vec && col + 1 < ncols) return ldcg2(q);
  v.x = ldcg1(q);
  if (col + 1 < ncols) v.y = ldcg1(q + 1);
  return v;
}

// out[r][c..c+15] = C[r][c..c+15] - v[0..15], rounded, for the elements
// inside the (nrows x ncols) matrices (row strides o_ld and c_ld); vec:
// 16-byte accesses (c a multiple of 8, both strides and bases aligned).
__device__ __forceinline__ void wg_sub_store16(bf16* out, long long o_ld,
                                               const bf16* C, long long c_ld,
                                               int r, int nrows, int c,
                                               int ncols, bool vec,
                                               const float (&v)[16]) {
  if (r >= nrows || c >= ncols) return;
  const bf16* src = C + (size_t)r * c_ld + c;
  bf16* dst = out + (size_t)r * o_ld + c;
  if (vec && c + 16 <= ncols) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 u = __ldcg(reinterpret_cast<const uint4*>(src + 8 * h));
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
      unsigned o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o[q] = pack_bf16x2(__uint_as_float(w[q] << 16) - v[8 * h + 2 * q],
                           __uint_as_float(w[q] & 0xffff0000u) - v[8 * h + 2 * q + 1]);
      *reinterpret_cast<uint4*>(dst + 8 * h) = make_uint4(o[0], o[1], o[2], o[3]);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (c + e < ncols) dst[e] = __float2bfloat16_rn(ldcg1(src + e) - v[e]);
}

// Store the elements of v that fall inside the matrix (see ld2), rounded.
__device__ __forceinline__ void st2(bf16* p, long long ld, int r, int nrows,
                                    int col, int ncols, bool vec, float2 v) {
  if (r >= nrows || col >= ncols) return;
  bf16* q = p + (size_t)r * ld + col;
  if (vec && col + 1 < ncols) {
    stv2(q, v);
    return;
  }
  q[0] = __float2bfloat16_rn(v.x);
  if (col + 1 < ncols) q[1] = __float2bfloat16_rn(v.y);
}

}  // namespace repro
