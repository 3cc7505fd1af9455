// Shared device code of the port's kernels: a masked Householder QR of one
// (m x b) tile run by one thread block, with the compact-WY T factor, and
// the per-lane / per-tile bodies of K1 (panel_qr_lane), K2 (wy_apply_tile),
// K3 (stacked_qr_lane) and K4 (stacked_apply_tile). The kernels K1-K4 and
// the fused K5/K6 (fused_sweep.cu) all call these bodies, so the fused
// kernels compute every element by the same operations in the same order
// as the stepped ones, which the fused == stepped bitwise contract needs.
//
// The QR arithmetic follows src/repro/kernels/panel_qr.py::panel_qr_math:
// column j pivots at row_start + j; rows above the pivot are neither read
// nor written; beta = -sign(x0)*||x|| with sign(0) = +1; a column with
// ||x|| <= 1e-30 gives tau = 0 and v = e_pivot; the rank-1 update spans
// the full tile width; T comes from the forward recurrence over G = Y^T Y.
//
// Determinism: every sum runs in a fixed order (in the QR, per-thread
// partials over a fixed row assignment, then a fixed tree; in the K2/K4
// tiles, one sequential chain per element, see their section below);
// there are no atomics, and no sum depends on the block index. So a tile
// gives the same bits in any lane of any launch, which the FT butterfly
// and recovery rely on.
#pragma once
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace repro {

constexpr int QR_THREADS = 512;
constexpr int QR_MAX_B = 128;
constexpr int QR_G_PER_THREAD = QR_MAX_B * QR_MAX_B / QR_THREADS;
constexpr int QR_CHUNK = 16;  // rows of Y staged per step of G = Y^T Y
constexpr int QR_UNROLL = 16;  // tile loads a thread keeps in flight

// Floats of dynamic shared memory masked_qr needs for an (m x b) tile.
__host__ __device__ inline size_t qr_smem_floats(int m, int b) {
  const size_t G = QR_THREADS / b;
  const size_t cols = (size_t)m + G * b + b;
  const size_t tail = (size_t)b * b + (size_t)b * (b + 1) + (size_t)QR_CHUNK * b;
  return b + 33 + (cols > tail ? cols : tail);
}

// Sum of one value per thread in a fixed order: a shuffle-down tree in
// each warp, then the warp partials in warp order. All threads get it.
// `red` holds 33 floats of shared memory.
__device__ inline float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += red[w];
    red[32] = s;
  }
  __syncthreads();
  const float out = red[32];
  __syncthreads();
  return out;
}

// First row >= i0 of row group g when rows are dealt round-robin to G groups.
__device__ inline int first_row(int i0, int g, int G) {
  return i0 + ((g - i0 % G) % G + G) % G;
}

// Masked Householder QR of the tile W (m x b, row-major, leading dim b) in
// place, by one block of QR_THREADS threads. Writes Y (m x b), T and R
// (b x b), all row-major. R is rows [rs', rs' + b) of the transformed tile,
// rs' = clamp(rs, 0, m - b) as lax.dynamic_slice clamps. Needs
// qr_smem_floats(m, b) floats of shared memory at `smem`.
__device__ inline void masked_qr(float* W, float* Y, float* T, float* R,
                                 int m, int b, int rs, float* smem) {
  const int tid = threadIdx.x;
  const int G = QR_THREADS / b;        // row groups of the column passes
  const int c = tid % b, g = tid / b;  // this thread's column and row group
  const bool in_grid = g < G;
  float* taus = smem;                  // b
  float* red = taus + b;               // 33
  float* v = red + 33;                 // m: the current reflector
  float* wpart = v + m;                // G * b partial sums of w
  float* w = wpart + G * b;            // b

  for (int j = 0; j < b; ++j) {
    const int pivot = rs + j;
    const int i0 = pivot > 0 ? pivot : 0;
    float part = 0.f;
    for (int i = i0 + tid; i < m; i += QR_THREADS) {
      const float x = W[(size_t)i * b + j];
      part += x * x;
    }
    const float sumsq = block_sum(part, red);
    const float x0 = (pivot >= 0 && pivot < m) ? W[(size_t)pivot * b + j] : 0.f;
    const float sigma = sumsq - x0 * x0;
    const float norm = sqrtf(x0 * x0 + sigma);
    const float beta = (x0 >= 0.f) ? -norm : norm;
    const bool degenerate = norm <= 1e-30f;
    const float denom = degenerate ? 1.f : x0 - beta;
    const float tau = degenerate ? 0.f : (beta - x0) / beta;

    for (int i = tid; i < m; i += QR_THREADS) {
      float vi = 0.f;
      if (i == pivot) vi = 1.f;
      else if (i > pivot) vi = W[(size_t)i * b + j] / denom;
      v[i] = vi;
      Y[(size_t)i * b + j] = vi;
    }
    __syncthreads();

    // w = v^T W over the rows at and below the pivot (v is 0 above it).
    // The tile lives in L2, so each thread issues QR_UNROLL loads before
    // it uses them; the sum still runs in row order.
    if (in_grid) {
      float acc = 0.f;
      int i = first_row(i0, g, G);
      for (; i + (QR_UNROLL - 1) * G < m; i += QR_UNROLL * G) {
        float x[QR_UNROLL];
#pragma unroll
        for (int u = 0; u < QR_UNROLL; ++u) x[u] = W[(size_t)(i + u * G) * b + c];
#pragma unroll
        for (int u = 0; u < QR_UNROLL; ++u) acc += v[i + u * G] * x[u];
      }
      for (; i < m; i += G) acc += v[i] * W[(size_t)i * b + c];
      wpart[g * b + c] = acc;
    }
    __syncthreads();
    if (tid < b) {
      float s = 0.f;
      for (int gg = 0; gg < G; ++gg) s += wpart[gg * b + tid];
      w[tid] = s;
    }
    if (tid == 0) taus[j] = tau;
    __syncthreads();

    // W -= tau v w^T (tau = 0 leaves the tile as it is).
    if (in_grid && tau != 0.f) {
      const float wc = w[c];
      int i = first_row(i0, g, G);
      for (; i + (QR_UNROLL - 1) * G < m; i += QR_UNROLL * G) {
        float x[QR_UNROLL];
#pragma unroll
        for (int u = 0; u < QR_UNROLL; ++u) x[u] = W[(size_t)(i + u * G) * b + c];
#pragma unroll
        for (int u = 0; u < QR_UNROLL; ++u)
          W[(size_t)(i + u * G) * b + c] = x[u] - (tau * v[i + u * G]) * wc;
      }
      for (; i < m; i += G) {
        const size_t e = (size_t)i * b + c;
        W[e] = W[e] - (tau * v[i]) * wc;
      }
    }
    __syncthreads();
  }

  const int rstart = rs < 0 ? 0 : (rs > m - b ? m - b : rs);
  for (int e = tid; e < b * b; e += QR_THREADS) {
    const int r = e / b, cc = e % b;
    R[e] = (r <= cc) ? W[(size_t)(rstart + r) * b + cc] : 0.f;
  }

  // G = Y^T Y; rows above rs are zero in Y and are skipped.
  float* Gs = red + 33;           // b * b
  float* Ts = Gs + b * b;         // b * (b + 1), padded rows
  float* ych = Ts + b * (b + 1);  // QR_CHUNK * b
  const int tb = b + 1;
  float acc[QR_G_PER_THREAD];
#pragma unroll
  for (int k = 0; k < QR_G_PER_THREAD; ++k) acc[k] = 0.f;
  const int ibeg = ((rs > 0 ? rs : 0) / QR_CHUNK) * QR_CHUNK;
  for (int ic = ibeg; ic < m; ic += QR_CHUNK) {
    for (int e = tid; e < QR_CHUNK * b; e += QR_THREADS) {
      const int i = ic + e / b;
      ych[e] = i < m ? Y[(size_t)i * b + e % b] : 0.f;
    }
    __syncthreads();
    for (int ii = 0; ii < QR_CHUNK; ++ii) {
#pragma unroll
      for (int k = 0; k < QR_G_PER_THREAD; ++k) {
        const int e = tid + k * QR_THREADS;
        if (e < b * b)
          acc[k] += ych[ii * b + e / b] * ych[ii * b + e % b];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < QR_G_PER_THREAD; ++k) {
    const int e = tid + k * QR_THREADS;
    if (e < b * b) Gs[e] = acc[k];
  }
  for (int e = tid; e < b * tb; e += QR_THREADS) Ts[e] = 0.f;
  __syncthreads();

  // T[:j, j] = -tau_j T[:j, :j] G[:j, j]; T[j, j] = tau_j.
  for (int j = 0; j < b; ++j) {
    if (tid < j) {
      float s = 0.f;
      for (int i = 0; i < j; ++i) s += Ts[tid * tb + i] * Gs[i * b + j];
      Ts[tid * tb + j] = -taus[j] * s;
    } else if (tid == j) {
      Ts[j * tb + j] = taus[j];
    }
    __syncthreads();
  }
  for (int e = tid; e < b * b; e += QR_THREADS) T[e] = Ts[(e / b) * tb + e % b];
  __syncthreads();
}

// K1's body for one lane: copy the (possibly strided, row stride a_ld)
// panel into the contiguous scratch tile Wp, then masked_qr.
__device__ inline void panel_qr_lane(const float* Ap, long long a_ld, float* Y,
                                     float* T, float* R, float* Wp, int m, int b,
                                     int rs, float* smem) {
  for (int e = threadIdx.x; e < m * b; e += QR_THREADS)
    Wp[e] = Ap[(size_t)(e / b) * a_ld + e % b];
  __syncthreads();
  masked_qr(Wp, Y, T, R, m, b, rs, smem);
}

// K3's body for one lane: stack triu(Rt) over triu(Rb) in the scratch tile
// Wp (2b x b), QR it with row_start 0 (reflectors in the scratch Yp), and
// keep Y2 = triu of the reflectors' bottom half.
__device__ inline void stacked_qr_lane(const float* Rt, const float* Rb,
                                       float* Y2, float* T, float* R, float* Wp,
                                       float* Yp, int b, float* smem) {
  const size_t bb = (size_t)b * b;
  for (int e = threadIdx.x; e < b * b; e += QR_THREADS) {
    const bool up = e / b <= e % b;
    Wp[e] = up ? Rt[e] : 0.f;
    Wp[bb + e] = up ? Rb[e] : 0.f;
  }
  __syncthreads();
  masked_qr(Wp, Yp, T, R, 2 * b, b, 0, smem);
  for (int e = threadIdx.x; e < b * b; e += QR_THREADS)
    Y2[e] = (e / b <= e % b) ? Yp[bb + e] : 0.f;
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
// CopyPlan copies them in 16-byte units (cp.async) when every stride,
// width and pointer allows: unit u of a thread covers row first + u * step
// of the slice and four columns from its fixed column, all worked out once
// per tile. load_scalar copies any of them element by element through L2.
struct CopyPlan {
  int first, step, col;
  __device__ CopyPlan(int per_row, int tid)
      : first(tid / per_row), step(TILE_THREADS / per_row),
        col((tid % per_row) * 4) {}

  // UNITS 16-byte copies into dst (row stride dld) from src: row k of the
  // slice is row row0 + k of src, column c is column col0 + c.
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

__device__ inline void load_scalar(float* dst, int dld, int rows, int cols,
                                   const float* src, long long ld, int row0,
                                   int nrows, int col0, int ncols, int tid) {
  for (int u = tid; u < rows * cols; u += TILE_THREADS) {
    const int k = u / cols, c = u % cols, r = row0 + k, col = col0 + c;
    dst[k * dld + c] =
        (r < nrows && col < ncols) ? __ldcg(src + (size_t)r * ld + col) : 0.f;
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
// matrix with row stride ld, zero outside; vec: one aligned float4 load.
__device__ __forceinline__ float4 ld4(const float* p, long long ld, int r,
                                      int nrows, int col, int ncols, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= nrows || col >= ncols) return v;
  const float* q = p + (size_t)r * ld + col;
  if (vec) return __ldcg(reinterpret_cast<const float4*>(q));
  v.x = __ldcg(q);
  if (col + 1 < ncols) v.y = __ldcg(q + 1);
  if (col + 2 < ncols) v.z = __ldcg(q + 2);
  if (col + 3 < ncols) v.w = __ldcg(q + 3);
  return v;
}

// Store the elements of v that fall inside the matrix (see ld4).
__device__ __forceinline__ void st4(float* p, long long ld, int r, int nrows,
                                    int col, int ncols, bool vec, float4 v) {
  if (r >= nrows || col >= ncols) return;
  float* q = p + (size_t)r * ld + col;
  if (vec) {
    *reinterpret_cast<float4*>(q) = v;
    return;
  }
  q[0] = v.x;
  if (col + 1 < ncols) q[1] = v.y;
  if (col + 2 < ncols) q[2] = v.z;
  if (col + 3 < ncols) q[3] = v.w;
}

// The engine. Yf: R x b reflectors (row stride b); T: b x b; Cin: R x n
// (row stride c_ld) from column col0; out: R x n (row stride o_ld) gets
// Cin - Yf W. K4 (R = b): Ct, ot and Wout share Cin's row stride, and
// the intermediate is Ct + Yf^T Cin. Runs TILE_THREADS threads (tid) that
// synchronise on barrier bar_id only; needs tile_smem_floats(BN) floats at
// smem (16-byte aligned). VEC: every row stride, n, b and pointer allow
// 16-byte accesses (a compile-time choice: the scalar path's registers
// would otherwise spill the 16-byte path's). Ends with a barrier, after
// which smem may be reused and the tile's global writes are visible to its
// threads.
template <int BN, bool K4, bool VEC>
__device__ void apply_engine(const float* Yf, int R, const float* T, int b,
                             const float* Cin, long long c_ld, float* out,
                             long long o_ld, const float* Ct, float* ot,
                             float* Wout, int n, int col0, int tid, int bar_id,
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

// K2's tile: out = C - Y (T^T (Y^T C)) for columns [col0, col0 + BN) of one
// lane: Y (m x b) and T (b x b) contiguous, C (m x n) with row stride c_ld,
// out with row stride o_ld.
template <int BN, bool VEC>
__device__ inline void wy_apply_tile(const float* Y, const float* T,
                                     const float* C, long long c_ld, float* out,
                                     long long o_ld, int m, int b, int n,
                                     int col0, int tid, int bar_id,
                                     float* smem) {
  apply_engine<BN, false, VEC>(Y, m, T, b, C, c_ld, out, o_ld, nullptr,
                               nullptr, nullptr, n, col0, tid, bar_id, smem);
}

// K4's tile: W = T^T (Ct + Y2^T Cb); ot = Ct - W; ob = Cb - Y2 W for columns
// [col0, col0 + BN) of one lane: Y2 and T (b x b) upper triangular and
// contiguous (their lower triangles are not read), Ct, Cb and the three
// outputs (b x n) with row stride ld. All three outputs are written (a
// caller that keeps only some passes a scratch sink for the rest).
template <int BN, bool VEC>
__device__ inline void stacked_apply_tile(const float* Y2, const float* T,
                                          const float* Ct, const float* Cb,
                                          long long ld, float* ot, float* ob,
                                          float* W, int b, int n, int col0,
                                          int tid, int bar_id, float* smem) {
  apply_engine<BN, true, VEC>(Y2, b, T, b, Cb, ld, ob, ld, Ct, ot, W, n, col0,
                              tid, bar_id, smem);
}

}  // namespace repro
