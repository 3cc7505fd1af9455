// Shared device code of the port's kernels: a masked Householder QR of one
// (m x b) tile run by one thread block, with the compact-WY T factor, and
// the per-lane / per-tile bodies of K1 (panel_qr_lane), K2 (wy_apply_tile),
// K3 (stacked_qr_lane) and K4 (stacked_apply_tile). The kernels K1-K4 and
// the fused K5/K6 (fused_sweep.cu) all call these bodies, so the fused
// kernels compute every element by the same operations in the same order
// as the stepped ones, which the fused == stepped bitwise contract needs.
//
// The arithmetic follows src/repro/kernels/panel_qr.py::panel_qr_math:
// column j pivots at row_start + j; rows above the pivot are neither read
// nor written; beta = -sign(x0)*||x|| with sign(0) = +1; a column with
// ||x|| <= 1e-30 gives tau = 0 and v = e_pivot; the rank-1 update spans
// the full tile width; T comes from the forward recurrence over G = Y^T Y.
//
// Determinism: every sum runs in a fixed order (per-thread partials over a
// fixed row assignment, then a fixed tree); there are no atomics, and no
// sum depends on the block index. So a tile gives the same bits in any
// lane of any launch, which the FT butterfly and recovery rely on.
#pragma once
#include <cuda_runtime.h>

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

// Loads of the small factors (T, Y2) that the tile bodies read through a
// cache: the read-only path (__ldg) where they are inputs of the launch
// (K2, K4), the L2 path (__ldcg) where the same launch wrote them in an
// earlier phase (K5, K6), since the read-only cache is not coherent with
// writes made during the launch. Both load the same value.
template <bool NC>
__device__ inline float ld_factor(const float* p) {
  if constexpr (NC) return __ldg(p);
  else return __ldcg(p);
}

// -- K2's tile: out = C - Y (T^T (Y^T C)) for 32 columns of one lane --------

constexpr int WY_THREADS = 256;
constexpr int WY_BN = 32;                     // columns per tile
constexpr int WY_RM = 32;                     // rows per staged chunk
constexpr int WY_NG = WY_THREADS / WY_BN;     // row groups
constexpr int WY_MAX_B = 128;
constexpr int WY_PK = WY_MAX_B / WY_NG;       // rows of W per thread
constexpr int WY_RK = WY_RM / WY_NG;          // output rows per thread per chunk

// Floats of shared memory one wy_apply_tile needs.
__host__ __device__ inline size_t wy_tile_smem_floats(int b) {
  return (size_t)WY_RM * b + WY_RM * WY_BN + (size_t)b * WY_BN;
}

__device__ inline void wy_load_rows(float* ys, const float* Yp, int i0, int m,
                                    int b, int tid) {
  for (int e = tid; e < WY_RM * b; e += WY_THREADS) {
    const int i = i0 + e / b;
    ys[e] = i < m ? Yp[(size_t)i * b + e % b] : 0.f;
  }
}

// One tile of K2, run by WY_THREADS threads (tid = 0..255) of the block:
// columns [col0, col0 + 32) of lane slices Yp (m x b), Tp (b x b), Cp
// (m x n, row stride c_ld) into Op (row stride o_ld). Each thread walks the
// m rows twice in chunks staged in shared memory: W1 = Y^T C (up to 16
// sums per thread in registers, in row order), W = T^T W1, out = C - Y W.
// Every column's sums run in a fixed order that depends on nothing but the
// column, so the bits do not depend on the tile, the lane or the launch.
// A tile with col0 >= n reads zeros and writes nothing. Contains block
// barriers, so every thread of the block must call it the same number of
// times; it ends with one.
template <bool NC>
__device__ inline void wy_apply_tile(const float* Yp, const float* Tp,
                                     const float* Cp, long long c_ld, float* Op,
                                     long long o_ld, int m, int b, int n,
                                     int col0, int tid, float* smem) {
  float* ys = smem;               // WY_RM x b rows of Y
  float* cs = ys + WY_RM * b;     // WY_RM x WY_BN rows of C
  float* ws = cs + WY_RM * WY_BN; // b x WY_BN: W1, then W
  const int c = tid % WY_BN, g = tid / WY_BN;
  const int col = col0 + c;
  const bool ok = col < n;

  float acc[WY_PK];
#pragma unroll
  for (int k = 0; k < WY_PK; ++k) acc[k] = 0.f;
  // W1 = Y^T C
  for (int i0 = 0; i0 < m; i0 += WY_RM) {
    wy_load_rows(ys, Yp, i0, m, b, tid);
    for (int e = tid; e < WY_RM * WY_BN; e += WY_THREADS) {
      const int i = i0 + e / WY_BN, cc = col0 + e % WY_BN;
      cs[e] = (i < m && cc < n) ? Cp[(size_t)i * c_ld + cc] : 0.f;
    }
    __syncthreads();
    for (int ii = 0; ii < WY_RM; ++ii) {
      const float cv = cs[ii * WY_BN + c];
#pragma unroll
      for (int k = 0; k < WY_PK; ++k) {
        const int q = g + k * WY_NG;
        if (q < b) acc[k] += ys[ii * b + q] * cv;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < WY_PK; ++k) {
    const int q = g + k * WY_NG;
    if (q < b) ws[q * WY_BN + c] = acc[k];
  }
  __syncthreads();
  // W = T^T W1
#pragma unroll
  for (int k = 0; k < WY_PK; ++k) {
    const int r = g + k * WY_NG;
    if (r < b) {
      float s = 0.f;
      for (int q = 0; q < b; ++q) s += ld_factor<NC>(Tp + q * b + r) * ws[q * WY_BN + c];
      acc[k] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < WY_PK; ++k) {
    const int r = g + k * WY_NG;
    if (r < b) ws[r * WY_BN + c] = acc[k];
  }
  __syncthreads();
  // out = C - Y W
  for (int i0 = 0; i0 < m; i0 += WY_RM) {
    wy_load_rows(ys, Yp, i0, m, b, tid);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WY_RK; ++k) {
      const int ii = g + k * WY_NG, i = i0 + ii;
      float s = 0.f;
      for (int q = 0; q < b; ++q) s += ys[ii * b + q] * ws[q * WY_BN + c];
      if (i < m && ok) Op[(size_t)i * o_ld + col] = Cp[(size_t)i * c_ld + col] - s;
    }
    __syncthreads();
  }
}

// -- K4's tile: the trailing combine for 32 columns of one lane -------------

constexpr int SA_THREADS = 256;
constexpr int SA_BN = 32;                      // columns per tile
constexpr int SA_NG = SA_THREADS / SA_BN;      // row groups
constexpr int SA_MAX_B = 128;
constexpr int SA_PK = SA_MAX_B / SA_NG;        // rows per thread

// Floats of shared memory one stacked_apply_tile needs.
__host__ __device__ inline size_t sa_tile_smem_floats(int b) {
  return 2 * (size_t)b * SA_BN;
}

// One tile of K4, run by SA_THREADS threads (tid = 0..255) of the block:
//     W = T^T (C_top + Y2^T C_bot); ot = C_top - W; ob = C_bot - Y2 W
// for columns [col0, col0 + 32) of the lane slices Yp, Tp (b x b) and Ct,
// Cb (b x n, row stride ld); the outputs share that row stride and are all
// written (a caller that keeps only some passes a scratch sink for the
// rest: checks on the output pointers cost K4 16 registers and a third of
// its occupancy). The C_bot block and the intermediate stay in shared
// memory; every output column depends only on its own input column, in a
// fixed order. Contains block barriers (see wy_apply_tile) and does not end
// with one.
template <bool NC>
__device__ inline void stacked_apply_tile(const float* Yp, const float* Tp,
                                          const float* Ct, const float* Cb,
                                          long long ld, float* ot, float* ob,
                                          float* W, int b, int n, int col0,
                                          int tid, float* smem) {
  float* cb = smem;             // b x SA_BN block of C_bot
  float* buf = cb + b * SA_BN;  // the inner sum, then W
  const int c = tid % SA_BN, g = tid / SA_BN;
  const int col = col0 + c;
  const bool ok = col < n;

  for (int e = tid; e < b * SA_BN; e += SA_THREADS) {
    const int q = e / SA_BN, cc = col0 + e % SA_BN;
    cb[e] = cc < n ? Cb[(size_t)q * ld + cc] : 0.f;
  }
  __syncthreads();

  float acc[SA_PK];
  // inner = C_top + Y2^T C_bot
#pragma unroll
  for (int k = 0; k < SA_PK; ++k) {
    const int r = g + k * SA_NG;
    if (r < b) {
      float s = 0.f;
      for (int q = 0; q < b; ++q) s += ld_factor<NC>(Yp + q * b + r) * cb[q * SA_BN + c];
      acc[k] = (ok ? Ct[(size_t)r * ld + col] : 0.f) + s;
    }
  }
#pragma unroll
  for (int k = 0; k < SA_PK; ++k) {
    const int r = g + k * SA_NG;
    if (r < b) buf[r * SA_BN + c] = acc[k];
  }
  __syncthreads();
  // W = T^T inner
#pragma unroll
  for (int k = 0; k < SA_PK; ++k) {
    const int r = g + k * SA_NG;
    if (r < b) {
      float s = 0.f;
      for (int q = 0; q < b; ++q) s += ld_factor<NC>(Tp + q * b + r) * buf[q * SA_BN + c];
      acc[k] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SA_PK; ++k) {
    const int r = g + k * SA_NG;
    if (r < b) {
      buf[r * SA_BN + c] = acc[k];
      if (ok) {
        const size_t e = (size_t)r * ld + col;
        W[e] = acc[k];
        ot[e] = Ct[e] - acc[k];
      }
    }
  }
  __syncthreads();
  // C_bot - Y2 W
#pragma unroll
  for (int k = 0; k < SA_PK; ++k) {
    const int r = g + k * SA_NG;
    if (r < b) {
      float s = 0.f;
      for (int q = 0; q < b; ++q) s += ld_factor<NC>(Yp + r * b + q) * buf[q * SA_BN + c];
      if (ok) ob[(size_t)r * ld + col] = cb[r * SA_BN + c] - s;
    }
  }
}

}  // namespace repro
