// Shared device code of the port's QR kernels K1 (panel_qr.cu) and
// K3 (stacked_qr.cu): a masked Householder QR of one (m x b) tile run by
// one thread block, with the compact-WY T factor.
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

}  // namespace repro
