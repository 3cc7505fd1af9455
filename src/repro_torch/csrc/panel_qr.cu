// K1: masked Householder panel QR with compact-WY output, a team of C
// thread blocks per lane.
//
// Replaces the TPU kernel src/repro/kernels/panel_qr.py::panel_qr (body
// panel_qr_math), the leaf of every panel of the FT-CAQR sweep and of
// every REBUILD replay.
//
// What bounds it on the H100: the column loop. Each of the b columns needs
// a norm, a product w = v^T A and a rank-1 update over the (m x b) tile,
// each after the previous one, so the kernel waits on latency; its
// floating-point work (about 3 m b^2 operations per lane) would take the
// card's FP32 pipes microseconds.
//
// The design (team_qr in qr_common.cuh): each lane runs on a thread-block
// cluster of C = team_blocks(m, b) blocks of 512 threads, each holding one
// slab of ceil(m / C) rows column-major in its shared memory (at m = 4096,
// b = 128: 16 blocks of 256 rows, 135 KB each with two scratch columns),
// so the column loop's passes read shared memory instead of a 2 MiB tile
// in L2, on 16 SMs per lane instead of 1. The blocks exchange their
// partial sums through distributed shared memory behind one cluster
// barrier a column and sum them in rank order, so every block holds the
// same bits. A panel whose slab does not fit even at C = 16 keeps it in
// the global scratch `work`. The H100 holds 7 clusters of 16 blocks at
// once at that shared memory, so 8 lanes of 4096 x 128 run in two waves.
// No tensor cores: the sums run as IEEE FP32 FFMA, since TF32 would not
// meet the 3e-4 tolerance.
//
// bf16 (panel_qr_bf16, b <= 128): the same kernel, team size and shared
// memory on a bf16 panel: the slab fill widens each element, Y, T and R
// are rounded once as they are stored, and G^T goes to a float scratch
// (`gram`) instead of T's lower triangle. Its bits are the float kernel's
// on the widened panel, rounded; the one-lane REBUILD launch gives a lane
// the bits it has in a P-lane launch, as at float.
#include "qr_common.cuh"

using namespace repro;

template <class E>
__global__ void __launch_bounds__(QR_THREADS, 1)
panel_qr_kernel(const E* __restrict__ A, long long a_bs, long long a_ld,
                const int* __restrict__ rs, E* Y, E* T, E* R, float* gram,
                float* work, int m, int b, int C, int slab_in_smem) {
  extern __shared__ __align__(16) float smem[];
  const int rank = (int)cg::this_cluster().block_rank();
  const int p = blockIdx.x / C;
  const TeamSmem sm(smem, m, b, C, slab_in_smem);
  ClusterExchange ex{sm.slots, b, C, rank};
  A += p * a_bs, Y += (size_t)p * m * b, T += (size_t)p * b * b;
  R += (size_t)p * b * b;
  float* G = gram_scratch(T, gram + (size_t)p * b * b);
  if (slab_in_smem) {
    team_qr<true>(A, a_ld, Y, T, R, G, m, b, rs[p], C, rank, nullptr, smem, ex);
  } else {
    float* slab = work + ((size_t)p * C + rank) * team_cols(b) *
                             team_ld(team_rows(m, C));
    team_qr<false>(A, a_ld, Y, T, R, G, m, b, rs[p], C, rank, slab, smem, ex);
  }
}

extern "C" size_t panel_qr_smem_bytes(int m, int b, int C) {
  return team_smem_floats(m, b, C, team_slab_in_smem(m, b, C)) * sizeof(float);
}

// Floats of global scratch a lane needs (0 when the slabs are in shared
// memory).
extern "C" size_t panel_qr_work_floats(int m, int b, int C) {
  return team_slab_in_smem(m, b, C) ? 0 : team_work_floats(m, b, C);
}

// The launch of P lanes on teams of C: grid P * C, clusters of C.
template <class E>
static cudaError_t configure(int P, int m, int b, int C, cudaStream_t stream,
                             cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (C < 1 || C > TEAM_MAX || (C & (C - 1)) != 0) return cudaErrorInvalidValue;
  const size_t smem = panel_qr_smem_bytes(m, b, C);
  cudaError_t err = cudaFuncSetAttribute(
      panel_qr_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(panel_qr_kernel<E>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(P * C);
  cfg->blockDim = dim3(QR_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of C blocks of K1 the card holds at once at the shared
// memory an (m x b) panel needs (cudaOccupancyMaxActiveClusters).
extern "C" int panel_qr_max_clusters(int m, int b, int C, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<float>(C, m, b, C, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(out, panel_qr_kernel<float>, &cfg);
}

template <class E>
static int panel_qr_entry(const void* A, long long a_bs, long long a_ld,
                          const void* rs, void* Y, void* T, void* R,
                          void* gram, void* work, int P, int m, int b, int C,
                          void* stream) {
  if (C != team_blocks(m, b)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<E>(P, m, b, C, (cudaStream_t)stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, panel_qr_kernel<E>, (const E*)A, a_bs, a_ld,
                           (const int*)rs, (E*)Y, (E*)T, (E*)R, (float*)gram,
                           (float*)work, m, b, C,
                           (int)team_slab_in_smem(m, b, C));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A: P panels (m x b), lane stride a_bs and row stride a_ld in elements,
// unit column stride. rs: P int32 row starts (device). Y: P*m*b elements;
// T, R: P*b*b; all float (panel_qr_f32) or all bf16 (panel_qr_bf16). gram:
// P*b*b floats of scratch at bf16 (G^T); unused at float (null allowed).
// work: P * panel_qr_work_floats(m, b, C) floats. C: the team size,
// team_blocks(m, b) (checked).
extern "C" int panel_qr_f32(const void* A, long long a_bs, long long a_ld,
                            const void* rs, void* Y, void* T, void* R,
                            void* gram, void* work, int P, int m, int b, int C,
                            void* stream) {
  return panel_qr_entry<float>(A, a_bs, a_ld, rs, Y, T, R, gram, work, P, m, b,
                               C, stream);
}

extern "C" int panel_qr_bf16(const void* A, long long a_bs, long long a_ld,
                             const void* rs, void* Y, void* T, void* R,
                             void* gram, void* work, int P, int m, int b,
                             int C, void* stream) {
  return panel_qr_entry<bf16>(A, a_bs, a_ld, rs, Y, T, R, gram, work, P, m, b,
                              C, stream);
}
