// Asynchronous global-to-shared copies (cp.async, sm_80 and later) and
// named block barriers, for the register-tiled bodies of K2 and K4
// (qr_common.cuh).
#pragma once
#include <cuda_runtime.h>

namespace repro {

// 16 bytes from global memory to shared memory without passing through
// registers, cached in L2 only (so data written earlier in the same launch
// by another block is read coherently). The first src_bytes bytes come
// from src, the rest of the 16 are zero; src_bytes = 0 reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

// Close the group of copies this thread issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Barrier `id` over `count` threads of the block (a multiple of 32), with
// the memory ordering of __syncthreads among them. Two tiles that share a
// block (the fused K5/K6) synchronise on their own ids.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

}  // namespace repro
