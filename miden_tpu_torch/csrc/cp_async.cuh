// Asynchronous device-to-shared copies (sm_80+ `cp.async`), shared by the
// kernels that stage tiles in shared memory (K1's column tiles, K3's rate
// blocks).
#pragma once

#include <cstdint>

namespace cp_async {

// 16 bytes, cached in L2 only: dst and src 16-byte aligned.
__device__ __forceinline__ void copy16(uint64_t* dst, const uint64_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

// 8 bytes: dst and src 8-byte aligned.
__device__ __forceinline__ void copy8(uint64_t* dst, const uint64_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src));
}

// Close this thread's copies issued since the last commit into one group.
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Wait until at most N of this thread's groups are still in flight. Other
// threads' copies are visible after a __syncthreads that follows.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace cp_async
