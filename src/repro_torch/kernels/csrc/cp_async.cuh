// 16-byte asynchronous copies global -> shared (sm_80 and later), for the
// kernels that fill a ring of shared-memory stages while they compute.
#pragma once

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past src_bytes (0 or 16) are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// BYTES (4 or 8) global -> shared, both BYTES-aligned, through L1; bytes
// past src_bytes (0 or BYTES) are zeros
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            int src_bytes) {
  static_assert(BYTES == 4 || BYTES == 8, "cp.async.ca size");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(BYTES), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
