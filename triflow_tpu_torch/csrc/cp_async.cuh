// Asynchronous copies from global to shared memory (cp.async, sm_80 and
// later), shared by the staged kernels: K2's chunk walk (spike_factor.cu),
// K3's sweep (spike_solve.cu) and K4's cluster solve (pcr.cu).  A copy of
// one element (4 or 8 bytes) goes through L1 (.ca): the kernels also read
// back data their own block wrote to global memory earlier in the launch.
#pragma once

namespace tf {

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most kPending committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace tf
