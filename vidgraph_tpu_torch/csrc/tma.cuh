// Helpers shared by the kernels that load tiles by TMA (Hopper, sm_90a):
// the mbarriers the copies complete and libcuda's tensor-map encoder.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vg_tma {

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrives on bar and adds `bytes` to the copies it waits for.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// libcuda's tensor-map encoder, found once through the runtime (no link
// against libcuda); null where it is not offered.
inline PFN_cuTensorMapEncodeTiled encoder() {
  static PFN_cuTensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }();
  return fn;
}

}  // namespace vg_tma
