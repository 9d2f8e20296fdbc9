// Shared-memory transaction barriers (mbarrier) of Hopper, as soft_nms.cu
// and fused_dw.cu use them: a phase completes when its one arrival has come
// and the bytes it expects have been stored into the block by asynchronous
// copies (st.async from another block of the cluster, or a bulk copy of the
// tensor memory accelerator).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace udal {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one arrival a phase; visible to the other blocks of the cluster and to
// the asynchronous proxy after the fence and a barrier
__device__ __forceinline__ void mbarrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The phase's arrival, which also waits for `bytes` stored asynchronously
__device__ __forceinline__ void mbarrier_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with this parity is complete; the stores
// it counted are visible after it, to this block (kCluster false: bulk
// copies) or across the cluster (kCluster true: st.async of other blocks).
template <bool kCluster>
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, unsigned parity) {
  if constexpr (kCluster) {
    asm volatile(
        "{\n.reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" ::"r"(smem_u32(bar)),
        "r"(parity)
        : "memory");
  } else {
    asm volatile(
        "{\n.reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" ::"r"(smem_u32(bar)),
        "r"(parity)
        : "memory");
  }
}

// shared-memory writes of the generic proxy (st.shared) are ordered before
// the asynchronous proxy's later writes to the same place after this
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, by the tensor memory accelerator; counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace udal
