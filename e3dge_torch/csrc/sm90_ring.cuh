// PTX helpers shared by the two field kernels (siren_field_sm90.cu, serving;
// siren_field.cu, highest): mbarriers, bulk copies (TMA engine), the wgmma
// shared-memory descriptor, and the weight ring with its producer loop.
// Included by both sources; ops/siren_field.py hashes it into the build digest.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Waits for the phase of `bar` with the given parity to complete. A wait that
// outlasts ~2^24 polls (seconds) traps: a broken pipeline fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// one bulk copy global -> shared, completion counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void wg_bar(int id) {  // the 128 threads of one warpgroup
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// generic-proxy shared writes -> visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of 128 B,
// 8-row groups 1024 B apart (SBO); the start address steps 32 B per K slice
// (k16 of bf16, k8 of tf32).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// The weight ring: NSTAGE stage buffers of `bytes` each, a full and an empty
// mbarrier per stage, and the count of stages consumed so far.
struct Ring {
  uint32_t smem, full, empty;  // stage buffers; full and empty mbarriers
  uint32_t s;                  // stages consumed so far
};

// Thread 0 sets up the ring's barriers: full completes on the bulk copy's
// bytes, empty on one arrival per consumer warp.
__device__ __forceinline__ void ring_init(const Ring& ring, int nstage, int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < nstage; ++i) {
      mbar_init(ring.full + 8 * i, 1);
      mbar_init(ring.empty + 8 * i, consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The producer (one thread): for each of this CTA's tiles, the per_tile stages
// of the layers 1..D-1 (`wring`, contiguous) then of the view layer
// (`wvring`), each one bulk copy into the next free stage buffer.
template <int NSTAGE, uint32_t STAGE_BYTES>
__device__ __forceinline__ void produce(const Ring& ring, const void* wring, const void* wvring, int per_tile,
                                        int view_stages, int n_tiles) {
  const int backbone = per_tile - view_stages;
  const uint8_t* wr = static_cast<const uint8_t*>(wring);
  const uint8_t* wv = static_cast<const uint8_t*>(wvring);
  uint32_t s = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    for (int i = 0; i < per_tile; ++i, ++s) {
      const uint32_t stage = s % NSTAGE;
      mbar_wait(ring.empty + 8 * stage, ((s / NSTAGE) & 1) ^ 1);
      const uint8_t* src = i < backbone ? wr + (size_t)i * STAGE_BYTES : wv + (size_t)(i - backbone) * STAGE_BYTES;
      mbar_expect_tx(ring.full + 8 * stage, STAGE_BYTES);
      bulk_load(ring.smem + stage * STAGE_BYTES, src, STAGE_BYTES, ring.full + 8 * stage);
    }
  }
}

}  // namespace sm90
