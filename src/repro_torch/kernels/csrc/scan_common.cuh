// What the scan kernels (mamba_scan.cu, rwkv6_scan.cu) share: mbarriers in shared memory,
// and the transposing shuffle-reduce that sums several items over a group of lanes.
// kernels/build.py hashes this header into every library's name, so editing it rebuilds
// both.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// mbarriers in shared memory: init, arrive, and a wait that traps (failing the launch)
// instead of hanging the card if a phase never completes.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  asm volatile("{\n"
               ".reg .pred p;\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n"
               "}\n" : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done;
}
// Wait until the phase of `bar` with this parity has completed.  A copy that never lands
// fails the launch (trap) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  for (unsigned n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 22)) __trap();
}

// One level of group_transpose_sum: lanes gi and gi ^ HALF exchange halves of their first
// 2 HALF items, each keeping the half its bit HALF selects, then the next level.  HALF is a
// template argument so that every loop has a constant trip count and v stays in registers.
template <int HALF, int G, int C, int STRIDE>
__device__ __forceinline__ void transpose_level(float (&v)[G][C], int gi) {
  if constexpr (HALF >= 1) {
    const bool up = gi & HALF;
#pragma unroll
    for (int s = 0; s < HALF; ++s)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float send = up ? v[s][c] : v[s + HALF][c];
        const float keep = up ? v[s + HALF][c] : v[s][c];
        v[s][c] = keep + __shfl_xor_sync(FULL, send, HALF * STRIDE);
      }
    transpose_level<HALF / 2, G, C, STRIDE>(v, gi);
  }
}

// v[s][c] is this lane's part of value c of item s.  On return v[0][c] is the sum, over
// the G lanes of its group (lanes STRIDE apart; this lane is the group's gi-th), of
// value c of item gi: lane gi holds item gi's sums, after G - 1 shuffles a value
// (log2 G a value and item with a sum on every lane).
template <int G, int C, int STRIDE = 1>
__device__ __forceinline__ void group_transpose_sum(float (&v)[G][C], int gi) {
  static_assert(G >= 2 && G <= 16 && (G & (G - 1)) == 0, "a power of two lanes, at most 16");
  static_assert(G * STRIDE <= 32, "the group within a warp");
  transpose_level<G / 2, G, C, STRIDE>(v, gi);
}

}  // namespace
