// Mamba-1 selective scan for Hopper (sm_90a): forward (K4) and backward (K5).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/mamba_scan.py:
//   K4 fwd_kernel <- _fwd_kernel  (h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t,
//                                  y_t = h_t . C_t + D u_t; also emits the chunk-initial
//                                  states h_init)
//   K5 bwd_kernel <- _bwd_kernel  (reversed-chunk replay from h_init, then the adjoint
//                                  g_t = G_t + dy_t C_t, G_{t-1} = g_t exp(dt_t A); du, ddt
//                                  per element, dB/dC partials per channel block, dA/dD
//                                  partials per batch row)
//
// Semantics are the TPU kernels': u, dt, dy (B, S, di) and B_t, C_t (B, S, N) in bf16 or
// fp32, A (di, N) and D (di,) in fp32, all contiguous, N = 16.  State, sums and every
// gradient are fp32; y is written in u's type.  The ragged tail (S not a multiple of the
// chunk) is masked here: steps past S load dt = u = 0 (the identity step of
// kernels/blocking.py) and are not written; channels past di compute zeros.
//
// Segment restarts (packed rows): `rst`, when not null, holds (B, ceil(S / 32)) 32-bit
// words, bit t % 32 of word t / 32 of a row set where step t starts a segment.  Such a step
// drops the state it inherits: h_t = (dt_t u_t) B_t.  K4 applies it in the walk (a group of
// HS steps with no start runs the plain steps; the bits are uniform over a block, which is
// one batch row) and saves h_init before it, as it saves every chunk's pre-state; K5
// replays the same restart and stops the state's gradient there (the pre-state, and with it
// the decay's and A's share of the step, are zero).  No restart leaves both kernels as
// they were.
//
// K4 (fwd_kernel<T, N, VEC>).  What bounds it on the H100, at Jamba's shape (B 2, S 4096,
// di 8192, N 16, bf16): its own bytes (u and dt read, y written; B_t, C_t, A, D are small)
// are 0.404 GB, 0.1205 ms at 3.35 TB/s; with the fp32 chunk-initial states it writes for
// K5 (0.268 GB at chunk 16) 0.2006 ms.  The exponentials set the highest floor: one a state
// element and step, B S di N = 1.074 G on the SFUs (16 a clock an SM, 132 SMs, 1.98 GHz),
// about 0.257 ms; its ~6 fp32 operations an element and step are far under the FMA rate.
// Design.  The TPU grid's sequential chunk axis becomes a loop inside one block per (batch
// row, 128 channels).  Each channel's state is split over L = 2 lanes, 8 states a
// lane (256 threads; a warp covers 16 channels, lane l channel l / 2 of the warp, states
// 8 (l % 2) .. 8 (l % 2) + 7).
//   - Each step a lane does 8 decays ex2.approx((dt log2 e) a), dt scaled once a step, and
//     8 updates h = fmaf(h, decay, (dt u) b): K5's replay in the same operations, so K5
//     replays bitwise the states K4 computed.  The state does not depend on the chunk.
//   - y: each lane's partial h . C_t over its states (lane 0 of a channel adds D u) for
//     HS = 16 steps, then one transposing reduce over the channel's lanes (8 shuffles
//     for 16 steps) leaves each lane 8 steps' sums; they go through the warp's own y tile
//     in shared memory and out as 16-byte stores of whole rows of the warp's channels.
//   - Tiles copied in ahead of use: 64 steps (32 in fp32) of u and dt (in T) by 16-byte
//     cp.async pieces that report to the stage's `full` mbarrier, and of B_t and C_t
//     (each thread loads its share a tile early and stores it converted to fp32), into a
//     ring of NS = 3 stages, two tiles ahead; each warp releases a stage on its
//     `empty` mbarrier, so no block-wide barrier waits on device memory.  Where
//     di * sizeof(T) is not a multiple of 16 or a pointer is not 16-byte aligned, plain
//     loads fill the stage instead (VEC false).
//   - h_init: at the step a countdown names (no division in the step loop; retired at S,
//     so an identity step past S starts no chunk), each lane stores its states as 16-byte
//     pieces, a warp 1 KB contiguous.  Any chunk >= 1; with a chunk that is a multiple of
//     HS only a group's first step is checked (k4_steps<..., EACH = false>): checking every
//     step at Jamba's chunk 16 measured 0.524-0.529 ms against 0.474-0.479 (1016 loop
//     instructions for 16 steps against 893; tools/mamba_ab.py, H100 SXM at 700 W).
//   - No atomics: two runs give bitwise equal y and h_init.
// Measured (tools/mamba_ab.py, H100 SXM at 700 W): about 0.475 ms at Jamba's shape against
// 2.56 for the one-thread-a-channel kernel it replaced; 180 registers, no spill; the loop
// issues ~7 instructions an exponential, ~49 % of the cycles with 8 warps an SM.  Probes
// (a part removed): the exponentials cost 21 %, the h_init stores 10 %, the y shuffles
// 9 %, the cross-warp release of a stage 2 %, the shared-memory loads nothing measurable;
// none alone bounds it.  Timed and not kept: 4 lanes x 4 states (0.516 ms; 16 warps, but
// 25 % more instructions an exponential), 8 x 2 (0.65), sums of 4, 8 or 32 steps, 2 or 4
// stages, u/dt rings of each warp's own columns with B_t/C_t in a deeper ring, B_t/C_t
// kept in bf16 (its conversions cost more than the loads saved).

// K5.  One block per (batch row, 128 channels) walks the chunks from last to first;
// each channel's state is split over 4 lanes, 4 states a lane, so a block is 512
// threads (16 warps) and the grid at Jamba's shape holds 65,536 threads, one block on
// each of 128 SMs.  A warp covers 8 channels: lane l works on channel l / 4 of the
// warp, states 4 (l % 4) .. 4 (l % 4) + 3.
//   - The chunk's history lives in registers: the replay writes the pre-state of each
//     of the chunk's steps into hist[CH][4] (64 fp32 at CH = 16), and the adjoint
//     walks it back.  Register arrays need compile-time indices, so both loops are
//     unrolled over CH = 16 steps; a chunk of fewer steps (S < 16, the ragged tail)
//     fills the rest with identity steps that are not written.  CH bounds the chunk
//     K5 takes; shared memory no longer depends on it.
//   - Shared memory holds only the step tiles (u, dt, dy, B_t, C_t in their own type,
//     h_init in fp32), double-buffered: the next chunk's tiles come with cp.async
//     (16-byte pieces, zero-filled past S and di) while this one computes.  Where di
//     or a pointer does not allow 16-byte pieces, plain loads fill the buffer instead:
//     right for every input, but at Jamba's shape 3.68 ms against 1.87 (H100,
//     tools/mamba_ab.py), since the fill then stalls the block.
//     Besides the tiles, the warps' dB/dC sums: 42 KB + 32 KB a block in bf16, 68 +
//     32 KB in fp32.
//   - Two exponentials per state element and step, as before the redesign: the decay
//     ex2.approx.ftz((dt log2 e) a), dt scaled once a step, is computed in the replay
//     and again in the adjoint, 2 B S di N of them (2.15 G at Jamba's shape).  One
//     would need the replay's decays kept beside the history, 64 more registers, past
//     the 128 a thread of a 512-thread block may hold.  ex2.approx replaced the
//     accurate expf; fp32 results stay within 1e-4 max / 1e-5 norm of the plain
//     version's exp.
//   - Sums: dx = sum_n g B and sum_n gh A take 2 shuffles each within a channel's 4
//     lanes.  dB_t and dC_t sum over channels: each lane holds 8 values (4 of dB, 4 of
//     dC) and a reduce-scatter over the warp's 8 channels (4 + 2 + 1 shuffles, constant
//     indices) leaves lane l with value l / 4 of its quarter; the 16 warps' sums are
//     added in a fixed order at the end of the chunk and written as the channel
//     block's partial.  dA and dD accumulate in registers over the sequence and leave
//     as per-row partials.  No atomics: the gradients are the same from run to run.
//   - 128 registers a thread (the most a 512-thread block may hold), no spill.  A
//     split of 8 lanes x 2 states (1024 threads, 64 registers each) measured slower
//     on an H100: its lanes' sums cost more instructions than the extra warps hide.
// Bound on the H100: 0.94 GB at Jamba's shape (u, dt, dy in bf16 read once, du and
// ddt in fp32 written once), 0.281 ms at 3.35 TB/s.  The exponentials set a second
// floor: 2 B S di N = 2.15 G of them on 132 SMs x 16 SFU lanes a clock, about 0.55 ms.
// Its SASS issues ~168 instructions a lane and step (the replay 28 of them), a floor
// near 1.5 ms at Jamba's shape; it takes about 1.9 ms there (tools/mamba_ab.py), and
// 13 % fewer instructions (bf16 tiles converted once a chunk) bought 2 %: it is held
// back by stalls (4 warps a scheduler, MUFU and shuffle latencies) more than by issue.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "scan_common.cuh"

namespace {

constexpr int CB = 128;              // channels per block (K4: K4<T, N>::L lanes each; K5: 4)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// K5 geometry: 4 lanes a channel, 4 states a lane.
constexpr int K5_LANES = 4;
constexpr int K5_THREADS = CB * K5_LANES;   // 512
constexpr int K5_WARPS = K5_THREADS / 32;   // 16
constexpr int K5_CH = 16;                   // steps of history a thread holds: the largest chunk
constexpr float LOG2E = 1.4426950408889634f;

// 2^x with a denormal result flushed to 0; 2^(+-0) = 1.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four consecutive values of a shared-memory row (8- or 16-byte aligned) as fp32.
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  o[0] = lo.x; o[1] = lo.y; o[2] = hi.x; o[3] = hi.y;
}

// 16 bytes from global to shared memory, asynchronously; zeros where !ok (src is then
// not read, but stays a valid address).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// On return lane l holds the sum over the warp's 8 channels (lane bits 2-4) of
// v[l / 4] of the lanes of its quarter (l % 4); v is clobbered.
__device__ __forceinline__ float reduce_scatter8(float (&v)[8]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int level = 0; level < 3; ++level) {
    const int half = 4 >> level, bit = 16 >> level;
    const bool upper = lane & bit;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, bit);
    }
  }
  return v[0];
}

// One arrival on `bar` once every cp.async this thread has issued so far has landed.
__device__ __forceinline__ void cp_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_addr(bar))
               : "memory");
}

// E consecutive floats of memory, loaded or stored (16-byte pieces where E is a multiple
// of 4, else E = 2 (or 1, stored) aligned to 4 E bytes).
template <int E>
__device__ __forceinline__ void ld_f(const float* p, float (&o)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      o[4 * i] = f.x; o[4 * i + 1] = f.y; o[4 * i + 2] = f.z; o[4 * i + 3] = f.w;
    }
  } else {
    static_assert(E == 2, "2 or a multiple of 4 floats");
    const float2 f = *reinterpret_cast<const float2*>(p);
    o[0] = f.x; o[1] = f.y;
  }
}
template <int E>
__device__ __forceinline__ void st_f(float* p, const float (&x)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2],
                                                    x[4 * i + 3]);
  } else if constexpr (E == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    static_assert(E == 1, "1, 2 or a multiple of 4 floats");
    p[0] = x[0];
  }
}

// BYTES = 8 or 16 bytes copied as one access (both pointers aligned to BYTES).
template <int BYTES>
__device__ __forceinline__ void copy_raw(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
  } else {
    static_assert(BYTES == 8, "8 or 16 bytes");
    *static_cast<uint2*>(dst) = *static_cast<const uint2*>(src);
  }
}

// K4 geometry.  Thread (channel cl, lane q of it) of a block of CB channels: cl = tid / L,
// q = tid % L, states SPL q .. SPL q + SPL - 1.
template <typename T, int N>
struct K4 {
  static constexpr int L = 2;                            // lanes a channel
  static constexpr int SPL = N / L;                      // states a lane
  static constexpr int NT = CB * L;                      // threads
  static constexpr int NW = NT / 32;
  static constexpr int CPW = 32 / L;                     // channels a warp
  static constexpr int HS = 16;                          // steps whose y sums are taken together
  static constexpr int NS = 3;                           // tiles in the shared-memory ring
  static constexpr int TS = sizeof(T) == 2 ? 64 : 32;    // steps a tile
  static constexpr int EPT = 2 * TS * N / NT;            // B_t, C_t values a thread brings
  static constexpr int BCW = EPT * (int)sizeof(T) / 4;   // ... in 32-bit words
  // a stage: u, dt (TS, CB) in T, then B_t, C_t (TS, N) in fp32
  static constexpr size_t SEQ = sizeof(T) * TS * CB;
  static constexpr size_t STAGE = 2 * SEQ + sizeof(float) * 2 * TS * N;
  static constexpr size_t YT = sizeof(T) * TS * CB;      // the warps' y tiles, (TS, CPW) each
  // the ring, the y tiles, the mbarriers (full, empty a stage)
  static constexpr size_t BYTES = NS * STAGE + YT + 2 * NS * 8;
  static_assert(N % L == 0 && 32 % L == 0 && HS % L == 0 && TS % HS == 0, "geometry");
  static_assert(NS >= 2 && EPT <= N && (TS * N) % EPT == 0 && BCW >= 1 &&
                (BCW == 1 || BCW == 2 || BCW == 4), "stages, B/C shares of 4, 8 or 16 bytes");
  static_assert((TS * CB * sizeof(T) / 16) % NT == 0, "whole 16-byte pieces a thread");
  static_assert(STAGE % 16 == 0 && YT % 16 == 0 && BYTES <= 232448, "shared memory");
};

// Steps [0, steps) of u and dt from sequence row row0 (b S + t0) into a stage, zeros past
// steps and di.  VEC: 16-byte cp.async pieces and one arrival on `full` when they land;
// else plain loads and stores, then the arrival.
template <typename T, int N, bool VEC>
__device__ __forceinline__ void k4_fill_seq(unsigned char* stage, const T* u, const T* dt,
                                            size_t row0, int steps, int c0, int di,
                                            unsigned long long* full) {
  using G = K4<T, N>;
  T* dst[2] = {reinterpret_cast<T*>(stage), reinterpret_cast<T*>(stage + G::SEQ)};
  const T* src[2] = {u, dt};
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T), PPR = CB / E;        // elements a piece, pieces a row
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int r = 0; r < G::TS * PPR / G::NT; ++r) {
        const int i = r * G::NT + threadIdx.x, t = i / PPR, ce = i % PPR * E;
        const bool ok = t < steps && c0 + ce < di;
        cp16(dst[k] + t * CB + ce, ok ? src[k] + (row0 + t) * di + c0 + ce : src[k], ok);
      }
    cp_arrive(full);
  } else {
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll 1
      for (int i = threadIdx.x; i < G::TS * CB; i += G::NT) {
        const int t = i / CB, cc = c0 + i % CB;
        dst[k][i] = t < steps && cc < di ? src[k][(row0 + t) * di + cc] : from_f<T>(0.f);
      }
    mbar_arrive(full);
  }
}

// This thread's share of a tile's B_t and C_t: EPT values of one step row (zeros past
// steps), held as raw 32-bit words from a tile ahead until k4_store_bc converts them, so
// that nothing waits on the load before then.
template <typename T, int N, bool VEC>
__device__ __forceinline__ void k4_load_bc(unsigned (&w)[K4<T, N>::BCW], const T* Bm,
                                           const T* Cm, size_t row0, int steps) {
  using G = K4<T, N>;
  constexpr int BCW = G::BCW;
  const int f = threadIdx.x * G::EPT, off = f % (G::TS * N);
  const T* src = (f < G::TS * N ? Bm : Cm) + row0 * N + off;
  if (off / N >= steps) {
#pragma unroll
    for (int i = 0; i < BCW; ++i) w[i] = 0u;             // +0 in either type
  } else if constexpr (VEC && BCW == 4) {
    const uint4 r = *reinterpret_cast<const uint4*>(src);
    w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
  } else if constexpr (VEC && BCW == 2) {
    const uint2 r = *reinterpret_cast<const uint2*>(src);
    w[0] = r.x; w[1] = r.y;
  } else if constexpr (VEC || sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < BCW; ++i) w[i] = reinterpret_cast<const unsigned*>(src)[i];
  } else {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int i = 0; i < BCW; ++i) w[i] = p[2 * i] | (unsigned)p[2 * i + 1] << 16;
  }
}

// Value e of a share as fp32 (a bf16 is the high half of its fp32).
template <typename T>
__device__ __forceinline__ float share_f(const unsigned* w, int e) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(w[e]);
  else return __uint_as_float(e % 2 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16);
}

template <typename T, int N>
__device__ __forceinline__ void k4_store_bc(unsigned char* stage,
                                            const unsigned (&w)[K4<T, N>::BCW]) {
  using G = K4<T, N>;
  float x[G::EPT];
#pragma unroll
  for (int e = 0; e < G::EPT; ++e) x[e] = share_f<T>(w, e);
  st_f<G::EPT>(reinterpret_cast<float*>(stage + 2 * G::SEQ) + threadIdx.x * G::EPT, x);
}

// HS steps of K4 from tile row tb (global step tt): each step's state update and this
// lane's partial of y; then the HS steps' sums over the channel's L lanes, lane q taking
// steps q + L c into the warp's y tile.  The state is saved to `si` before the step
// `next_si` names (-1 once no chunk of the S steps is left); with EACH a chunk may start
// at any of the HS steps, else only at the first.  With RST, bit s of `starts` restarts
// the state at step tt + s (after the save: h_init is the step's pre-state).
template <typename T, int N, bool EACH, bool RST>
__device__ __forceinline__ void k4_steps(float (&h)[K4<T, N>::SPL],
                                         const float (&a)[K4<T, N>::SPL], float ddq,
                                         const unsigned char* stage, T* y_w, int tb, int tt,
                                         int S, int chunk, int& next_si, float*& si,
                                         size_t si_step, bool live, int cl, int clw, int q,
                                         unsigned starts) {
  using G = K4<T, N>;
  constexpr int L = G::L, SPL = G::SPL, HS = G::HS, TS = G::TS;
  const T* u_s = reinterpret_cast<const T*>(stage);
  const T* dt_s = u_s + TS * CB;
  const float* b_s = reinterpret_cast<const float*>(stage + 2 * G::SEQ) + SPL * q;
  const float* c_s = b_s + TS * N;
  float acc[L][HS / L];                  // item s % L, value s / L: step tb + s
#pragma unroll
  for (int s = 0; s < HS; ++s) {
    const int t = tb + s;
    if ((EACH || s == 0) && tt + s == next_si) {   // this chunk's initial state
      if (live) st_f<SPL>(si, h);
      si += si_step;
      next_si = next_si < S - chunk ? next_si + chunk : -1;
    }
    if constexpr (RST) {
      if ((starts >> s) & 1u) {
#pragma unroll
        for (int j = 0; j < SPL; ++j) h[j] = 0.f;
      }
    }
    const float ut = to_f(u_s[t * CB + cl]), dtt = to_f(dt_s[t * CB + cl]);
    const float dtl = dtt * LOG2E, x = dtt * ut;
    float bn[SPL], cn[SPL];
    ld_f<SPL>(b_s + t * N, bn);
    ld_f<SPL>(c_s + t * N, cn);
    float p = ddq * ut;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      h[j] = fmaf(h[j], ex2(dtl * a[j]), x * bn[j]);
      p = fmaf(h[j], cn[j], p);
    }
    acc[s % L][s / L] = p;
  }
  group_transpose_sum<L, HS / L>(acc, q);
#pragma unroll
  for (int c = 0; c < HS / L; ++c) y_w[(tb + q + L * c) * G::CPW + clw] = from_f<T>(acc[0][c]);
}

// Rows [0, steps) of a warp's y tile (TS, CPW) into y (row stride di) from its first
// channel on; di_w of the warp's channels are live.  VEC: pieces of up to 16 bytes.
template <typename T, int N, bool VEC>
__device__ __forceinline__ void k4_write_y(T* y_g, const T* y_w, int steps, int di_w, int di,
                                           int lane) {
  constexpr int CPW = K4<T, N>::CPW;
  if constexpr (VEC) {
    constexpr int RB = CPW * sizeof(T), W = RB < 16 ? RB : 16, PPR = RB / W;
    constexpr int EW = W / sizeof(T);    // elements a piece
#pragma unroll 1
    for (int i = lane; i < steps * PPR; i += 32) {
      const int t = i / PPR, e = i % PPR * EW;
      if (e < di_w) copy_raw<W>(y_g + (size_t)t * di + e, y_w + t * CPW + e);
    }
  } else {
#pragma unroll 1
    for (int i = lane; i < steps * CPW; i += 32) {
      const int t = i / CPW, e = i % CPW;
      if (e < di_w) y_g[(size_t)t * di + e] = y_w[i];
    }
  }
}

// K4.  Grid (channel blocks, B), K4<T, N>::NT threads: thread = (channel, lane of it).
// Each tile: issue the copies of the tile NS - 1 ahead (once every warp has released
// its stage), wait for this tile's stage, walk it HS steps at a time, release the stage,
// store the B_t/C_t share of the tile ahead, write the warp's y rows out.
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(K4<T, N>::NT, 1) fwd_kernel(
    const T* __restrict__ u, const T* __restrict__ dt, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ A, const float* __restrict__ D,
    T* __restrict__ y, float* __restrict__ h_init, const unsigned* __restrict__ rst, int S,
    int di, int chunk, int n_chunks) {
  using G = K4<T, N>;
  constexpr int L = G::L, SPL = G::SPL, TS = G::TS, NS = G::NS, CPW = G::CPW;
  extern __shared__ float4 smem4[];
  unsigned char* stages = reinterpret_cast<unsigned char*>(smem4);
  T* y_s = reinterpret_cast<T*>(stages + NS * G::STAGE);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(stages + NS * G::STAGE + G::YT);
  unsigned long long* empty = full + NS;

  const int b = blockIdx.y, c0 = blockIdx.x * CB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cl = threadIdx.x / L, q = threadIdx.x % L, clw = lane / L, c = c0 + cl;
  const bool live = c < di;
  float a[SPL], h[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    a[j] = live ? A[(size_t)c * N + SPL * q + j] : 0.f;
    h[j] = 0.f;
  }
  const float ddq = live && q == 0 ? D[c] : 0.f;      // lane 0 of a channel adds D u
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 2 * G::NT);     // each thread: its u/dt copies, its B/C share
      mbar_init(empty + s, G::NW);        // each warp, done with the stage
    }
  }
  __syncthreads();

  const size_t row = (size_t)b * S;
  const int n_tiles = (S + TS - 1) / TS;
  T* y_w = y_s + warp * TS * CPW;
  T* y_g = y + row * di + c0 + warp * CPW;
  const int di_w = di - (c0 + warp * CPW);
  float* si = h_init + ((size_t)b * n_chunks * di + c) * N + SPL * q;
  const size_t si_step = (size_t)di * N;
  int next_si = 0;                        // the step that starts the next chunk
  const bool each = chunk % G::HS != 0;
  const int rw = (S + 31) / 32;           // restart words a row
  const unsigned* rrow = rst == nullptr ? nullptr : rst + (size_t)b * rw;

  unsigned bc[G::BCW];
  for (int n = 0; n < NS - 1 && n < n_tiles; ++n) {
    unsigned char* stage = stages + n * G::STAGE;
    const int t0 = n * TS, steps = min(TS, S - t0);
    k4_fill_seq<T, N, VEC>(stage, u, dt, row + t0, steps, c0, di, full + n);
    k4_load_bc<T, N, VEC>(bc, Bm, Cm, row + t0, steps);
    k4_store_bc<T, N>(stage, bc);
    mbar_arrive(full + n);
  }
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % NS, nf = n + NS - 1, sf = nf % NS;
    const bool fetch = nf < n_tiles;
    unsigned char* fstage = stages + sf * G::STAGE;
    if (fetch) {
      if (n > 0) mbar_wait(empty + sf, ((n - 1) / NS) & 1);   // tile n - 1 is done
      const int f0 = nf * TS, fsteps = min(TS, S - f0);
      k4_fill_seq<T, N, VEC>(fstage, u, dt, row + f0, fsteps, c0, di, full + sf);
      k4_load_bc<T, N, VEC>(bc, Bm, Cm, row + f0, fsteps);
    }
    const int t0 = n * TS, steps = min(TS, S - t0);
    // the tile's restart bits (TS is 32 or 64 steps, t0 a multiple of 32)
    unsigned long long tbits = 0;
    if (rrow != nullptr) {
      tbits = rrow[t0 / 32];
      if (TS > 32 && t0 / 32 + 1 < rw) tbits |= (unsigned long long)rrow[t0 / 32 + 1] << 32;
    }
    const unsigned char* stage = stages + s * G::STAGE;
    mbar_wait(full + s, (n / NS) & 1);   // tile n is in stage s
    for (int tb = 0; tb < steps; tb += G::HS) {
      const unsigned starts = (unsigned)(tbits >> tb) & ((1u << G::HS) - 1);
      if (each) {
        if (starts)
          k4_steps<T, N, true, true>(h, a, ddq, stage, y_w, tb, t0 + tb, S, chunk, next_si,
                                     si, si_step, live, cl, clw, q, starts);
        else
          k4_steps<T, N, true, false>(h, a, ddq, stage, y_w, tb, t0 + tb, S, chunk, next_si,
                                      si, si_step, live, cl, clw, q, 0u);
      } else {
        if (starts)
          k4_steps<T, N, false, true>(h, a, ddq, stage, y_w, tb, t0 + tb, S, chunk, next_si,
                                      si, si_step, live, cl, clw, q, starts);
        else
          k4_steps<T, N, false, false>(h, a, ddq, stage, y_w, tb, t0 + tb, S, chunk,
                                       next_si, si, si_step, live, cl, clw, q, 0u);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);   // this warp is done with stage s
    if (fetch) {
      k4_store_bc<T, N>(fstage, bc);
      mbar_arrive(full + sf);
    }
    k4_write_y<T, N, VEC>(y_g + (size_t)t0 * di, y_w, steps, di_w, di, lane);
    __syncwarp();                            // the y tile is read before the next tile's y
  }
}

// K5's shared-memory buffer for one chunk: h_init (CB, N) fp32, then u, dt, dy
// (K5_CH, CB) and B_t, C_t (K5_CH, N) in the sequence type.  Two buffers, then the
// warps' dB/dC sums (K5_CH, K5_WARPS, 32) fp32.
template <typename T, int N>
__host__ __device__ constexpr size_t k5_buf_bytes() {
  return sizeof(float) * CB * N + sizeof(T) * (3 * K5_CH * CB + 2 * K5_CH * N);
}
template <typename T, int N>
__host__ __device__ constexpr size_t k5_smem_bytes() {
  return 2 * k5_buf_bytes<T, N>() + sizeof(float) * K5_CH * K5_WARPS * 32;
}

// Fill a K5 buffer with chunk ic of this block's (batch row, channel block): steps
// [t0, t0 + steps) of u, dt, dy, B_t, C_t and the channels' h_init; zeros past steps
// and di.  VEC: 16-byte cp.async pieces (di * sizeof(T) a multiple of 16, pointers
// 16-byte aligned), committed as one group; else plain loads and stores.
template <typename T, int N, bool VEC>
__device__ __forceinline__ void k5_fill(unsigned char* buf, const T* u, const T* dt,
                                        const T* dy, const T* Bm, const T* Cm,
                                        const float* h_init, int b, int ic, int S, int di,
                                        int c0, int chunk, int n_chunks) {
  float* h_s = reinterpret_cast<float*>(buf);
  T* seq_s = reinterpret_cast<T*>(buf + sizeof(float) * CB * N);   // u, dt, dy, B_t, C_t
  const int t0 = ic * chunk, steps = min(chunk, S - t0);
  const size_t row = (size_t)b * S + t0;
  const T* seq[5] = {u + row * di, dt + row * di, dy + row * di, Bm + row * N, Cm + row * N};
  const float* hi = h_init + (((size_t)b * n_chunks + ic) * di + c0) * N;
  if constexpr (VEC) {
    // each thread issues at most one piece of each tile
    constexpr int E = 16 / sizeof(T);                 // elements a piece
    static_assert(K5_CH * CB / E <= K5_THREADS && CB * N / 4 == K5_THREADS, "one pass");
    const int i = threadIdx.x;
#pragma unroll
    for (int s = 0; s < 3; ++s)
      if (i < K5_CH * CB / E) {
        const int t = i / (CB / E), ce = i % (CB / E) * E;
        const bool ok = t < steps && c0 + ce < di;
        cp16(seq_s + s * K5_CH * CB + i * E, ok ? seq[s] + (size_t)t * di + c0 + ce : seq[s],
             ok);
      }
#pragma unroll
    for (int s = 3; s < 5; ++s)
      if (i < K5_CH * N / E) {
        const bool ok = i * E / N < steps;
        cp16(seq_s + 3 * K5_CH * CB + (s - 3) * K5_CH * N + i * E,
             ok ? seq[s] + i * E : seq[s], ok);
      }
    const bool ok = c0 + i * 4 / N < di;
    cp16(h_s + i * 4, ok ? hi + i * 4 : h_init, ok);
    cp_commit();
  } else {
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll 1
      for (int i = threadIdx.x; i < K5_CH * CB; i += K5_THREADS) {
        const int t = i / CB, c = c0 + i % CB;
        seq_s[s * K5_CH * CB + i] =
            t < steps && c < di ? seq[s][(size_t)t * di + c] : from_f<T>(0.f);
      }
#pragma unroll
    for (int s = 3; s < 5; ++s)
#pragma unroll 1
      for (int i = threadIdx.x; i < K5_CH * N; i += K5_THREADS)
        seq_s[3 * K5_CH * CB + (s - 3) * K5_CH * N + i] =
            i / N < steps ? seq[s][i] : from_f<T>(0.f);
#pragma unroll 1
    for (int i = threadIdx.x; i < CB * N; i += K5_THREADS)
      h_s[i] = c0 + i / N < di ? hi[i] : 0.f;
  }
}

// The restart bits of steps [t0, t0 + steps) of a row's words (steps <= 16), bit t for
// step t0 + t.
__device__ __forceinline__ unsigned chunk_starts(const unsigned* rrow, int rw, int t0,
                                                 int steps) {
  const int w = t0 / 32, off = t0 % 32;
  unsigned long long bits = rrow[w];
  if (w + 1 < rw) bits |= (unsigned long long)rrow[w + 1] << 32;
  return (unsigned)(bits >> off) & ((1u << steps) - 1);
}

// K5.  Grid (channel blocks, B), K5_THREADS threads: thread = (channel, quarter).  RST:
// `rst` holds restart bits (a launch without them runs the code without the selects).
template <typename T, int N, bool VEC, bool RST>
__global__ void __launch_bounds__(K5_THREADS, 1) bwd_kernel(
    const T* __restrict__ u, const T* __restrict__ dt, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ A, const float* __restrict__ D,
    const float* __restrict__ h_init, const T* __restrict__ dy, float* __restrict__ du,
    float* __restrict__ ddt, float* __restrict__ dB_p, float* __restrict__ dC_p,
    float* __restrict__ dA_p, float* __restrict__ dD_p, const unsigned* __restrict__ rst,
    int Bsz, int S, int di, int chunk, int n_chunks) {
  static_assert(N == 4 * K5_LANES, "a lane holds 4 of the channel's N = 16 states");
  constexpr size_t BUF = k5_buf_bytes<T, N>();
  extern __shared__ float smem[];
  unsigned char* bufs = reinterpret_cast<unsigned char*>(smem);
  float* red = reinterpret_cast<float*>(bufs + 2 * BUF);   // (K5_CH, K5_WARPS, 32)

  const int b = blockIdx.y, cblk = blockIdx.x, c0 = cblk * CB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cl = threadIdx.x / K5_LANES, n0 = 4 * (threadIdx.x % K5_LANES);
  const int c = c0 + cl;
  const bool live = c < di;
  float a[4], g[4], da[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j] = live ? A[(size_t)c * N + n0 + j] : 0.f;
    g[j] = 0.f;
    da[j] = 0.f;
  }
  const float dd = live ? D[c] : 0.f;
  float dd_acc = 0.f;

  k5_fill<T, N, VEC>(bufs, u, dt, dy, Bm, Cm, h_init, b, n_chunks - 1, S, di, c0, chunk,
                     n_chunks);
  for (int ic = n_chunks - 1, it = 0; ic >= 0; --ic, ++it) {
    unsigned char* cur = bufs + (it & 1) * BUF;
    if constexpr (VEC) cp_wait_all();
    __syncthreads();   // this chunk's tiles are in; the other buffer and red are free
    if (ic > 0)
      k5_fill<T, N, VEC>(bufs + ((it + 1) & 1) * BUF, u, dt, dy, Bm, Cm, h_init, b, ic - 1,
                         S, di, c0, chunk, n_chunks);
    const int t0 = ic * chunk, steps = min(chunk, S - t0);
    // steps that restart the state (uniform over the block)
    const unsigned starts = RST ? chunk_starts(rst + (size_t)b * ((S + 31) / 32),
                                               (S + 31) / 32, t0, steps) : 0u;
    // quarter 0 writes the channel's ddt, quarter 1 its du, from this chunk's first row
    float* const drow = (n0 == 0 ? ddt : du) + ((size_t)b * S + t0) * di + c;
    const float* h_s = reinterpret_cast<const float*>(cur);
    const T* u_s = reinterpret_cast<const T*>(cur + sizeof(float) * CB * N);
    const T* dt_s = u_s + K5_CH * CB;
    const T* dy_s = dt_s + K5_CH * CB;
    const T* b_s = dy_s + K5_CH * CB;
    const T* c_s = b_s + K5_CH * N;

    // replay: hist[t] = the pre-state of step t0 + t (zero where the step restarts)
    float h[4], hist[K5_CH][4];
    load4(h_s + cl * N + n0, h);
#pragma unroll
    for (int t = 0; t < K5_CH; ++t) {
      const float dtt = to_f(dt_s[t * CB + cl]), dtl = dtt * LOG2E;
      const float x = dtt * to_f(u_s[t * CB + cl]);
      const bool cut = RST && ((starts >> t) & 1u);
      float bn[4];
      load4(b_s + t * N + n0, bn);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hist[t][j] = cut ? 0.f : h[j];
        h[j] = fmaf(hist[t][j], ex2(dtl * a[j]), x * bn[j]);
      }
    }
    // adjoint, steps in reverse
#pragma unroll
    for (int t = K5_CH - 1; t >= 0; --t) {
      const float ut = to_f(u_s[t * CB + cl]), dtt = to_f(dt_s[t * CB + cl]);
      const float dyt = to_f(dy_s[t * CB + cl]);
      const float x = dtt * ut, dtl = dtt * LOG2E;
      const bool cut = RST && ((starts >> t) & 1u);   // no gradient to the pre-state
      float bn[4], cn[4], v[8];
      load4(b_s + t * N + n0, bn);
      load4(c_s + t * N + n0, cn);
      float dx = 0.f, gha = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dec = ex2(dtl * a[j]);
        const float hd = hist[t][j] * dec;               // h_{t-1} exp(dt a)
        const float gt = fmaf(dyt, cn[j], g[j]);         // dL/dh_t
        v[j] = gt * x;                                   // dB_t, this channel
        v[4 + j] = dyt * fmaf(x, bn[j], hd);             // dC_t = dy_t h_t, this channel
        const float gh = gt * hd;
        dx = fmaf(gt, bn[j], dx);
        gha = fmaf(gh, a[j], gha);
        da[j] = fmaf(gh, dtt, da[j]);
        g[j] = cut ? 0.f : gt * dec;
      }
      dx += __shfl_xor_sync(FULL, dx, 1);
      gha += __shfl_xor_sync(FULL, gha, 1);
      dx += __shfl_xor_sync(FULL, dx, 2);
      gha += __shfl_xor_sync(FULL, gha, 2);
      if (live && n0 < 8 && t < steps)
        drow[(size_t)t * di] = n0 == 0 ? fmaf(dx, ut, gha) : fmaf(dx, dtt, dd * dyt);
      dd_acc = fmaf(dyt, ut, dd_acc);
      red[(t * K5_WARPS + warp) * 32 + lane] = reduce_scatter8(v);
    }
    __syncthreads();
    // lane l of every warp holds value l / 4 (dB for l / 4 < 4, else dC) of state
    // 4 (l % 4) + l / 4 % 4, summed over the warp's channels; add the warps in order
    for (int i = threadIdx.x; i < steps * 32; i += K5_THREADS) {
      const int t = i / 32, l = i % 32;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < K5_WARPS; ++w) s += red[(t * K5_WARPS + w) * 32 + l];
      float* out = l / 4 < 4 ? dB_p : dC_p;
      out[(((size_t)cblk * Bsz + b) * S + t0 + t) * N + 4 * (l % 4) + l / 4 % 4] = s;
    }
  }
  if (live) {
    *reinterpret_cast<float4*>(dA_p + ((size_t)b * di + c) * N + n0) =
        make_float4(da[0], da[1], da[2], da[3]);
    if (n0 == 0) dD_p[(size_t)b * di + c] = dd_acc;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int N, bool VEC>
cudaError_t launch_fwd_as(const void* u, const void* dt, const void* Bm, const void* Cm,
                          const void* A, const void* D, void* y, void* h_init, const void* rst,
                          int Bsz, int S, int di, int chunk, cudaStream_t stream) {
  constexpr size_t smem = K4<T, N>::BYTES;
  cudaError_t e = allow_smem(fwd_kernel<T, N, VEC>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((di + CB - 1) / CB, Bsz);
  fwd_kernel<T, N, VEC><<<grid, K4<T, N>::NT, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(h_init), static_cast<const unsigned*>(rst), S, di,
      chunk, (S + chunk - 1) / chunk);
  return cudaGetLastError();
}

// K4 takes any chunk >= 1 (cudaErrorInvalidValue otherwise); its 16-byte copies and stores
// need di * sizeof(T) a multiple of 16 and 16-byte aligned pointers.  `rst` may be null.
template <typename T, int N>
cudaError_t launch_fwd(const void* u, const void* dt, const void* Bm, const void* Cm,
                       const void* A, const void* D, void* y, void* h_init, const void* rst,
                       int Bsz, int S, int di, int chunk, cudaStream_t stream) {
  if (chunk < 1) return cudaErrorInvalidValue;
  const bool vec = (di * sizeof(T)) % 16 == 0 &&
                   (((size_t)u | (size_t)dt | (size_t)Bm | (size_t)Cm | (size_t)y) % 16) == 0;
  return (vec ? launch_fwd_as<T, N, true> : launch_fwd_as<T, N, false>)(
      u, dt, Bm, Cm, A, D, y, h_init, rst, Bsz, S, di, chunk, stream);
}

template <typename T, int N, bool VEC, bool RST>
cudaError_t launch_bwd_as(const void* u, const void* dt, const void* Bm, const void* Cm,
                          const void* A, const void* D, const void* h_init, const void* dy,
                          void* du, void* ddt, void* dB_p, void* dC_p, void* dA_p,
                          void* dD_p, const void* rst, int Bsz, int S, int di, int chunk,
                          cudaStream_t stream) {
  constexpr size_t smem = k5_smem_bytes<T, N>();
  cudaError_t e = allow_smem(bwd_kernel<T, N, VEC, RST>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((di + CB - 1) / CB, Bsz);
  bwd_kernel<T, N, VEC, RST><<<grid, K5_THREADS, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(h_init), static_cast<const T*>(dy), static_cast<float*>(du),
      static_cast<float*>(ddt), static_cast<float*>(dB_p), static_cast<float*>(dC_p),
      static_cast<float*>(dA_p), static_cast<float*>(dD_p), static_cast<const unsigned*>(rst),
      Bsz, S, di, chunk, (S + chunk - 1) / chunk);
  return cudaGetLastError();
}

// K5 takes a chunk of 1..K5_CH steps (cudaErrorInvalidValue otherwise); its 16-byte
// copies need di * sizeof(T) a multiple of 16 and 16-byte aligned pointers.  `rst` may be
// null (the kernel without restarts).
template <typename T, int N>
cudaError_t launch_bwd(const void* u, const void* dt, const void* Bm, const void* Cm,
                       const void* A, const void* D, const void* h_init, const void* dy,
                       void* du, void* ddt, void* dB_p, void* dC_p, void* dA_p, void* dD_p,
                       const void* rst, int Bsz, int S, int di, int chunk,
                       cudaStream_t stream) {
  if (chunk < 1 || chunk > K5_CH) return cudaErrorInvalidValue;
  const bool vec = (di * sizeof(T)) % 16 == 0 &&
                   (((size_t)u | (size_t)dt | (size_t)dy | (size_t)Bm | (size_t)Cm |
                     (size_t)h_init) % 16) == 0;
  const auto launch = rst != nullptr
      ? (vec ? launch_bwd_as<T, N, true, true> : launch_bwd_as<T, N, false, true>)
      : (vec ? launch_bwd_as<T, N, true, false> : launch_bwd_as<T, N, false, false>);
  return launch(u, dt, Bm, Cm, A, D, h_init, dy, du, ddt, dB_p, dC_p, dA_p, dD_p, rst, Bsz, S,
                di, chunk, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers, `stream` is a
// cudaStream_t; `bf16` selects bf16 (1) or fp32 (0) u/dt/B_t/C_t/y/dy; N is 16; `rst`, the
// segment restart bits (B, ceil(S / 32)) of 32-bit words, or null for none.
// Each function returns the cudaError_t of its launch (0 on success).
#define MAMBA_DISPATCH(CALL)                                                \
  if (bf16) return (int)CALL(__nv_bfloat16, 16);                            \
  return (int)CALL(float, 16);

extern "C" {

int mamba_fwd(const void* u, const void* dt, const void* Bm, const void* Cm, const void* A,
              const void* D, void* y, void* h_init, const void* rst, int B, int S, int di,
              int chunk, int bf16, void* stream) {
#define CALL(T, NN) \
  launch_fwd<T, NN>(u, dt, Bm, Cm, A, D, y, h_init, rst, B, S, di, chunk, \
                    static_cast<cudaStream_t>(stream))
  MAMBA_DISPATCH(CALL)
#undef CALL
}

int mamba_bwd(const void* u, const void* dt, const void* Bm, const void* Cm, const void* A,
              const void* D, const void* h_init, const void* dy, void* du, void* ddt,
              void* dB_p, void* dC_p, void* dA_p, void* dD_p, const void* rst, int B, int S,
              int di, int chunk, int bf16, void* stream) {
#define CALL(T, NN)                                                                         \
  launch_bwd<T, NN>(u, dt, Bm, Cm, A, D, h_init, dy, du, ddt, dB_p, dC_p, dA_p, dD_p, rst, \
                    B, S, di, chunk, static_cast<cudaStream_t>(stream))
  MAMBA_DISPATCH(CALL)
#undef CALL
}

}  // extern "C"
