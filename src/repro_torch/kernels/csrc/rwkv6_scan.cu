// RWKV-6 WKV recurrence for Hopper (sm_90a): forward (K6) and backward (K7).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/rwkv6_scan.py:
//   K6 fwd_kernel <- _fwd_kernel  (S_t = diag(w_t) S_{t-1} + k_t v_t^T,
//                                  y_t = r_t (S_{t-1} + diag(u) k_t v_t^T); emits y, the
//                                  final state and the chunk-initial states)
//   K7 wkv6_bwd_kernel <- _bwd_kernel  (reversed-chunk replay from the chunk-initial
//                                  states, then G_{t-1} = diag(w_t) G_t + r_t dy_t^T seeded
//                                  with the final state's cotangent; dr, dk, dv, dw, and du
//                                  per (b, h))
//
// Semantics are the TPU kernels': r, k, v, dy (B, H, S, M) in bf16 or fp32, w (B, H, S, M)
// and u (H, M) in fp32, all contiguous; state S[i][j] indexed [key dim i, value dim j].
// State, sums and every gradient are fp32; y is written in r's type.  The ragged tail
// (S not a multiple of the chunk) is masked here: steps past S load the identity values
// of kernels/blocking.py (w = 1, r = k = v = 0), so the state passes through them.
//
// Design.  The TPU grid's sequential chunk axis becomes a loop inside one block per
// (b, h).  Both the state and its adjoint have rows that evolve independently
// (row i is scaled by w_t[i] and gets k_t[i] v_t or r_t[i] dy_t added) and columns that
// evolve independently, which decides the thread layout:
//   K6: 4 threads per value column j, each holding 16 (M = 64) of its rows in registers;
//       y_t[j] is a 4-lane shuffle sum.  r, k, v, w come through shared memory 64 steps
//       at a time, and the state is saved to the chunk-initial states every `chunk` steps.
//   K7 (wkv6_bwd_kernel): one block per (b, h) walks the chunks from last to first with
//       the adjoint held twice.  The row group (4 M threads) holds G by rows, 2 rows x
//       M/8 columns a thread, so dw, dk, dr and du of a row are sums over 8 neighbouring
//       lanes; the column group (2 M threads) holds G by columns, 4 rows x M/8 columns a
//       thread, so dv is a sum over M/4 neighbouring lanes.  No atomics: every output
//       element has one writer, every sum a fixed order, and du leaves as a per-(b, h)
//       partial summed outside, as the TPU does.
//       - Replay history in registers: a row thread replays the chunk's states from its
//         initial state 4 steps at a time (hist[4][M/4], compile-time indices), so the
//         adjoint reads them without shared memory or a barrier.  A chunk is at most
//         K7_CH = 16 steps: the walk's first sub-chunk replays steps 0-11 from s_init and
//         keeps the states at 4 and 8 (a thread's own, in shared memory); each other
//         sub-chunk starts from one of them, 1.5 replays a step in all.  A shorter chunk
//         (the ragged tail, S < 16) is padded with identity steps that are not written.
//       - Copies ahead: the next chunk's s_init and rows of w, r, k, v, dy come in while
//         this one is worked on, by six TMA bulk copies that one thread issues onto an
//         mbarrier per stage (two stages); inputs that are not 16-byte aligned take plain
//         loads instead.  Each chunk's rows are then converted once into fp32 tiles, one
//         warp a step, with the step's r.u.k and v.dy.
//       - Per-step shared-memory traffic: a 16-byte load serves 2 (row group) or 4
//         (column group) state elements; the 4 steps of a sub-chunk are summed at once, a
//         transposing reduce that leaves each lane one step's sums (lane i writes step
//         i / 2 of a row, or one step's columns) in G - 1 shuffles a value.
//       - The role branch is warp-uniform to the compiler (read through a lane-0
//         shuffle), so the shuffles inside it need no code for a diverged warp.
// Bound on the H100.  Per step and (b, h) the forward does ~3 M^2 fp32 operations on
// O(M) bytes of input, far above the ridge point, so it is bound by operations, on the
// CUDA cores (67 TFLOP/s fp32: the recurrence has no matrix product for the tensor
// cores in this form).  With one block per (b, h) the grid is B*H blocks (128 at
// RWKV6-7B's B = 2, H = 64), one per SM, so this first version uses a fraction of the
// card's warp schedulers; the chunked (matrix) form of the recurrence on the tensor cores
// is the next step.
// K7's bound: 11 fp32 operations per state element and step (bench.rwkv6_bwd_ops), 0.35 ms
// at RWKV6-7B's shape.  It issues ~16 instructions per element and step (the replay 1.5
// times over, G updated in both groups, the transposing sums) from 12 warps an SM, the 8
// row warps on the critical path, and takes ~1.6 ms there (tools/rwkv6_ab.py): what is
// left of the gap is issue and latency in the row warps, not memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int Q = 4;                 // threads per state row / column
constexpr int TS = 64;               // K6: steps per shared-memory tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum over the Q = 4 neighbouring lanes that share a row or column.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  x += __shfl_xor_sync(FULL, x, 2);
  return x;
}

// Steps [t0, t0 + chunk) of a (S, M) sequence into a (chunk, M) fp32 tile; steps past
// S hold `pad`.
template <typename T>
__device__ __forceinline__ void load_steps(float* dst, const T* src, int t0, int chunk,
                                           int S, int M, float pad) {
  for (int idx = threadIdx.x; idx < chunk * M; idx += blockDim.x) {
    const int t = t0 + idx / M;
    dst[idx] = t < S ? to_f(src[(size_t)t * M + idx % M]) : pad;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x += __shfl_xor_sync(FULL, x, m);
  return x;
}

// K7's copies: TMA bulk copies from global to shared memory that report to an mbarrier
// in shared memory (one arrival, by the thread that issues them, with the bytes to expect).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
               "%2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
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

// ruk[t] = sum_i r_t[i] u[i] k_t[i] (and, with v/dy, vdy[t] = sum_j v_t[j] dy_t[j]) for
// the first n steps of the tiles, one warp per step.
__device__ __forceinline__ void step_dots(float* ruk, float* vdy, const float* r_s,
                                          const float* k_s, const float* u_s,
                                          const float* v_s, const float* dy_s, int n, int M) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  for (int t = warp; t < n; t += n_warps) {
    float a = 0.f, b = 0.f;
    for (int i = lane; i < M; i += 32) {
      a = fmaf(r_s[t * M + i] * u_s[i], k_s[t * M + i], a);
      if (vdy) b = fmaf(v_s[t * M + i], dy_s[t * M + i], b);
    }
    a = warp_sum(a);
    if (vdy) b = warp_sum(b);
    if (lane == 0) {
      ruk[t] = a;
      if (vdy) vdy[t] = b;
    }
  }
}

// K6.  One block per (b, h), 4*M threads: thread (j, q) owns S[q + 4e][j], e < M/4.
// The steps come through shared memory TS at a time; the state is saved before every
// step that starts a chunk.
template <typename T, int M>
__global__ void __launch_bounds__(Q * M) fwd_kernel(const T* __restrict__ r,
                                                    const T* __restrict__ k,
                                                    const T* __restrict__ v,
                                                    const float* __restrict__ w,
                                                    const float* __restrict__ u,
                                                    T* __restrict__ y, float* __restrict__ s_final,
                                                    float* __restrict__ s_init, int H, int S,
                                                    int chunk, int n_chunks) {
  constexpr int E = M / Q;
  extern __shared__ float smem[];
  float* r_s = smem;                     // (TS, M) each
  float* k_s = r_s + TS * M;
  float* v_s = k_s + TS * M;
  float* w_s = v_s + TS * M;
  float* ruk = w_s + TS * M;             // (TS)
  float* u_s = ruk + TS;                 // (M)

  const int bh = blockIdx.x, h = bh % H;
  const int j = threadIdx.x / Q, q = threadIdx.x % Q;
  const size_t seq = (size_t)bh * S * M;
  if (threadIdx.x < M) u_s[threadIdx.x] = u[h * M + threadIdx.x];

  float st[E];
#pragma unroll
  for (int e = 0; e < E; ++e) st[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += TS) {
    const int steps = min(TS, S - t0);
    __syncthreads();                     // the previous tiles are consumed
    load_steps(r_s, r + seq, t0, steps, S, M, 0.f);
    load_steps(k_s, k + seq, t0, steps, S, M, 0.f);
    load_steps(v_s, v + seq, t0, steps, S, M, 0.f);
    load_steps(w_s, w + seq, t0, steps, S, M, 1.f);
    __syncthreads();
    step_dots(ruk, nullptr, r_s, k_s, u_s, nullptr, nullptr, steps, M);
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const int tt = t0 + t;
      if (tt % chunk == 0) {             // this chunk's initial state
        float* si = s_init + ((size_t)bh * n_chunks + tt / chunk) * M * M;
#pragma unroll
        for (int e = 0; e < E; ++e) si[(q + Q * e) * M + j] = st[e];
      }
      const float vj = v_s[t * M + j];
      const float* rt = r_s + t * M;
      const float* kt = k_s + t * M;
      const float* wt = w_s + t * M;
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc = fmaf(rt[q + Q * e], st[e], acc);
      acc = quad_sum(acc);
      if (q == 0) y[seq + (size_t)tt * M + j] = from_f<T>(fmaf(vj, ruk[t], acc));
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = q + Q * e;
        st[e] = fmaf(wt[i], st[e], kt[i] * vj);
      }
    }
  }
  float* sf = s_final + (size_t)bh * M * M;
#pragma unroll
  for (int e = 0; e < E; ++e) sf[(q + Q * e) * M + j] = st[e];
}

// K7 geometry.  A block of k7_threads<M>() threads (384 at M = 64) holds the (b, h) pair's
// adjoint twice:
//   row group, threads [0, QM): thread (p, c) = (lt / 8, lt % 8) owns rows 2p, 2p + 1 and
//     columns 4 (c + 8 e4) + x (e4 < M/32, x < 4), M/4 elements, and replays the state
//     there;
//   column group, the other M K7_CDIV / 4 threads: thread (cs, ri) = (lt / (M/4),
//     lt % (M/4)) owns rows 4 ri + x (x < 4) and columns CC cs + y (y < CC = M/8).
// The lanes that share rows (8) or columns (M/4) are neighbours in a warp, so their sums
// stay in the warp.  Each value a 16-byte shared-memory load brings in serves 2 (row
// group) or 4 to 8 (column group) state elements.  With 384 threads a thread may hold
// 168 registers; 512 threads (4 x 4 elements a column thread) took the same time on an
// H100 and spilled.
constexpr int K7_HC = Q;             // steps of replay history a row thread holds in registers
constexpr int K7_CH = 16;            // the longest chunk K7 takes
constexpr int K7_CDIV = 8;           // a column thread owns M / K7_CDIV columns of 4 rows

// Threads of K7's block: Q M in the row group, M K7_CDIV / 4 in the column group.
template <int M>
__host__ __device__ constexpr int k7_threads() { return Q * M + M * K7_CDIV / 4; }

template <typename T, int M>
struct K7Smem {
  static constexpr int NSUB = K7_CH / K7_HC;              // history sub-chunks a chunk
  static constexpr int NCKPT = NSUB > 2 ? NSUB - 2 : 0;   // states kept between them
  // one chunk as copied: s_init (M, M) and w (K7_CH, M) in fp32, r, k, v, dy (K7_CH, M) in T
  static constexpr size_t STAGE =
      sizeof(float) * (M * M + K7_CH * M) + sizeof(T) * 4 * K7_CH * M;
  static constexpr size_t CKPT = sizeof(float) * NCKPT * Q * M * (M / Q);
  // the chunk in fp32: r, k, v, w, dy (K7_CH, M); ruk, vdy (K7_CH); u (M)
  static constexpr size_t TILES = sizeof(float) * (5 * K7_CH * M + 2 * K7_CH + M);
  static constexpr size_t BYTES = 2 * STAGE + CKPT + TILES + 2 * sizeof(unsigned long long);
  static_assert(STAGE % 16 == 0 && CKPT % 16 == 0 && TILES % 8 == 0, "aligned regions");
  static_assert(K7_CH % K7_HC == 0, "whole sub-chunks");
};

// Copy a chunk of this (b, h) into a stage: its initial state `si` and rows [0, steps) of
// w, r, k, v, dy from element `off` on; rows past `steps` are not touched (k7_convert pads
// them), so no copy reads past S.  VEC: six TMA bulk copies, issued by thread 0, that
// complete the current phase of `bar` (every pointer 16-byte aligned; M * sizeof(T) is a
// multiple of 16); else plain loads and stores by every thread.
template <typename T, int M, bool VEC>
__device__ __forceinline__ void k7_fill(unsigned char* stage, const T* r, const T* k,
                                        const T* v, const T* dy, const float* w,
                                        const float* si, size_t off, int steps,
                                        unsigned long long* bar) {
  constexpr int NT = k7_threads<M>();
  float* si_s = reinterpret_cast<float*>(stage);
  float* w_s = si_s + M * M;
  T* seq_s = reinterpret_cast<T*>(w_s + K7_CH * M);
  const T* src[4] = {r + off, k + off, v + off, dy + off};
  if constexpr (VEC) {
    if (threadIdx.x == 0) {
      const unsigned seq_bytes = sizeof(T) * steps * M, w_bytes = sizeof(float) * steps * M;
      mbar_expect(bar, sizeof(float) * M * M + w_bytes + 4 * seq_bytes);
      bulk_copy(si_s, si, sizeof(float) * M * M, bar);
      bulk_copy(w_s, w + off, w_bytes, bar);
#pragma unroll
      for (int s = 0; s < 4; ++s) bulk_copy(seq_s + s * K7_CH * M, src[s], seq_bytes, bar);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < M * M; i += NT) si_s[i] = si[i];
#pragma unroll 1
    for (int i = threadIdx.x; i < steps * M; i += NT) {
      w_s[i] = w[off + i];
#pragma unroll
      for (int s = 0; s < 4; ++s) seq_s[s * K7_CH * M + i] = src[s][i];
    }
  }
}

// A stage's rows into the fp32 tiles, one warp a step; rows past `steps` get the identity
// step (w = 1, r = k = v = dy = 0).  Also ruk[t] = sum_i r_t[i] u[i] k_t[i] and
// vdy[t] = sum_j v_t[j] dy_t[j].
template <typename T, int M>
__device__ __forceinline__ void k7_convert(const unsigned char* stage, float* tiles,
                                           float* ruk, float* vdy, const float* u_s,
                                           int steps) {
  constexpr int NW = k7_threads<M>() / 32;
  const float* w_raw = reinterpret_cast<const float*>(stage) + M * M;
  const T* raw = reinterpret_cast<const T*>(w_raw + K7_CH * M);   // r, k, v, dy
  const int warp = __shfl_sync(FULL, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  for (int t = warp; t < K7_CH; t += NW) {
    const bool live = t < steps;
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int m = 0; m < M / 32; ++m) {
      const int i = lane + 32 * m, idx = t * M + i;
      float x[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) x[s] = live ? to_f(raw[s * K7_CH * M + idx]) : 0.f;
      tiles[idx] = x[0];                                       // r
      tiles[K7_CH * M + idx] = x[1];                           // k
      tiles[2 * K7_CH * M + idx] = x[2];                       // v
      tiles[3 * K7_CH * M + idx] = live ? w_raw[idx] : 1.f;    // w
      tiles[4 * K7_CH * M + idx] = x[3];                       // dy
      a = fmaf(x[0] * u_s[i], x[1], a);
      b = fmaf(x[2], x[3], b);
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      ruk[t] = a;
      vdy[t] = b;
    }
  }
}

// One level of group_transpose_sum: lanes gi and gi ^ HALF exchange halves of their first
// 2 HALF items, each keeping the half its bit HALF selects, then the next level.  HALF is a
// template argument so that every loop has a constant trip count and v stays in registers.
template <int HALF, int G, int C>
__device__ __forceinline__ void transpose_level(float (&v)[G][C], int gi) {
  if constexpr (HALF >= 1) {
    const bool up = gi & HALF;
#pragma unroll
    for (int s = 0; s < HALF; ++s)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float send = up ? v[s][c] : v[s + HALF][c];
        const float keep = up ? v[s + HALF][c] : v[s][c];
        v[s][c] = keep + __shfl_xor_sync(FULL, send, HALF);
      }
    transpose_level<HALF / 2, G, C>(v, gi);
  }
}

// v[s][c] is this lane's part of value c of item s.  On return v[0][c] is the sum, over
// the G neighbouring lanes of its group (lane % G = gi), of value c of item gi: lane gi
// holds item gi's sums, after G - 1 shuffles a value (log2 G a value and item with a sum
// on every lane).
template <int G, int C>
__device__ __forceinline__ void group_transpose_sum(float (&v)[G][C], int gi) {
  static_assert(G >= 2 && G <= 16 && (G & (G - 1)) == 0, "a power of two lanes, at most 16");
  transpose_level<G / 2, G, C>(v, gi);
}

// N consecutive floats of shared memory (N = 2, or a multiple of 4 16-byte aligned).
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 f = *reinterpret_cast<const float4*>(p + 4 * i);
      o[4 * i] = f.x; o[4 * i + 1] = f.y; o[4 * i + 2] = f.z; o[4 * i + 3] = f.w;
    }
  } else {
    static_assert(N == 2, "2 floats, or a multiple of 4");
    const float2 f = *reinterpret_cast<const float2*>(p);
    o[0] = f.x; o[1] = f.y;
  }
}

// Row thread (p, c): out = diag(w_t) in + k_t v_t^T on its elements of rows 2p, 2p + 1
// (in and out may be the same array).  `tiles` as k7_convert lays them out.
template <int M>
__device__ __forceinline__ void k7_replay(const float (&in)[M / 4], float (&out)[M / 4],
                                          const float* tiles, int t, int p, int c) {
  constexpr int CPT = M / 8;                               // columns a row thread owns
  float ka[2], wa[2];
  lds<2>(tiles + K7_CH * M + t * M + 2 * p, ka);
  lds<2>(tiles + 3 * K7_CH * M + t * M + 2 * p, wa);
  const float* vt = tiles + 2 * K7_CH * M + t * M;
#pragma unroll
  for (int e4 = 0; e4 < CPT / 4; ++e4) {
    float vv[4];
    lds<4>(vt + 4 * (c + 8 * e4), vv);
#pragma unroll
    for (int rho = 0; rho < 2; ++rho)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int e = rho * CPT + 4 * e4 + x;
        out[e] = fmaf(wa[rho], in[e], ka[rho] * vv[x]);
      }
  }
}

// The chunk walk both groups make, from the last chunk to the first: a chunk's copy
// comes in while the one before it is worked on.
template <typename T, int M, bool VEC>
struct K7Walk {
  using L = K7Smem<T, M>;
  const T *r, *k, *v, *dy;
  const float *w, *si_bh;                // s_init of this (b, h)
  size_t seq;                            // this (b, h)'s first element of r, k, v, w, dy
  int S, chunk, n_chunks;
  unsigned char* base;                   // the two stages
  float* tiles;                          // r, k, v, w, dy (K7_CH, M); ruk, vdy (K7_CH); u (M)
  unsigned long long* bars;              // the stages' mbarriers (VEC)

  __device__ __forceinline__ const unsigned char* stage(int it) const {
    return base + (it & 1) * L::STAGE;
  }
  __device__ __forceinline__ int steps(int ic) const { return min(chunk, S - ic * chunk); }
  // Start copying chunk ic, the it-th of the walk.
  __device__ __forceinline__ void fill(int it, int ic) const {
    k7_fill<T, M, VEC>(base + (it & 1) * L::STAGE, r, k, v, dy, w, si_bh + (size_t)ic * M * M,
                       seq + (size_t)ic * chunk * M, steps(ic), bars + (it & 1));
  }
  // The head of chunk ic: wait for its copy, convert it into the tiles, start copying
  // the next chunk, and wait until the tiles are in.
  __device__ __forceinline__ void head(int it, int ic) const {
    // a stage is filled at the walk's chunks it, it + 2, ..: phases 0, 1, 0, ..
    if constexpr (VEC) mbar_wait(bars + (it & 1), (it >> 1) & 1);
    __syncthreads();   // this chunk's copy is in; the tiles and the other stage are free
    float* ruk = tiles + 5 * K7_CH * M;
    k7_convert<T, M>(stage(it), tiles, ruk, ruk + K7_CH, ruk + 2 * K7_CH, steps(ic));
    if (ic > 0) fill(it + 1, ic - 1);
    __syncthreads();   // the tiles are ready
  }
};

// K7's row group, thread lt = (p, c): rows 2p, 2p + 1 of the adjoint; replays the chunk's
// states on them from s_init, HC = 4 steps of history at a time, and writes dw, dk, dr of
// its rows and their du partials.
template <typename T, int M, bool VEC>
__device__ __forceinline__ void k7_rows(const K7Walk<T, M, VEC>& wk, const float* dsb,
                                        float ua, float* dr, float* dk, float* dw,
                                        float* du_bh, float4* ckpt, int lt) {
  using L = K7Smem<T, M>;
  constexpr int E = M / 4, E4 = E / 4, HC = K7_HC, NSUB = L::NSUB, QM = Q * M;
  constexpr int CPT = M / 8;             // columns a row thread owns, in 2 rows
  const float* r_s = wk.tiles;
  const float* k_s = wk.tiles + K7_CH * M;
  const float* v_s = wk.tiles + 2 * K7_CH * M;
  const float* w_s = wk.tiles + 3 * K7_CH * M;
  const float* dy_s = wk.tiles + 4 * K7_CH * M;
  const float* vdy = wk.tiles + 5 * K7_CH * M + K7_CH;
  const int p = lt / 8, c = lt % 8;
  // lane c ends each sub-chunk with step c / 2 of row 2p + c % 2
  const int row_q = 2 * p + c % 2;
  float g[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    g[e] = dsb[(2 * p + e / CPT) * M + 4 * (c + 8 * (e % CPT / 4)) + e % 4];
  float du_acc = 0.f;

  for (int ic = wk.n_chunks - 1, it = 0; ic >= 0; --ic, ++it) {
    wk.head(it, ic);
    const int t0 = ic * wk.chunk, steps = wk.steps(ic);
    const float* si_s = reinterpret_cast<const float*>(wk.stage(it)) + 2 * p * M;
#pragma unroll
    for (int sc = NSUB - 1; sc >= 0; --sc) {
      const int tb = sc * HC;
      // hist[t]: the state before step tb + t on this thread's elements
      float hist[HC][E];
      if (sc == NSUB - 1 || sc == 0) {
#pragma unroll
        for (int e4 = 0; e4 < E4; ++e4) {
          float s4[4];
          lds<4>(si_s + (e4 / (CPT / 4)) * M + 4 * (c + 8 * (e4 % (CPT / 4))), s4);
#pragma unroll
          for (int x = 0; x < 4; ++x) hist[0][4 * e4 + x] = s4[x];
        }
        // the walk's first sub-chunk: replay up to it, keeping the states between
#pragma unroll 4
        for (int t = 0; t < (sc == 0 ? 0 : tb); ++t) {
          if (L::NCKPT > 0 && t % HC == 0 && t > 0) {
#pragma unroll
            for (int e4 = 0; e4 < E4; ++e4)
              ckpt[((t / HC - 1) * E4 + e4) * QM + lt] =
                  make_float4(hist[0][4 * e4], hist[0][4 * e4 + 1], hist[0][4 * e4 + 2],
                              hist[0][4 * e4 + 3]);
          }
          k7_replay<M>(hist[0], hist[0], wk.tiles, t, p, c);
        }
      } else {
#pragma unroll
        for (int e4 = 0; e4 < E4; ++e4) {
          const float4 s4 = ckpt[((sc - 1) * E4 + e4) * QM + lt];
          hist[0][4 * e4] = s4.x;
          hist[0][4 * e4 + 1] = s4.y;
          hist[0][4 * e4 + 2] = s4.z;
          hist[0][4 * e4 + 3] = s4.w;
        }
      }
#pragma unroll
      for (int t = 0; t + 1 < HC; ++t)
        k7_replay<M>(hist[t], hist[t + 1], wk.tiles, tb + t, p, c);
      // the adjoint, steps in reverse: (dw, dk, dr) partial sums of rows 2p, 2p + 1
      float acc[2 * HC][3];
#pragma unroll
      for (int t = HC - 1; t >= 0; --t) {
        const int tt = tb + t;
        float ra[2], wa[2];
        lds<2>(r_s + tt * M + 2 * p, ra);
        lds<2>(w_s + tt * M + 2 * p, wa);
        float pw[2] = {0.f, 0.f}, pk[2] = {0.f, 0.f}, pr[2] = {0.f, 0.f};
#pragma unroll
        for (int e4 = 0; e4 < CPT / 4; ++e4) {
          float vv[4], dd[4];
          lds<4>(v_s + tt * M + 4 * (c + 8 * e4), vv);
          lds<4>(dy_s + tt * M + 4 * (c + 8 * e4), dd);
#pragma unroll
          for (int rho = 0; rho < 2; ++rho)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int e = rho * CPT + 4 * e4 + x;
              pw[rho] = fmaf(g[e], hist[t][e], pw[rho]);
              pk[rho] = fmaf(g[e], vv[x], pk[rho]);
              pr[rho] = fmaf(hist[t][e], dd[x], pr[rho]);
              g[e] = fmaf(wa[rho], g[e], ra[rho] * dd[x]);
            }
        }
#pragma unroll
        for (int rho = 0; rho < 2; ++rho) {
          acc[2 * t + rho][0] = pw[rho];
          acc[2 * t + rho][1] = pk[rho];
          acc[2 * t + rho][2] = pr[rho];
        }
      }
      group_transpose_sum<2 * HC, 3>(acc, c);
      // lane c writes step tb + c / 2 of row 2p + c % 2, with the u terms
      const int tq = tb + c / 2;
      const float rq = r_s[tq * M + row_q], kq = k_s[tq * M + row_q], vd = vdy[tq];
      if (tq < steps) {
        const size_t o = wk.seq + (size_t)(t0 + tq) * M + row_q;
        dw[o] = acc[0][0];
        dk[o] = fmaf(ua * rq, vd, acc[0][1]);
        dr[o] = fmaf(ua * kq, vd, acc[0][2]);
      }
      du_acc = fmaf(rq * kq, vd, du_acc);
    }
  }
  // lanes c, c ^ 2, c ^ 4, c ^ 6 hold the same row
  du_acc += __shfl_xor_sync(FULL, du_acc, 2);
  du_acc += __shfl_xor_sync(FULL, du_acc, 4);
  if (c < 2) du_bh[row_q] = du_acc;
}

// K7's column group, thread lt = (cs, ri): rows 4 ri + x (x < 4) and columns CC cs + y
// (y < CC = M / K7_CDIV) of the adjoint; writes dv.  The M/4 lanes of a column set are
// neighbours; after each sub-chunk, lane ri holds V = 16 CC / M values of one step.
template <typename T, int M, bool VEC>
__device__ __forceinline__ void k7_columns(const K7Walk<T, M, VEC>& wk, const float* dsb,
                                           float* dv, int lt) {
  using L = K7Smem<T, M>;
  constexpr int HC = K7_HC, NSUB = L::NSUB;
  constexpr int CC = M / K7_CDIV, GC = M / 4, V = HC * CC / GC, IPS = CC / V;   // items a step
  static_assert(V >= 1 && HC * CC == GC * V, "whole values a lane after each sub-chunk");
  const float* r_s = wk.tiles;
  const float* k_s = wk.tiles + K7_CH * M;
  const float* w_s = wk.tiles + 3 * K7_CH * M;
  const float* dy_s = wk.tiles + 4 * K7_CH * M;
  const float* ruk = wk.tiles + 5 * K7_CH * M;
  const int cs = lt / GC, ri = lt % GC;
  float g[4 * CC];
#pragma unroll
  for (int e = 0; e < 4 * CC; ++e) g[e] = dsb[(4 * ri + e / CC) * M + CC * cs + e % CC];

  for (int ic = wk.n_chunks - 1, it = 0; ic >= 0; --ic, ++it) {
    wk.head(it, ic);
    const int t0 = ic * wk.chunk, steps = wk.steps(ic);
#pragma unroll 1
    for (int sc = NSUB - 1; sc >= 0; --sc) {
      const int tb = sc * HC;
      float pv[GC][V];                   // item t IPS + y / V, value y % V: step t, column y
#pragma unroll
      for (int t = HC - 1; t >= 0; --t) {
        const int tt = tb + t;
        float kk[4], ww[4], rr[4], dd[CC];
        lds<4>(k_s + tt * M + 4 * ri, kk);
        lds<4>(w_s + tt * M + 4 * ri, ww);
        lds<4>(r_s + tt * M + 4 * ri, rr);
        lds<CC>(dy_s + tt * M + CC * cs, dd);
        float pcol[CC];
#pragma unroll
        for (int y = 0; y < CC; ++y) pcol[y] = 0.f;
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < CC; ++y) {
            const int e = x * CC + y;
            pcol[y] = fmaf(g[e], kk[x], pcol[y]);
            g[e] = fmaf(ww[x], g[e], rr[x] * dd[y]);
          }
#pragma unroll
        for (int y = 0; y < CC; ++y) pv[t * IPS + y / V][y % V] = pcol[y];
      }
      group_transpose_sum<GC, V>(pv, ri);
      // lane ri writes step tb + ri / IPS, columns CC cs + V (ri % IPS) + j
      const int tq = tb + ri / IPS;
      if (tq < steps) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int col = CC * cs + V * (ri % IPS) + j;
          dv[wk.seq + (size_t)(t0 + tq) * M + col] =
              fmaf(ruk[tq], dy_s[tq * M + col], pv[0][j]);
        }
      }
    }
  }
}

// K7.  One block per (b, h), k7_threads<M>() threads, walking the chunks from last to
// first.  Both groups run the adjoint G_{t-1} = diag(w_t) G_t + r_t dy_t^T over the
// chunk's steps in reverse, HC = 4 steps at a time: the row group (threads [0, QM)) with
// the replay, for dw, dk, dr, du; the column group (the rest) for dv.
template <typename T, int M, bool VEC>
__global__ void __launch_bounds__(k7_threads<M>(), 1) wkv6_bwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s_init,
    const T* __restrict__ dy, const float* __restrict__ ds, float* __restrict__ dr,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dw,
    float* __restrict__ du, int H, int S, int chunk, int n_chunks) {
  using L = K7Smem<T, M>;
  constexpr int QM = Q * M;
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  float* tiles = reinterpret_cast<float*>(base + 2 * L::STAGE + L::CKPT);
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(base + 2 * L::STAGE + L::CKPT + L::TILES);
  const int bh = blockIdx.x, h = bh % H;
  const K7Walk<T, M, VEC> wk{r, k, v, dy, w, s_init + (size_t)bh * n_chunks * M * M,
                                 (size_t)bh * S * M, S, chunk, n_chunks, base, tiles, bars};
  float* u_s = tiles + 5 * K7_CH * M + 2 * K7_CH;
  if (threadIdx.x < M) u_s[threadIdx.x] = u[h * M + threadIdx.x];
  if (VEC && threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
  }
  __syncthreads();   // the mbarriers are initialised
  wk.fill(0, n_chunks - 1);
  const float* dsb = ds + (size_t)bh * M * M;
  // warp-uniform to the compiler (read from lane 0), so the shuffles inside the groups'
  // branches need no code for a diverged warp
  if (__shfl_sync(FULL, threadIdx.x < QM, 0)) {
    const int lt = threadIdx.x;
    k7_rows<T, M, VEC>(wk, dsb, u[h * M + 2 * (lt / 8) + lt % 2], dr, dk, dw,
                       du + (size_t)bh * M, reinterpret_cast<float4*>(base + 2 * L::STAGE), lt);
  } else {
    k7_columns<T, M, VEC>(wk, dsb, dv, threadIdx.x - QM);
  }
}

size_t fwd_smem(int M) { return sizeof(float) * (4 * TS * M + TS + M); }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int M>
cudaError_t launch_fwd(const void* r, const void* k, const void* v, const void* w,
                       const void* u, void* y, void* s_final, void* s_init, int B, int H,
                       int S, int chunk, cudaStream_t stream) {
  const size_t smem = fwd_smem(M);
  cudaError_t e = allow_smem(fwd_kernel<T, M>, smem);
  if (e != cudaSuccess) return e;
  const int n_chunks = (S + chunk - 1) / chunk;
  fwd_kernel<T, M><<<B * H, Q * M, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<T*>(y),
      static_cast<float*>(s_final), static_cast<float*>(s_init), H, S, chunk, n_chunks);
  return cudaGetLastError();
}

template <typename T, int M, bool VEC>
cudaError_t launch_wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                            const void* u, const void* s_init, const void* dy, const void* ds,
                            void* dr, void* dk, void* dv, void* dw, void* du, int B, int H,
                            int S, int chunk, cudaStream_t stream) {
  constexpr size_t smem = K7Smem<T, M>::BYTES;
  cudaError_t e = allow_smem(wkv6_bwd_kernel<T, M, VEC>, smem);
  if (e != cudaSuccess) return e;
  const int n_chunks = (S + chunk - 1) / chunk;
  wkv6_bwd_kernel<T, M, VEC><<<B * H, k7_threads<M>(), smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s_init), static_cast<const T*>(dy),
      static_cast<const float*>(ds), static_cast<float*>(dr), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dw), static_cast<float*>(du), H, S, chunk,
      n_chunks);
  return cudaGetLastError();
}

// K7 for any chunk of 1 to K7_CH steps (a shorter chunk is padded with identity steps),
// fed by bulk copies where every sequence and s_init pointer is 16-byte aligned.
template <typename T, int M>
cudaError_t launch_bwd(const void* r, const void* k, const void* v, const void* w,
                       const void* u, const void* s_init, const void* dy, const void* ds,
                       void* dr, void* dk, void* dv, void* dw, void* du, int B, int H, int S,
                       int chunk, cudaStream_t stream) {
  if (chunk < 1 || chunk > K7_CH) return cudaErrorInvalidValue;
  const bool vec = ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dy) |
                     reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(s_init)) &
                    15) == 0;
  return vec ? launch_wkv6_bwd<T, M, true>(r, k, v, w, u, s_init, dy, ds, dr, dk, dv, dw,
                                                 du, B, H, S, chunk, stream)
             : launch_wkv6_bwd<T, M, false>(r, k, v, w, u, s_init, dy, ds, dr, dk, dv,
                                                  dw, du, B, H, S, chunk, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers, `stream` is a
// cudaStream_t; `bf16` selects bf16 (1) or fp32 (0) r/k/v/y/dy; M must be 32 or 64.
// Each function returns the cudaError_t of its launch (0 on success).
#define WKV_DISPATCH(CALL)                                                  \
  if (bf16 && M == 64) return (int)CALL(__nv_bfloat16, 64);                 \
  if (bf16 && M == 32) return (int)CALL(__nv_bfloat16, 32);                 \
  if (!bf16 && M == 64) return (int)CALL(float, 64);                        \
  if (!bf16 && M == 32) return (int)CALL(float, 32);                        \
  return (int)cudaErrorInvalidValue;

extern "C" {

int wkv6_fwd(const void* r, const void* k, const void* v, const void* w, const void* u,
             void* y, void* s_final, void* s_init, int B, int H, int S, int M, int chunk,
             int bf16, void* stream) {
#define CALL(T, MM) \
  launch_fwd<T, MM>(r, k, v, w, u, y, s_final, s_init, B, H, S, chunk, \
                    static_cast<cudaStream_t>(stream))
  WKV_DISPATCH(CALL)
#undef CALL
}

int wkv6_bwd(const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* s_init, const void* dy, const void* ds, void* dr, void* dk, void* dv,
             void* dw, void* du, int B, int H, int S, int M, int chunk, int bf16,
             void* stream) {
#define CALL(T, MM)                                                                     \
  launch_bwd<T, MM>(r, k, v, w, u, s_init, dy, ds, dr, dk, dv, dw, du, B, H, S, chunk, \
                    static_cast<cudaStream_t>(stream))
  WKV_DISPATCH(CALL)
#undef CALL
}

}  // extern "C"
