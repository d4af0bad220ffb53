// RWKV-6 WKV recurrence for Hopper (sm_90a): forward (K6) and backward (K7).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/rwkv6_scan.py:
//   K6 wkv6_fwd_kernel <- _fwd_kernel  (S_t = diag(w_t) S_{t-1} + k_t v_t^T,
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
//   K6 (wkv6_fwd_kernel): warp specialised.  The compute warps hold the state in
//       registers, thread (rg, cg) R consecutive rows (R rg + x) by C consecutive
//       columns (C cg + c): at M = 64, 4 x 4, 256 threads of 16 elements.  A step's r, k,
//       w of its rows and v of its columns are one 16-byte shared-memory load each.  y_t[j]
//       is a sum over rows: the sums of HS = 8 steps are taken together by a transposing
//       reduce over the G = M / R lanes of a column group (G - 1 shuffles a value) that
//       leaves each lane its (step, column) sums.
//       - Copies ahead: four producer warps (one a scheduler) bring each tile of 64 steps
//         (32 in fp32) of r, k, v (in T) and w into a stage by four TMA bulk copies onto
//         an mbarrier (inputs not 16-byte aligned: plain loads), convert it into one of
//         two fp32 tile buffers with each step's r.u.k (the u-term, which the lane that
//         holds a sum adds), and start the next copy.  Buffers change hands by mbarriers
//         (full: producers to compute warps; empty: back), so no warp waits at a
//         block-wide barrier and the conversion overlaps the steps.
//       - y goes through the buffer's y tile and out as whole rows in 16-byte stores, by
//         the producers two tiles later.  A chunk's initial state is written from
//         registers in 16-byte stores at the step a countdown names (no division in the
//         step loop); with a chunk that is a multiple of HS steps only the first step of
//         each group is checked (checking every step is 1.04 times slower on an H100).
//       - Each state element is updated as fmaf(w_i, S_ij, k_i v_j), so the states are
//         bitwise those of the sequential recurrence in that form.
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
// K6's bound on the H100: 5 fp32 operations per state element and step
// (bench.rwkv6_fwd_ops) on O(M) bytes of input, so the function is bound by operations
// on the CUDA cores (67 TFLOP/s fp32: the recurrence has no matrix product for the
// tensor cores in this form), 0.16 ms at RWKV6-7B's shape.  The chunk-initial states it
// also writes for K7 (16 KiB a chunk and (b, h), 537 MB at chunk 16) put a floor of
// 0.28 ms on the bytes it moves.  Its compute warps issue ~4.5 instructions per state
// element and step (3 FP, the loads, the sums), 8 warps an SM beside 4 producers, and it
// takes ~0.46 ms there (tools/rwkv6_ab.py): the y sums' shuffles, the per-step loads and
// the state stores each cost 12-20 % of that, none alone bounds it.
// K7's bound: 11 fp32 operations per state element and step (bench.rwkv6_bwd_ops), 0.35 ms
// at RWKV6-7B's shape.  It issues ~16 instructions per element and step (the replay 1.5
// times over, G updated in both groups, the transposing sums) from 12 warps an SM, the 8
// row warps on the critical path, and takes ~1.6 ms there (tools/rwkv6_ab.py): what is
// left of the gap is issue and latency in the row warps, not memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

constexpr int Q = 4;                 // K7: threads per state row / column

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x += __shfl_xor_sync(FULL, x, m);
  return x;
}

// TMA bulk copies from global to shared memory that report to an mbarrier in shared
// memory (one arrival, by the thread that issues them, with the bytes to expect).
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

constexpr int K6_NP = 128;           // K6's producer threads: a warp a scheduler

// K6 geometry.  Compute thread (rg, cg) owns rows R rg + x (x < R) and columns
// C cg + c (c < C) of its (b, h) pair's state; lane = rg (32 / G) + cg % (32 / G), so the
// G lanes of a column group are 32 / G apart (a quarter-warp's row loads read few
// addresses, each for several lanes: on an H100, 1.34 times faster than 8 distinct
// addresses a quarter-warp).  Each choice was timed on an H100 at RWKV6-7B's shape
// against the others (PERF.md, section 6): 4 x 4 a thread at M = 64 (8 x 2 1.04, 8 x 4 1.05
// times slower), 4 x 2 at M = 32; the sums of HS = 2 G / C steps at once (G / C: 1.11,
// 4 G / C: 1.03 times slower); tiles of 64 steps in bf16 (32: 1.07 times slower), 32 in
// fp32 for shared memory; 4 producer warps (2: 1.18 times slower).
template <typename T, int M>
struct K6 {
  static constexpr int R = 4;                     // rows a thread
  static constexpr int C = M == 64 ? 4 : 2;       // columns a thread
  static constexpr int G = M / R;                 // lanes that share a column group
  static constexpr int HX = 2;                    // values an item
  static constexpr int HS = G / C * HX;           // steps summed at once: G (step, column) items
  static constexpr int CPW = 32 / G;              // column groups a warp
  static constexpr int NC = G * (M / C);          // compute threads
  static constexpr int NP = K6_NP;                // producer threads
  static constexpr int NT = NC + NP;
  static constexpr int TS = sizeof(T) == 2 ? 64 : 32;   // steps a tile
  static constexpr int YS = M + 8;                // row stride of the y tile (no bank conflict)
  // the stage, one tile as copied: w (TS, M) in fp32, then r, k, v (TS, M) in T
  static constexpr size_t STAGE = sizeof(float) * TS * M + sizeof(T) * 3 * TS * M;
  // a tile buffer: r, k, v, w (TS, M) and y (TS, YS) in fp32; ruk (TS)
  static constexpr size_t TILE = sizeof(float) * (4 * TS * M + TS * YS + TS);
  // the stage, two tile buffers, u (M), mbarriers: the stage's copy, buffers full, empty
  static constexpr size_t BYTES = STAGE + 2 * TILE + sizeof(float) * M + 5 * 8;
  static_assert(G >= 2 && G <= 16 && TS % HS == 0 && NC % 32 == 0, "geometry");
  static_assert(STAGE % 16 == 0 && TILE % 16 == 0 && (M * sizeof(T)) % 16 == 0, "aligned");
  static_assert(BYTES <= 232448, "a block's shared memory");
};

// The producer warps' own barrier (named barrier 1).
__device__ __forceinline__ void k6_sync_producers() {
  asm volatile("bar.sync 1, %0;\n" :: "r"(K6_NP) : "memory");
}

// Copy steps [t0, t0 + steps) of this (b, h) (sequence offset `off`) into the stage;
// rows past `steps` are not touched (k6_convert pads them), so no copy reads past S.
// VEC: four TMA bulk copies, issued by producer 0, that complete the current phase of
// `bar` (every pointer 16-byte aligned); else plain loads and stores by every producer.
template <typename T, int M, bool VEC>
__device__ __forceinline__ void k6_fill(unsigned char* stage, const T* r, const T* k,
                                        const T* v, const float* w, size_t off, int steps,
                                        unsigned long long* bar, int pt) {
  using L = K6<T, M>;
  float* w_s = reinterpret_cast<float*>(stage);
  T* seq_s = reinterpret_cast<T*>(w_s + L::TS * M);
  const T* src[3] = {r + off, k + off, v + off};
  if constexpr (VEC) {
    if (pt == 0) {
      const unsigned seq_bytes = sizeof(T) * steps * M, w_bytes = sizeof(float) * steps * M;
      mbar_expect(bar, w_bytes + 3 * seq_bytes);
      bulk_copy(w_s, w + off, w_bytes, bar);
#pragma unroll
      for (int s = 0; s < 3; ++s) bulk_copy(seq_s + s * L::TS * M, src[s], seq_bytes, bar);
    }
  } else {
#pragma unroll 1
    for (int i = pt; i < steps * M; i += L::NP) {
      w_s[i] = w[off + i];
#pragma unroll
      for (int s = 0; s < 3; ++s) seq_s[s * L::TS * M + i] = src[s][i];
    }
  }
}

// N = 1 or 2 consecutive values of memory (2: 2 N-byte aligned) in fp32.
template <int N>
__device__ __forceinline__ void ld_f(const float* p, float (&o)[N]) {
  if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    o[0] = f.x; o[1] = f.y;
  } else {
    o[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void ld_f(const __nv_bfloat16* p, float (&o)[N]) {
  if constexpr (N == 2) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(p);
    o[0] = __low2float(b); o[1] = __high2float(b);
  } else {
    o[0] = __bfloat162float(*p);
  }
}

// C = 1, 2 or 4 consecutive floats into memory (aligned to 4 C bytes).
template <int C>
__device__ __forceinline__ void st_row(float* p, const float (&x)[C]) {
  if constexpr (C == 4) *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (C == 2) *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else *p = x[0];
}

// The stage's rows into a tile buffer's fp32 r, k, v, w, producer warp pw taking steps
// pw + 4 n; rows past `steps` get the identity step (w = 1, r = k = v = 0).  Also
// ruk[t] = sum_i r_t[i] u[i] k_t[i], the sums of KG steps at a time.
template <typename T, int M>
__device__ __forceinline__ void k6_convert(const unsigned char* stage, float* tile,
                                           const float* u_s, int steps, int pt) {
  using L = K6<T, M>;
  constexpr int TS = L::TS, NW = L::NP / 32;
  constexpr int E = M / 32;              // consecutive elements a lane (1 or 2)
  constexpr int N = TS / NW;             // steps a warp
  constexpr int KG = N < 8 ? N : 8;      // steps whose sums are taken together
  static_assert(TS % NW == 0 && (E == 1 || E == 2) && N % KG == 0 && KG >= 2 &&
                (KG & (KG - 1)) == 0, "whole groups of a power of two steps a warp");
  const float* w_raw = reinterpret_cast<const float*>(stage);
  const T* raw = reinterpret_cast<const T*>(w_raw + TS * M);     // r, k, v
  float* ruk = tile + 4 * TS * M + TS * L::YS;
  const int pw = pt / 32, lane = pt % 32;
  float uu[E];
#pragma unroll
  for (int e = 0; e < E; ++e) uu[e] = u_s[E * lane + e];
#pragma unroll 1
  for (int g = 0; g < N / KG; ++g) {
    float a[KG][1];                      // this lane's part of each step's r.u.k
#pragma unroll
    for (int n = 0; n < KG; ++n) {       // unrolled: the steps' loads and sums overlap
      const int t = pw + NW * (KG * g + n), idx = t * M + E * lane;
      const bool live = t < steps;
      float x[4][E];                     // r, k, v, w
#pragma unroll
      for (int s = 0; s < 3; ++s) ld_f<E>(raw + s * TS * M + idx, x[s]);
      ld_f<E>(w_raw + idx, x[3]);
      a[n][0] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
#pragma unroll
        for (int s = 0; s < 4; ++s) x[s][e] = live ? x[s][e] : (s == 3 ? 1.f : 0.f);
        a[n][0] = fmaf(x[0][e] * uu[e], x[1][e], a[n][0]);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) st_row<E>(tile + s * TS * M + idx, x[s]);
    }
    // over groups of KG lanes (lane % KG holds step lane % KG), then over the groups
    group_transpose_sum<KG, 1>(a, lane % KG);
#pragma unroll
    for (int m = KG; m < 32; m *= 2) a[0][0] += __shfl_xor_sync(FULL, a[0][0], m);
    if (lane < KG) ruk[pw + NW * (KG * g + lane)] = a[0][0];
  }
}

// Rows [0, steps) of a y tile (fp32, row stride YS) into y in T, 16 bytes a store, by
// the producers.
template <typename T, int M>
__device__ __forceinline__ void k6_write_y(T* y, const float* y_s, int steps, int pt) {
  using L = K6<T, M>;
  constexpr int V = 16 / sizeof(T), PER_ROW = M / V;          // elements a store
#pragma unroll 1
  for (int idx = pt; idx < steps * PER_ROW; idx += L::NP) {
    const int t = idx / PER_ROW, i = idx % PER_ROW * V;
    const float* src = y_s + t * L::YS + i;
    if constexpr (sizeof(T) == 2) {
      const float4 a = *reinterpret_cast<const float4*>(src);
      const float4 b = *reinterpret_cast<const float4*>(src + 4);
      __nv_bfloat162 o[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                             __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
      *reinterpret_cast<uint4*>(y + (size_t)t * M + i) = *reinterpret_cast<const uint4*>(o);
    } else {
      *reinterpret_cast<float4*>(y + (size_t)t * M + i) = *reinterpret_cast<const float4*>(src);
    }
  }
}

// HS steps of K6 from tile row tb (global step tt) on, compute thread (rg, cg): each
// step's partial sums of y over the thread's rows, then the state update; then the HS
// steps' sums over the G lanes of the column group, and lane rg writes its items (step
// tb + H0 h + rg / C, column C cg + rg % C) into the y tile.  The state is saved to `si`
// before the step `next_si` names (-1 once no chunk of the S steps is left: the identity
// steps past S in the last group start none); with EACH a chunk may start at any of the
// HS steps, else only at the first.
template <typename T, int M, bool EACH>
__device__ __forceinline__ void k6_steps(float (&st)[K6<T, M>::R][K6<T, M>::C], float* tile,
                                         int tb, int tt, int S, int chunk, int& next_si,
                                         float*& si, int rg, int cg) {
  using L = K6<T, M>;
  constexpr int R = L::R, C = L::C, G = L::G, HS = L::HS, TS = L::TS, HX = L::HX;
  constexpr int H0 = HS / HX;            // steps of one value of the items
  const float* r_s = tile;
  const float* k_s = tile + TS * M;
  const float* v_s = tile + 2 * TS * M;
  const float* w_s = tile + 3 * TS * M;
  float* y_s = tile + 4 * TS * M;
  const float* ruk = y_s + TS * L::YS;
  float acc[G][HX];                      // item (s % H0) C + c, value s / H0: step s, column c
#pragma unroll
  for (int s = 0; s < HS; ++s) {
    const int t = tb + s;
    if ((EACH || s == 0) && tt + s == next_si) {   // this chunk's initial state
#pragma unroll
      for (int x = 0; x < R; ++x) st_row<C>(si + (R * rg + x) * M + C * cg, st[x]);
      si += M * M;
      next_si = next_si < S - chunk ? next_si + chunk : -1;
    }
    float rr[R], kk[R], ww[R], vv[C];
    lds<R>(r_s + t * M + R * rg, rr);
    lds<R>(k_s + t * M + R * rg, kk);
    lds<R>(w_s + t * M + R * rg, ww);
    lds<C>(v_s + t * M + C * cg, vv);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float p = 0.f;
#pragma unroll
      for (int x = 0; x < R; ++x) p = fmaf(rr[x], st[x][c], p);
      acc[s % H0 * C + c][s / H0] = p;
    }
#pragma unroll
    for (int x = 0; x < R; ++x)
#pragma unroll
      for (int c = 0; c < C; ++c) st[x][c] = fmaf(ww[x], st[x][c], kk[x] * vv[c]);
  }
  group_transpose_sum<G, HX, L::CPW>(acc, rg);
  const int col = C * cg + rg % C;
#pragma unroll
  for (int h = 0; h < HX; ++h) {
    const int tq = tb + H0 * h + rg / C;
    y_s[tq * L::YS + col] = fmaf(v_s[tq * M + col], ruk[tq], acc[0][h]);
  }
}

// K6's producers (the last NP threads): for each tile, wait for its copy in the stage and
// for the consumers to release the tile buffer it goes to, write out the y that buffer
// holds (two tiles back), convert the stage into it, start copying the next tile, and
// mark the buffer full.  bars: [0] the stage's copy, [1 + b] buffer b full, [3 + b]
// buffer b empty.
template <typename T, int M, bool VEC>
__device__ __forceinline__ void k6_produce(unsigned char* stage, float* tiles,
                                           const float* u_s, unsigned long long* bars,
                                           const T* r, const T* k, const T* v, const float* w,
                                           T* y, size_t seq, int S, int n_tiles) {
  using L = K6<T, M>;
  constexpr int TS = L::TS, TF = L::TILE / sizeof(float);
  const int pt = threadIdx.x - L::NC;
  k6_fill<T, M, VEC>(stage, r, k, v, w, seq, min(TS, S), bars, pt);
  for (int n = 0; n < n_tiles; ++n) {
    const int b = n & 1, t0 = n * TS;
    float* tile = tiles + b * TF;
    if constexpr (VEC) mbar_wait(bars, n & 1);    // tile n is in the stage
    else k6_sync_producers();               // ... as the producers copied it
    if (n >= 2) {                                 // the buffer's tile n - 2 is consumed
      mbar_wait(bars + 3 + b, ((n - 2) >> 1) & 1);
      k6_write_y<T, M>(y + seq + (size_t)(t0 - 2 * TS) * M, tile + 4 * TS * M, TS, pt);
    }
    k6_convert<T, M>(stage, tile, u_s, min(TS, S - t0), pt);
    k6_sync_producers();                    // the stage is read
    if (n + 1 < n_tiles)
      k6_fill<T, M, VEC>(stage, r, k, v, w, seq + (size_t)(t0 + TS) * M,
                         min(TS, S - t0 - TS), bars, pt);
    __syncwarp();
    if (pt % 32 == 0) mbar_arrive(bars + 1 + b);  // tile n is in buffer b
  }
  for (int n = max(n_tiles - 2, 0); n < n_tiles; ++n) {   // the last tiles' y
    const int b = n & 1;
    mbar_wait(bars + 3 + b, (n >> 1) & 1);
    k6_write_y<T, M>(y + seq + (size_t)n * TS * M, tiles + b * TF + 4 * TS * M,
                     min(TS, S - n * TS), pt);
  }
}

// K6's consumers (the first NC threads): the state in registers, the tiles in order, HS
// steps at a time; each warp releases a buffer when it is done with it.
template <typename T, int M>
__device__ __forceinline__ void k6_consume(float* tiles, unsigned long long* bars,
                                           float* s_init, float* s_final, int S, int chunk,
                                           int n_chunks, int n_tiles, int bh) {
  using L = K6<T, M>;
  constexpr int R = L::R, C = L::C, TS = L::TS, CPW = L::CPW, TF = L::TILE / sizeof(float);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rg = lane / CPW, cg = warp * CPW + lane % CPW;
  float st[R][C];
#pragma unroll
  for (int x = 0; x < R; ++x)
#pragma unroll
    for (int c = 0; c < C; ++c) st[x][c] = 0.f;
  int next_si = 0;                       // the step that starts the next chunk
  float* si = s_init + (size_t)bh * n_chunks * M * M;
  const bool each = chunk % L::HS != 0;
  for (int n = 0; n < n_tiles; ++n) {
    const int b = n & 1, t0 = n * TS, steps = min(TS, S - t0);
    float* tile = tiles + b * TF;
    mbar_wait(bars + 1 + b, (n >> 1) & 1);   // buffer b holds tile n
    if (each) {
      for (int tb = 0; tb < steps; tb += L::HS)
        k6_steps<T, M, true>(st, tile, tb, t0 + tb, S, chunk, next_si, si, rg, cg);
    } else {
      for (int tb = 0; tb < steps; tb += L::HS)
        k6_steps<T, M, false>(st, tile, tb, t0 + tb, S, chunk, next_si, si, rg, cg);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 3 + b);   // this warp is done with buffer b
  }
  float* sf = s_final + (size_t)bh * M * M;
#pragma unroll
  for (int x = 0; x < R; ++x) st_row<C>(sf + (R * rg + x) * M + C * cg, st[x]);
}

// K6.  One block per (b, h): NC compute threads hold the state and walk the tiles of TS
// steps; NP producer threads copy, convert and write out y, a tile ahead, through one
// stage and two tile buffers (warp specialisation: no block-wide barrier in the walk).
template <typename T, int M, bool VEC>
__global__ void __launch_bounds__(K6<T, M>::NT, 1) wkv6_fwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, T* __restrict__ y,
    float* __restrict__ s_final, float* __restrict__ s_init, int H, int S, int chunk,
    int n_chunks) {
  using L = K6<T, M>;
  extern __shared__ float4 smem4[];
  unsigned char* stage = reinterpret_cast<unsigned char*>(smem4);
  float* tiles = reinterpret_cast<float*>(stage + L::STAGE);       // two tile buffers
  float* u_s = tiles + 2 * L::TILE / sizeof(float);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(u_s + M);
  const int bh = blockIdx.x, h = bh % H;
  if (threadIdx.x < M) u_s[threadIdx.x] = u[h * M + threadIdx.x];
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(bars + 1 + b, L::NP / 32);
      mbar_init(bars + 3 + b, L::NC / 32);
    }
  }
  __syncthreads();   // u and the mbarriers are ready
  const int n_tiles = (S + L::TS - 1) / L::TS;
  // warp-uniform to the compiler (read from lane 0), so the shuffles inside the roles
  // need no code for a diverged warp
  if (__shfl_sync(FULL, threadIdx.x >= L::NC, 0))
    k6_produce<T, M, VEC>(stage, tiles, u_s, bars, r, k, v, w, y, (size_t)bh * S * M, S,
                          n_tiles);
  else
    k6_consume<T, M>(tiles, bars, s_init, s_final, S, chunk, n_chunks, n_tiles, bh);
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int M, bool VEC>
cudaError_t launch_wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                            const void* u, void* y, void* s_final, void* s_init, int B, int H,
                            int S, int chunk, cudaStream_t stream) {
  constexpr size_t smem = K6<T, M>::BYTES;
  cudaError_t e = allow_smem(wkv6_fwd_kernel<T, M, VEC>, smem);
  if (e != cudaSuccess) return e;
  const int n_chunks = (S + chunk - 1) / chunk;
  wkv6_fwd_kernel<T, M, VEC><<<B * H, K6<T, M>::NT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<T*>(y),
      static_cast<float*>(s_final), static_cast<float*>(s_init), H, S, chunk, n_chunks);
  return cudaGetLastError();
}

// K6 for any chunk of 1 step or more, fed by bulk copies where r, k, v and w are 16-byte
// aligned.  y must be 16-byte aligned (its rows leave in 16-byte stores) and the states
// 8-byte aligned, as the wrapper allocates them.
template <typename T, int M>
cudaError_t launch_fwd(const void* r, const void* k, const void* v, const void* w,
                       const void* u, void* y, void* s_final, void* s_init, int B, int H,
                       int S, int chunk, cudaStream_t stream) {
  if (chunk < 1 || S < 1 || (reinterpret_cast<uintptr_t>(y) & 15) ||
      ((reinterpret_cast<uintptr_t>(s_final) | reinterpret_cast<uintptr_t>(s_init)) & 7))
    return cudaErrorInvalidValue;
  const bool vec = ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  return vec ? launch_wkv6_fwd<T, M, true>(r, k, v, w, u, y, s_final, s_init, B, H, S, chunk,
                                           stream)
             : launch_wkv6_fwd<T, M, false>(r, k, v, w, u, y, s_final, s_init, B, H, S, chunk,
                                            stream);
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
