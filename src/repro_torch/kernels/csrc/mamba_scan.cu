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
// K4.  The TPU grid's sequential chunk axis becomes a loop inside one block per (batch
// row, 128 channels); each thread owns one channel and its N = 16 state in registers.
// B_t and C_t, shared by all channels, and the channels' u and dt come through shared
// memory 64 steps at a time.  Per step and channel it does ~6 N fp32 operations and N
// exponentials on ~8 bytes of input; with one thread per channel the grid holds B*di
// threads (16384 at Jamba's B = 2, di = 8192), about four warps per SM.
//
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

namespace {

constexpr int CB = 128;              // channels per block (K4: a thread each; K5: 4 lanes)
constexpr int TS = 64;               // K4: steps per shared-memory tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Steps [t0, t0 + n) of the block's channels of a (S, di) sequence into a (tile, CB)
// fp32 tile; steps past n and channels past di hold 0.
template <typename T>
__device__ __forceinline__ void load_channels(float* dst, const T* src, int t0, int n,
                                              int tile, int c0, int di) {
  for (int idx = threadIdx.x; idx < tile * CB; idx += CB) {
    const int t = idx / CB, c = c0 + idx % CB;
    dst[idx] = t < n && c < di ? to_f(src[(size_t)(t0 + t) * di + c]) : 0.f;
  }
}

// Steps [t0, t0 + n) of a (S, N) sequence into a (tile, N) fp32 tile, 0 past n.
template <typename T, int N>
__device__ __forceinline__ void load_state_rows(float* dst, const T* src, int t0, int n,
                                                int tile) {
  for (int idx = threadIdx.x; idx < tile * N; idx += CB)
    dst[idx] = idx / N < n ? to_f(src[(size_t)t0 * N + idx]) : 0.f;
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

// K4.  Grid (channel blocks, B); thread = channel.
template <typename T, int N>
__global__ void __launch_bounds__(CB) fwd_kernel(const T* __restrict__ u,
                                                 const T* __restrict__ dt,
                                                 const T* __restrict__ Bm,
                                                 const T* __restrict__ Cm,
                                                 const float* __restrict__ A,
                                                 const float* __restrict__ D,
                                                 T* __restrict__ y, float* __restrict__ h_init,
                                                 int S, int di, int chunk, int n_chunks) {
  extern __shared__ float smem[];
  float* u_s = smem;                     // (TS, CB) each
  float* dt_s = u_s + TS * CB;
  float* b_s = dt_s + TS * CB;           // (TS, N) each
  float* c_s = b_s + TS * N;

  const int b = blockIdx.y, c0 = blockIdx.x * CB, c = c0 + threadIdx.x;
  const bool live = c < di;
  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[(size_t)c * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dd = live ? D[c] : 0.f;
  const size_t row = (size_t)b * S;

  for (int t0 = 0; t0 < S; t0 += TS) {
    const int steps = min(TS, S - t0);
    __syncthreads();                     // the previous tiles are consumed
    load_channels(u_s, u + row * di, t0, steps, TS, c0, di);
    load_channels(dt_s, dt + row * di, t0, steps, TS, c0, di);
    load_state_rows<T, N>(b_s, Bm + row * N, t0, steps, TS);
    load_state_rows<T, N>(c_s, Cm + row * N, t0, steps, TS);
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < steps; ++t) {
      const int tt = t0 + t;
      if (tt % chunk == 0) {             // this chunk's initial state
        float4* hi = reinterpret_cast<float4*>(
            h_init + (((size_t)b * n_chunks + tt / chunk) * di + c) * N);
#pragma unroll
        for (int n = 0; n < N; n += 4) hi[n / 4] = make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
      }
      const float ut = u_s[t * CB + threadIdx.x], dtt = dt_s[t * CB + threadIdx.x];
      const float x = dtt * ut;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = fmaf(h[n], expf(dtt * a[n]), x * b_s[t * N + n]);
        acc = fmaf(h[n], c_s[t * N + n], acc);
      }
      y[(row + tt) * di + c] = from_f<T>(fmaf(dd, ut, acc));
    }
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

// K5.  Grid (channel blocks, B), K5_THREADS threads: thread = (channel, quarter).
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(K5_THREADS, 1) bwd_kernel(
    const T* __restrict__ u, const T* __restrict__ dt, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ A, const float* __restrict__ D,
    const float* __restrict__ h_init, const T* __restrict__ dy, float* __restrict__ du,
    float* __restrict__ ddt, float* __restrict__ dB_p, float* __restrict__ dC_p,
    float* __restrict__ dA_p, float* __restrict__ dD_p, int Bsz, int S, int di, int chunk,
    int n_chunks) {
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
    // quarter 0 writes the channel's ddt, quarter 1 its du, from this chunk's first row
    float* const drow = (n0 == 0 ? ddt : du) + ((size_t)b * S + t0) * di + c;
    const float* h_s = reinterpret_cast<const float*>(cur);
    const T* u_s = reinterpret_cast<const T*>(cur + sizeof(float) * CB * N);
    const T* dt_s = u_s + K5_CH * CB;
    const T* dy_s = dt_s + K5_CH * CB;
    const T* b_s = dy_s + K5_CH * CB;
    const T* c_s = b_s + K5_CH * N;

    // replay: hist[t] = the pre-state of step t0 + t
    float h[4], hist[K5_CH][4];
    load4(h_s + cl * N + n0, h);
#pragma unroll
    for (int t = 0; t < K5_CH; ++t) {
      const float dtt = to_f(dt_s[t * CB + cl]), dtl = dtt * LOG2E;
      const float x = dtt * to_f(u_s[t * CB + cl]);
      float bn[4];
      load4(b_s + t * N + n0, bn);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hist[t][j] = h[j];
        h[j] = fmaf(h[j], ex2(dtl * a[j]), x * bn[j]);
      }
    }
    // adjoint, steps in reverse
#pragma unroll
    for (int t = K5_CH - 1; t >= 0; --t) {
      const float ut = to_f(u_s[t * CB + cl]), dtt = to_f(dt_s[t * CB + cl]);
      const float dyt = to_f(dy_s[t * CB + cl]);
      const float x = dtt * ut, dtl = dtt * LOG2E;
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
        g[j] = gt * dec;
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

size_t fwd_smem(int N) { return sizeof(float) * (2 * TS * CB + 2 * TS * N); }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int N>
cudaError_t launch_fwd(const void* u, const void* dt, const void* Bm, const void* Cm,
                       const void* A, const void* D, void* y, void* h_init, int Bsz, int S,
                       int di, int chunk, cudaStream_t stream) {
  const size_t smem = fwd_smem(N);
  cudaError_t e = allow_smem(fwd_kernel<T, N>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((di + CB - 1) / CB, Bsz);
  fwd_kernel<T, N><<<grid, CB, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(h_init), S, di, chunk, (S + chunk - 1) / chunk);
  return cudaGetLastError();
}

template <typename T, int N, bool VEC>
cudaError_t launch_bwd_as(const void* u, const void* dt, const void* Bm, const void* Cm,
                          const void* A, const void* D, const void* h_init, const void* dy,
                          void* du, void* ddt, void* dB_p, void* dC_p, void* dA_p,
                          void* dD_p, int Bsz, int S, int di, int chunk,
                          cudaStream_t stream) {
  constexpr size_t smem = k5_smem_bytes<T, N>();
  cudaError_t e = allow_smem(bwd_kernel<T, N, VEC>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((di + CB - 1) / CB, Bsz);
  bwd_kernel<T, N, VEC><<<grid, K5_THREADS, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(h_init), static_cast<const T*>(dy), static_cast<float*>(du),
      static_cast<float*>(ddt), static_cast<float*>(dB_p), static_cast<float*>(dC_p),
      static_cast<float*>(dA_p), static_cast<float*>(dD_p), Bsz, S, di, chunk,
      (S + chunk - 1) / chunk);
  return cudaGetLastError();
}

// K5 takes a chunk of 1..K5_CH steps (cudaErrorInvalidValue otherwise); its 16-byte
// copies need di * sizeof(T) a multiple of 16 and 16-byte aligned pointers.
template <typename T, int N>
cudaError_t launch_bwd(const void* u, const void* dt, const void* Bm, const void* Cm,
                       const void* A, const void* D, const void* h_init, const void* dy,
                       void* du, void* ddt, void* dB_p, void* dC_p, void* dA_p, void* dD_p,
                       int Bsz, int S, int di, int chunk, cudaStream_t stream) {
  if (chunk < 1 || chunk > K5_CH) return cudaErrorInvalidValue;
  const bool vec = (di * sizeof(T)) % 16 == 0 &&
                   (((size_t)u | (size_t)dt | (size_t)dy | (size_t)Bm | (size_t)Cm |
                     (size_t)h_init) % 16) == 0;
  return (vec ? launch_bwd_as<T, N, true> : launch_bwd_as<T, N, false>)(
      u, dt, Bm, Cm, A, D, h_init, dy, du, ddt, dB_p, dC_p, dA_p, dD_p, Bsz, S, di, chunk,
      stream);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers, `stream` is a
// cudaStream_t; `bf16` selects bf16 (1) or fp32 (0) u/dt/B_t/C_t/y/dy; N is 16.
// Each function returns the cudaError_t of its launch (0 on success).
#define MAMBA_DISPATCH(CALL)                                                \
  if (bf16) return (int)CALL(__nv_bfloat16, 16);                            \
  return (int)CALL(float, 16);

extern "C" {

int mamba_fwd(const void* u, const void* dt, const void* Bm, const void* Cm, const void* A,
              const void* D, void* y, void* h_init, int B, int S, int di, int chunk, int bf16,
              void* stream) {
#define CALL(T, NN) \
  launch_fwd<T, NN>(u, dt, Bm, Cm, A, D, y, h_init, B, S, di, chunk, \
                    static_cast<cudaStream_t>(stream))
  MAMBA_DISPATCH(CALL)
#undef CALL
}

int mamba_bwd(const void* u, const void* dt, const void* Bm, const void* Cm, const void* A,
              const void* D, const void* h_init, const void* dy, void* du, void* ddt,
              void* dB_p, void* dC_p, void* dA_p, void* dD_p, int B, int S, int di, int chunk,
              int bf16, void* stream) {
#define CALL(T, NN)                                                                    \
  launch_bwd<T, NN>(u, dt, Bm, Cm, A, D, h_init, dy, du, ddt, dB_p, dC_p, dA_p, dD_p, \
                    B, S, di, chunk, static_cast<cudaStream_t>(stream))
  MAMBA_DISPATCH(CALL)
#undef CALL
}

}  // extern "C"
