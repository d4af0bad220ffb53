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
// Design.  The TPU grid's sequential chunk axis becomes a loop inside one block per
// (batch row, 128 channels); each thread owns one channel and its N = 16 state in
// registers.  B_t and C_t, shared by all channels, and the channels' u, dt (and dy) come
// through shared memory a tile of steps at a time (64 in K4, one chunk in K5).  K5 replays
// a chunk from its initial state into a shared-memory history (chunk x N x 128 fp32,
// 128 KB at chunk 16; [t][n][channel], so a warp reads 32 consecutive words) and walks
// it in reverse.  dB_t and dC_t sum over channels: each warp reduce-scatters its 32
// values per step (16 of dB, 16 of dC) with 31 shuffles, so lane l ends with the warp's
// sum of value l; the 4 warps' sums are added in a fixed order at the end of the chunk
// and written as the channel block's partial.  dA and dD accumulate in registers over
// the sequence and leave as per-row partials.  No atomics: the sums run in a fixed order,
// so the gradients are the same from run to run.
//
// Bound on the H100.  Per step and channel the forward does ~6 N fp32 operations and N
// exponentials on ~8 bytes of input, so it is bound by operations, on the CUDA cores
// (67 TFLOP/s fp32; the exponentials go to the SFUs at a quarter of that rate).  With
// one thread per channel the grid holds B*di threads (16384 at Jamba's B = 2, di = 8192),
// about four warps per SM, which leaves most warp schedulers idle; splitting the state over
// more threads is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int CB = 128;              // channels per block, one thread each
constexpr int NW = CB / 32;          // warps per block
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

// On return lane l holds the sum over the warp's 32 lanes of v[l] (v is clobbered).
__device__ __forceinline__ float reduce_scatter32(float (&v)[32]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int level = 0; level < 5; ++level) {
    const int half = 16 >> level;
    const bool upper = lane & half;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, half);
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

// K5.  Grid (channel blocks, B); thread = channel.
template <typename T, int N>
__global__ void __launch_bounds__(CB) bwd_kernel(
    const T* __restrict__ u, const T* __restrict__ dt, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ A, const float* __restrict__ D,
    const float* __restrict__ h_init, const T* __restrict__ dy, float* __restrict__ du,
    float* __restrict__ ddt, float* __restrict__ dB_p, float* __restrict__ dC_p,
    float* __restrict__ dA_p, float* __restrict__ dD_p, int Bsz, int S, int di, int chunk,
    int n_chunks) {
  static_assert(2 * N == 32, "the warp reduce-scatter takes the 2N = 32 values of a step");
  extern __shared__ float smem[];
  float* hist = smem;                    // (chunk, N, CB): hist[t] = h_{t-1} of the chunk
  float* u_s = hist + chunk * N * CB;    // (chunk, CB) each
  float* dt_s = u_s + chunk * CB;
  float* dy_s = dt_s + chunk * CB;
  float* b_s = dy_s + chunk * CB;        // (chunk, N) each
  float* c_s = b_s + chunk * N;
  float* red = c_s + chunk * N;          // (chunk, NW, 32) warp sums of dB|dC

  const int b = blockIdx.y, cblk = blockIdx.x, c0 = cblk * CB, c = c0 + threadIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool live = c < di;
  float a[N], g[N], da[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[(size_t)c * N + n] : 0.f;
    g[n] = 0.f;
    da[n] = 0.f;
  }
  const float dd = live ? D[c] : 0.f;
  float dd_acc = 0.f;
  const size_t row = (size_t)b * S;

  for (int ic = n_chunks - 1; ic >= 0; --ic) {
    const int t0 = ic * chunk, steps = min(chunk, S - t0);
    __syncthreads();                     // the previous chunk's tiles are consumed
    load_channels(u_s, u + row * di, t0, steps, chunk, c0, di);
    load_channels(dt_s, dt + row * di, t0, steps, chunk, c0, di);
    load_channels(dy_s, dy + row * di, t0, steps, chunk, c0, di);
    load_state_rows<T, N>(b_s, Bm + row * N, t0, steps, chunk);
    load_state_rows<T, N>(c_s, Cm + row * N, t0, steps, chunk);
    float hh[N];
    if (live) {
      const float4* hi = reinterpret_cast<const float4*>(
          h_init + (((size_t)b * n_chunks + ic) * di + c) * N);
#pragma unroll
      for (int n = 0; n < N; n += 4) {
        const float4 f = hi[n / 4];
        hh[n] = f.x; hh[n + 1] = f.y; hh[n + 2] = f.z; hh[n + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) hh[n] = 0.f;
    }
    __syncthreads();
    // replay: hist[t] = the pre-state of step t0 + t (the thread's own column of hist)
    for (int t = 0; t < steps; ++t) {
      const float dtt = dt_s[t * CB + threadIdx.x];
      const float x = dtt * u_s[t * CB + threadIdx.x];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        hist[(t * N + n) * CB + threadIdx.x] = hh[n];
        hh[n] = fmaf(hh[n], expf(dtt * a[n]), x * b_s[t * N + n]);
      }
    }
    // adjoint, steps in reverse
    for (int t = steps - 1; t >= 0; --t) {
      const float ut = u_s[t * CB + threadIdx.x], dtt = dt_s[t * CB + threadIdx.x];
      const float dyt = dy_s[t * CB + threadIdx.x];
      const float x = dtt * ut;
      float v[2 * N];
      float dx = 0.f, gha = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float hp = hist[(t * N + n) * CB + threadIdx.x];
        const float dec = expf(dtt * a[n]);
        const float bn = b_s[t * N + n];
        const float ht = fmaf(hp, dec, x * bn);
        const float gt = fmaf(dyt, c_s[t * N + n], g[n]);   // dL/dh_t
        v[n] = gt * x;                                      // dB_t[n], this channel
        v[N + n] = dyt * ht;                                // dC_t[n], this channel
        const float gh = gt * hp * dec;
        dx = fmaf(gt, bn, dx);
        gha = fmaf(gh, a[n], gha);
        da[n] = fmaf(gh, dtt, da[n]);
        g[n] = gt * dec;
      }
      if (live) {
        const size_t o = (row + t0 + t) * di + c;
        ddt[o] = fmaf(dx, ut, gha);
        du[o] = fmaf(dx, dtt, dd * dyt);
      }
      dd_acc = fmaf(dyt, ut, dd_acc);
      red[(t * NW + warp) * 32 + lane] = reduce_scatter32(v);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < steps * 32; idx += CB) {
      const int t = idx / 32, l = idx % 32;
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) s += red[(t * NW + wi) * 32 + l];
      float* out = l < N ? dB_p : dC_p;
      out[(((size_t)cblk * Bsz + b) * S + t0 + t) * N + l % N] = s;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) dA_p[((size_t)b * di + c) * N + n] = da[n];
    dD_p[(size_t)b * di + c] = dd_acc;
  }
}

size_t fwd_smem(int N) { return sizeof(float) * (2 * TS * CB + 2 * TS * N); }
size_t bwd_smem(int chunk, int N) {
  return sizeof(float) * (chunk * N * CB + 3 * chunk * CB + 2 * chunk * N + chunk * CB);
}

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

template <typename T, int N>
cudaError_t launch_bwd(const void* u, const void* dt, const void* Bm, const void* Cm,
                       const void* A, const void* D, const void* h_init, const void* dy,
                       void* du, void* ddt, void* dB_p, void* dC_p, void* dA_p, void* dD_p,
                       int Bsz, int S, int di, int chunk, cudaStream_t stream) {
  const size_t smem = bwd_smem(chunk, N);
  cudaError_t e = allow_smem(bwd_kernel<T, N>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((di + CB - 1) / CB, Bsz);
  bwd_kernel<T, N><<<grid, CB, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(h_init), static_cast<const T*>(dy), static_cast<float*>(du),
      static_cast<float*>(ddt), static_cast<float*>(dB_p), static_cast<float*>(dC_p),
      static_cast<float*>(dA_p), static_cast<float*>(dD_p), Bsz, S, di, chunk,
      (S + chunk - 1) / chunk);
  return cudaGetLastError();
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
