// RWKV-6 WKV recurrence for Hopper (sm_90a): forward (K6) and backward (K7).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/rwkv6_scan.py:
//   K6 fwd_kernel <- _fwd_kernel  (S_t = diag(w_t) S_{t-1} + k_t v_t^T,
//                                  y_t = r_t (S_{t-1} + diag(u) k_t v_t^T); emits y, the
//                                  final state and the chunk-initial states)
//   K7 bwd_kernel <- _bwd_kernel  (reversed-chunk replay from the chunk-initial states, then
//                                  G_{t-1} = diag(w_t) G_t + r_t dy_t^T seeded with the final
//                                  state's cotangent; dr, dk, dv, dw, and du per (b, h))
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
//   K7: two groups of 4*M threads sweep the chunks in reverse in step.  The row group
//       holds G[i][:] (4 threads per row i) and replays S[i][:] of the chunk from its
//       initial state into a shared-memory history, so dw, dk, dr and du of row i are
//       sums inside 4 lanes; the column group holds G[:][j] and needs no history, so dv
//       of column j is a sum inside 4 lanes.  No atomics: every output element has one
//       writer, and du leaves as a per-(b, h) partial summed outside, as the TPU does.
// The chunk (set by the caller) bounds K7's history: chunk x M x (M + 4) fp32 in shared
// memory, 139 KB at chunk 8 and M = 64.  Row stride M + 4 (4 mod 32) puts the 8 rows x
// 4 lanes of a warp on 32 distinct banks; tile elements a thread owns are strided by 4
// (i = q + 4e), so a warp's 4 lanes of one row or column read distinct banks.
//
// Bound on the H100.  Per step and (b, h) the forward does ~3 M^2 fp32 operations on
// O(M) bytes of input, far above the ridge point, so it is bound by operations, on the
// CUDA cores (67 TFLOP/s fp32: the recurrence has no matrix product for the tensor
// cores in this form).  With one block per (b, h) the grid is B*H blocks (128 at
// RWKV6-7B's B = 2, H = 64), one per SM, so this first version uses a fraction of the
// card's warp schedulers; the chunked (matrix) form of the recurrence on the tensor cores
// is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

// K7.  One block per (b, h), 8*M threads: threads [0, 4M) are the row group (thread
// (i, q) owns G[i][q + 4e] and replays S[i][q + 4e]), threads [4M, 8M) the column group
// (thread (j, q) owns G[q + 4e][j]).
template <typename T, int M>
__global__ void __launch_bounds__(2 * Q * M) bwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s_init,
    const T* __restrict__ dy, const float* __restrict__ ds, float* __restrict__ dr,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dw,
    float* __restrict__ du, int H, int S, int chunk, int n_chunks) {
  constexpr int E = M / Q;
  constexpr int HS = M + 4;              // history row stride
  extern __shared__ float smem[];
  float* hist = smem;                    // (chunk, M, HS): hist[t] = S_{t-1} of the chunk
  float* r_s = hist + chunk * M * HS;    // (chunk, M) each
  float* k_s = r_s + chunk * M;
  float* v_s = k_s + chunk * M;
  float* w_s = v_s + chunk * M;
  float* dy_s = w_s + chunk * M;
  float* ruk = dy_s + chunk * M;         // (chunk)
  float* vdy = ruk + chunk;              // (chunk)
  float* u_s = vdy + chunk;              // (M)

  const int bh = blockIdx.x, h = bh % H;
  const bool row = threadIdx.x < Q * M;
  const int lt = row ? threadIdx.x : threadIdx.x - Q * M;
  const int a = lt / Q, q = lt % Q;      // a: row i (row group) or column j (column group)
  const size_t seq = (size_t)bh * S * M;
  if (threadIdx.x < M) u_s[threadIdx.x] = u[h * M + threadIdx.x];

  float g[E];
  const float* dsb = ds + (size_t)bh * M * M;
#pragma unroll
  for (int e = 0; e < E; ++e)
    g[e] = row ? dsb[a * M + q + Q * e] : dsb[(q + Q * e) * M + a];
  float du_acc = 0.f;

  for (int ic = n_chunks - 1; ic >= 0; --ic) {
    const int t0 = ic * chunk;
    __syncthreads();                     // the previous chunk's tiles are consumed
    load_steps(r_s, r + seq, t0, chunk, S, M, 0.f);
    load_steps(k_s, k + seq, t0, chunk, S, M, 0.f);
    load_steps(v_s, v + seq, t0, chunk, S, M, 0.f);
    load_steps(w_s, w + seq, t0, chunk, S, M, 1.f);
    load_steps(dy_s, dy + seq, t0, chunk, S, M, 0.f);
    const float* si = s_init + ((size_t)bh * n_chunks + ic) * M * M;
    for (int idx = threadIdx.x; idx < M * M; idx += blockDim.x)
      hist[(idx / M) * HS + idx % M] = si[idx];
    __syncthreads();
    step_dots(ruk, vdy, r_s, k_s, u_s, v_s, dy_s, chunk, M);
    if (row) {                           // replay row a of the chunk's pre-states
      float s[E];
#pragma unroll
      for (int e = 0; e < E; ++e) s[e] = hist[a * HS + q + Q * e];
      for (int t = 0; t + 1 < chunk; ++t) {
        const float wa = w_s[t * M + a], ka = k_s[t * M + a];
        float* dst = hist + ((t + 1) * M + a) * HS;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int jj = q + Q * e;
          s[e] = fmaf(wa, s[e], ka * v_s[t * M + jj]);
          dst[jj] = s[e];
        }
      }
    }
    __syncthreads();                     // ruk and vdy are ready
    const float ua = u_s[a];
    for (int t = min(chunk, S - t0) - 1; t >= 0; --t) {
      const size_t o = seq + (size_t)(t0 + t) * M + a;
      if (row) {
        const float ra = r_s[t * M + a], ka = k_s[t * M + a], wa = w_s[t * M + a];
        const float* sp = hist + (t * M + a) * HS;
        float pw = 0.f, pk = 0.f, pr = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int jj = q + Q * e;
          const float dyj = dy_s[t * M + jj];
          pw = fmaf(g[e], sp[jj], pw);
          pk = fmaf(g[e], v_s[t * M + jj], pk);
          pr = fmaf(sp[jj], dyj, pr);
          g[e] = fmaf(wa, g[e], ra * dyj);
        }
        pw = quad_sum(pw);
        pk = quad_sum(pk);
        pr = quad_sum(pr);
        if (q == 0) {
          const float vd = vdy[t];
          dw[o] = pw;
          dk[o] = fmaf(ua * ra, vd, pk);
          dr[o] = fmaf(ua * ka, vd, pr);
          du_acc = fmaf(ra * ka, vd, du_acc);
        }
      } else {
        const float dya = dy_s[t * M + a];
        float pv = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = q + Q * e;
          pv = fmaf(g[e], k_s[t * M + i], pv);
          g[e] = fmaf(w_s[t * M + i], g[e], r_s[t * M + i] * dya);
        }
        pv = quad_sum(pv);
        if (q == 0) dv[o] = fmaf(ruk[t], dya, pv);
      }
    }
  }
  if (row && q == 0) du[(size_t)bh * M + a] = du_acc;
}

size_t fwd_smem(int M) { return sizeof(float) * (4 * TS * M + TS + M); }
size_t bwd_smem(int chunk, int M) {
  return sizeof(float) * (chunk * M * (M + 4) + 5 * chunk * M + 2 * chunk + M);
}

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

template <typename T, int M>
cudaError_t launch_bwd(const void* r, const void* k, const void* v, const void* w,
                       const void* u, const void* s_init, const void* dy, const void* ds,
                       void* dr, void* dk, void* dv, void* dw, void* du, int B, int H, int S,
                       int chunk, cudaStream_t stream) {
  const size_t smem = bwd_smem(chunk, M);
  cudaError_t e = allow_smem(bwd_kernel<T, M>, smem);
  if (e != cudaSuccess) return e;
  const int n_chunks = (S + chunk - 1) / chunk;
  bwd_kernel<T, M><<<B * H, 2 * Q * M, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s_init), static_cast<const T*>(dy),
      static_cast<const float*>(ds), static_cast<float*>(dr), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dw), static_cast<float*>(du), H, S, chunk,
      n_chunks);
  return cudaGetLastError();
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
