// Packed flash attention for Hopper (sm_90a): forward (K1), dq (K2), dk/dv (K3).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/packed_flash_attention.py:
//   K1 fwd_kernel     <- _fwd_kernel     (online-softmax GQA forward, emits o and lse)
//   K2 bwd_dq_kernel  <- _bwd_dq_kernel  (dq = sum_j ds_ij k_j)
//   K3 bwd_dkv_kernel <- _bwd_dkv_kernel (dk_j = sum_i ds_ij^T q_i, dv_j = sum_i p_ij^T do_i,
//                                        summed over the G query heads of a kv head)
//
// Semantics are the TPU kernels': q (B, KH, G, Sq, D), k and v (B, KH, Sk, D), all
// contiguous, in bf16 or fp32; segment ids (B, S) int32.  The mask is
// causal AND (qpos - kpos < window when window > 0) AND seg_q == seg_k.
// Scores, running max / sum, accumulators and gradients are fp32; masked scores
// hold the fp32 sentinel -1e30 and p is zeroed by an explicit mask select, so a
// row masked everywhere yields o = 0 and lse = -1e30 (never an average of v).
// The ragged edge (S not a multiple of the tile) is masked here instead of padded:
// rows and keys past S are loaded as zeros and never attend, which equals the
// pad-to-block semantics of kernels/blocking.py (seg -1, padded rows sliced off).
//
// Design.  The TPU grid's sequential kv axis becomes a loop inside one block:
//   K1, K2: one block per (b, query head, 64-row q tile), looping over 64-key tiles;
//   K3:     one block per (b, kv head, 64-key tile), looping over the G query heads
//           and the q tiles, so the G-reduction stays inside the block, no atomics.
// Causal and window masks bound the tile loops, so fully masked tiles are skipped
// (exact: a fully masked tile leaves m, l and acc unchanged).  Delta = rowsum(do*o)
// is computed outside the kernel, as the TPU wrapper does.
//
// Bound on the H100.  At the main path's shapes (S = 1280..4096, D = 64..128) the
// work is ~S^2 D FLOPs over ~S D bytes, far above the card's ridge of ~295 FLOP per
// byte, so the bound is the tensor cores' 989 TFLOP/s (bf16).  This first version
// does its products as fp32 FMAs on the CUDA cores from shared-memory tiles
// (16x16 threads, each owning a strided 4x4 (or 4xD/16) register micro-tile, bank
// conflicts avoided by row padding), so it cannot approach that bound; moving the
// products onto wgmma with TMA-fed tiles is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;        // q rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block, 16 x 16
constexpr int PS = BK + 16;   // row stride of p / ds tiles: two half-warps hit disjoint banks
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + 64) of a row-major (S, D) matrix into shared memory with row
// stride D + 1, as fp32; rows past S are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int S) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < S ? to_f(src[(size_t)row * D + c]) : 0.f;
  }
}

// 64 int32 values starting at i0, -1 past n.
__device__ __forceinline__ void load_ids(int* dst, const int* src, int i0, int n) {
  if (threadIdx.x < 64) {
    const int i = i0 + threadIdx.x;
    dst[threadIdx.x] = i < n ? src[i] : -1;
  }
}

// 64 fp32 values starting at i0, 0 past n.
__device__ __forceinline__ void load_row_f32(float* dst, const float* src, int i0, int n) {
  if (threadIdx.x < 64) {
    const int i = i0 + threadIdx.x;
    dst[threadIdx.x] = i < n ? src[i] : 0.f;
  }
}

__device__ __forceinline__ bool attend(int qp, int kp, int sq, int sk, int Sq, int Sk,
                                       int causal, int window) {
  bool ok = qp < Sq && kp < Sk && sq == sk;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && qp - kp < window;
  return ok;
}

// Reductions over the 16 lanes of a half-warp (the 16 threads sharing one ty).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Key tiles [begin, end) that a q tile starting at q0 can attend.
__device__ __forceinline__ void key_tile_range(int q0, int Sq, int Sk, int causal, int window,
                                               int* begin, int* end) {
  int e = (Sk + BK - 1) / BK;
  if (causal) e = min(e, (min(q0 + BQ, Sq) - 1) / BK + 1);
  int b = 0;
  if (window > 0 && q0 - window + 1 > 0) b = (q0 - window + 1) / BK;
  *begin = b;
  *end = e;
}

// Q tiles [begin, end) that can attend a key tile starting at k0.
__device__ __forceinline__ void query_tile_range(int k0, int Sq, int Sk, int causal, int window,
                                                 int* begin, int* end) {
  int e = (Sq + BQ - 1) / BQ;
  if (window > 0) {
    const int last_q = min(k0 + BK, Sk) - 1 + window - 1;   // qp - kp < window
    e = min(e, last_q / BQ + 1);
  }
  *begin = causal ? k0 / BQ : 0;
  *end = e;
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * 64 * (D + 1) + BQ * PS) + sizeof(int) * (BQ + BK);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + BQ * PS + 2 * BQ) + sizeof(int) * (BQ + BK);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BK * PS + 2 * BQ) + sizeof(int) * (BQ + BK);
}

// --------------------------------------------------------------------------- //
// K1: forward.  grid (n q tiles, B * H), H = KH * G.
// --------------------------------------------------------------------------- //
template <typename T, int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ seg_q, const int* __restrict__ seg_k,
           T* __restrict__ o, float* __restrict__ lse,
           int H, int G, int Sq, int Sk, int causal, int window, float scale) {
  constexpr int DS = D + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DS;
  float* sV = sK + BK * DS;
  float* sP = sV + BK * DS;
  int* sSq = reinterpret_cast<int*>(sP + BQ * PS);
  int* sSk = sSq + BQ;

  const int nq = (Sq + BQ - 1) / BQ;
  const int iq = nq - 1 - blockIdx.x;       // longest causal rows first
  const int bh = blockIdx.y;                // b * H + h
  const int b = bh / H;
  const int bkv = bh / G;                   // b * KH + h / G
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = iq * BQ;

  const T* kb = k + (size_t)bkv * Sk * D;
  const T* vb = v + (size_t)bkv * Sk * D;
  load_tile<T, D>(sQ, q + (size_t)bh * Sq * D, q0, Sq);
  load_ids(sSq, seg_q + (size_t)b * Sq, q0, Sq);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  int kt_begin, kt_end;
  key_tile_range(q0, Sq, Sk, causal, window, &kt_begin, &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                        // previous tile's sK, sV, sP are consumed
    load_tile<T, D>(sK, kb, k0, Sk);
    load_tile<T, D>(sV, vb, k0, Sk);
    load_ids(sSk, seg_k + (size_t)b * Sk, k0, Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * DS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = sK[(tx + 16 * j) * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qa[i] * ka[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      bool mk[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        mk[j] = attend(q0 + r, k0 + c, sSq[r], sSk[c], Sq, Sk, causal, window);
        s[i][j] = mk[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = mk[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[r * PS + tx + 16 * j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sP[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = sV[c * DS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pa[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const bool live = l[i] > 0.f;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * Sq + qp) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[tx + 16 * j] = from_f<T>(live ? acc[i][j] / den : 0.f);
    if (tx == 0) lse[(size_t)bh * Sq + qp] = live ? m[i] + logf(den) : NEG_INF;
  }
}

// --------------------------------------------------------------------------- //
// K2: dq.  grid (n q tiles, B * H); loops over key tiles.
// --------------------------------------------------------------------------- //
template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ seg_q, const int* __restrict__ seg_k,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq,
              int H, int G, int Sq, int Sk, int causal, int window, float scale) {
  constexpr int DS = D + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BQ * DS;
  float* sK = sDO + BQ * DS;
  float* sV = sK + BK * DS;
  float* sDS = sV + BK * DS;
  float* sLse = sDS + BQ * PS;
  float* sDelta = sLse + BQ;
  int* sSq = reinterpret_cast<int*>(sDelta + BQ);
  int* sSk = sSq + BQ;

  const int nq = (Sq + BQ - 1) / BQ;
  const int iq = nq - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int bkv = bh / G;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = iq * BQ;

  const T* kb = k + (size_t)bkv * Sk * D;
  const T* vb = v + (size_t)bkv * Sk * D;
  load_tile<T, D>(sQ, q + (size_t)bh * Sq * D, q0, Sq);
  load_tile<T, D>(sDO, dout + (size_t)bh * Sq * D, q0, Sq);
  load_row_f32(sLse, lse + (size_t)bh * Sq, q0, Sq);
  load_row_f32(sDelta, delta + (size_t)bh * Sq, q0, Sq);
  load_ids(sSq, seg_q + (size_t)b * Sq, q0, Sq);

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  int kt_begin, kt_end;
  key_tile_range(q0, Sq, Sk, causal, window, &kt_begin, &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, D>(sK, kb, k0, Sk);
    load_tile<T, D>(sV, vb, k0, Sk);
    load_ids(sSk, seg_k + (size_t)b * Sk, k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], ka[4], va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = sQ[(ty + 16 * i) * DS + d];
        oa[i] = sDO[(ty + 16 * i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = sK[(tx + 16 * j) * DS + d];
        va[j] = sV[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qa[i] * ka[j];
          dp[i][j] += oa[i] * va[j];
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool mk = attend(q0 + r, k0 + c, sSq[r], sSk[c], Sq, Sk, causal, window);
        const float p = mk ? expf(s[i][j] * scale - sLse[r]) : 0.f;
        sDS[r * PS + c] = p * (dp[i][j] - sDelta[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = sDS[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float kk = sK[c * DS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += da[i] * kk;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    T* row = dq + ((size_t)bh * Sq + qp) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// --------------------------------------------------------------------------- //
// K3: dk, dv.  grid (n key tiles, B * KH); loops over the G heads and q tiles.
// --------------------------------------------------------------------------- //
template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ seg_q, const int* __restrict__ seg_k,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
               int KH, int G, int Sq, int Sk, int causal, int window, float scale) {
  constexpr int DS = D + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * DS;
  float* sQ = sV + BK * DS;
  float* sDO = sQ + BQ * DS;
  float* sPT = sDO + BQ * DS;               // p transposed: [key][query]
  float* sDST = sPT + BK * PS;              // ds transposed
  float* sLse = sDST + BK * PS;
  float* sDelta = sLse + BQ;
  int* sSq = reinterpret_cast<int*>(sDelta + BQ);
  int* sSk = sSq + BQ;

  const int ik = blockIdx.x;
  const int bkv = blockIdx.y;               // b * KH + kh
  const int b = bkv / KH;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = ik * BK;

  load_tile<T, D>(sK, k + (size_t)bkv * Sk * D, k0, Sk);
  load_tile<T, D>(sV, v + (size_t)bkv * Sk * D, k0, Sk);
  load_ids(sSk, seg_k + (size_t)b * Sk, k0, Sk);

  float gk[4][DPT], gv[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) gk[i][j] = gv[i][j] = 0.f;

  int qt_begin, qt_end;
  query_tile_range(k0, Sq, Sk, causal, window, &qt_begin, &qt_end);
  for (int g = 0; g < G; ++g) {
    const size_t bh = (size_t)bkv * G + g;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_tile<T, D>(sQ, q + bh * Sq * D, q0, Sq);
      load_tile<T, D>(sDO, dout + bh * Sq * D, q0, Sq);
      load_row_f32(sLse, lse + bh * Sq, q0, Sq);
      load_row_f32(sDelta, delta + bh * Sq, q0, Sq);
      load_ids(sSq, seg_q + (size_t)b * Sq, q0, Sq);
      __syncthreads();

      // s[i][j] = k_c . q_r and dp[i][j] = v_c . do_r with c = ty + 16 i, r = tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float ka[4], va[4], qa[4], oa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = sK[(ty + 16 * i) * DS + d];
          va[i] = sV[(ty + 16 * i) * DS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qa[j] = sQ[(tx + 16 * j) * DS + d];
          oa[j] = sDO[(tx + 16 * j) * DS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] += ka[i] * qa[j];
            dp[i][j] += va[i] * oa[j];
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const bool mk = attend(q0 + r, k0 + c, sSq[r], sSk[c], Sq, Sk, causal, window);
          const float p = mk ? expf(s[i][j] * scale - sLse[r]) : 0.f;
          sPT[c * PS + r] = p;
          sDST[c * PS + r] = p * (dp[i][j] - sDelta[r]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pa[4], da[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = sPT[(ty + 16 * i) * PS + r];
          da[i] = sDST[(ty + 16 * i) * PS + r];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const float oo = sDO[r * DS + tx + 16 * j];
          const float qq = sQ[r * DS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            gv[i][j] += pa[i] * oo;
            gk[i][j] += da[i] * qq;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= Sk) continue;
    T* krow = dk + ((size_t)bkv * Sk + kp) * D;
    T* vrow = dv + ((size_t)bkv * Sk + kp) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      krow[tx + 16 * j] = from_f<T>(gk[i][j]);
      vrow[tx + 16 * j] = from_f<T>(gv[i][j]);
    }
  }
}

// D^-0.5 rounded to fp32, as the TPU wrapper's `D ** -0.5` is.
float softmax_scale(int D) { return (float)(1.0 / sqrt((double)D)); }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* seg_q,
                       const int* seg_k, void* o, float* lse, int B, int KH, int G, int Sq,
                       int Sk, int causal, int window, cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  cudaError_t e = allow_smem(fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, B * KH * G);
  fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg_q, seg_k,
      static_cast<T*>(o), lse, KH * G, G, Sq, Sk, causal, window, softmax_scale(D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const int* seg_q,
                      const int* seg_k, const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int KH, int G, int Sq, int Sk, int causal, int window,
                      cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
  cudaError_t e = allow_smem(bwd_dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, B * KH * G);
  bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg_q, seg_k,
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), KH * G, G, Sq, Sk, causal,
      window, softmax_scale(D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const int* seg_q,
                       const int* seg_k, const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int KH, int G, int Sq, int Sk, int causal,
                       int window, cudaStream_t stream) {
  const size_t smem = dkv_smem<D>();
  cudaError_t e = allow_smem(bwd_dkv_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sk + BK - 1) / BK, B * KH);
  bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg_q, seg_k,
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), KH, G,
      Sq, Sk, causal, window, softmax_scale(D));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers, `stream` is
// a cudaStream_t; `bf16` selects bf16 (1) or fp32 (0) q/k/v/o; D must be 64 or 128.
// Each function returns the cudaError_t of its launch (0 on success).
#define PFA_DISPATCH(CALL)                                                  \
  if (bf16 && D == 64) return (int)CALL(__nv_bfloat16, 64);                 \
  if (bf16 && D == 128) return (int)CALL(__nv_bfloat16, 128);               \
  if (!bf16 && D == 64) return (int)CALL(float, 64);                        \
  if (!bf16 && D == 128) return (int)CALL(float, 128);                      \
  return (int)cudaErrorInvalidValue;

extern "C" {

int pfa_fwd(const void* q, const void* k, const void* v, const void* seg_q, const void* seg_k,
            void* o, void* lse, int B, int KH, int G, int Sq, int Sk, int D, int causal,
            int window, int bf16, void* stream) {
#define CALL(T, DD)                                                                        \
  launch_fwd<T, DD>(q, k, v, static_cast<const int*>(seg_q), static_cast<const int*>(seg_k), \
                    o, static_cast<float*>(lse), B, KH, G, Sq, Sk, causal, window,         \
                    static_cast<cudaStream_t>(stream))
  PFA_DISPATCH(CALL)
#undef CALL
}

int pfa_bwd_dq(const void* q, const void* k, const void* v, const void* seg_q,
               const void* seg_k, const void* dout, const void* lse, const void* delta,
               void* dq, int B, int KH, int G, int Sq, int Sk, int D, int causal, int window,
               int bf16, void* stream) {
#define CALL(T, DD)                                                                       \
  launch_dq<T, DD>(q, k, v, static_cast<const int*>(seg_q), static_cast<const int*>(seg_k), \
                   dout, static_cast<const float*>(lse), static_cast<const float*>(delta),  \
                   dq, B, KH, G, Sq, Sk, causal, window, static_cast<cudaStream_t>(stream))
  PFA_DISPATCH(CALL)
#undef CALL
}

int pfa_bwd_dkv(const void* q, const void* k, const void* v, const void* seg_q,
                const void* seg_k, const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int B, int KH, int G, int Sq, int Sk, int D, int causal,
                int window, int bf16, void* stream) {
#define CALL(T, DD)                                                                        \
  launch_dkv<T, DD>(q, k, v, static_cast<const int*>(seg_q), static_cast<const int*>(seg_k), \
                    dout, static_cast<const float*>(lse), static_cast<const float*>(delta),  \
                    dk, dv, B, KH, G, Sq, Sk, causal, window,                                \
                    static_cast<cudaStream_t>(stream))
  PFA_DISPATCH(CALL)
#undef CALL
}

}  // extern "C"
