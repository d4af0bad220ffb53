// Packed flash attention for Hopper (sm_90a): forward (K1), dq (K2), dk/dv (K3).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/packed_flash_attention.py:
//   K1 fwd_tc_kernel, fwd_kernel        <- _fwd_kernel     (online-softmax GQA forward, o and lse)
//   K2 bwd_dq_tc_kernel, bwd_dq_kernel  <- _bwd_dq_kernel  (dq = sum_j ds_ij k_j)
//   K3 bwd_dkv_tc_kernel, bwd_dkv_kernel <- _bwd_dkv_kernel (dk_j = sum_i ds_ij^T q_i,
//                                        dv_j = sum_i p_ij^T do_i, summed over the G query
//                                        heads of a kv head)
//
// Semantics are the TPU kernels': q (B, KH, G, Sq, hd), k and v (B, KH, Sk, hd), all
// contiguous, in bf16 or fp32; segment ids (B, S) int32.  The mask is
// causal AND (qpos - kpos < window when window > 0) AND seg_q == seg_k.
// Scores, running max / sum, accumulators and gradients are fp32; masked scores
// hold the fp32 sentinel -1e30 and p is zeroed by an explicit mask select, so a
// row masked everywhere yields o = 0 and lse = -1e30 (never an average of v) and
// gradients of exactly 0.  The ragged edge (S not a multiple of the tile) is masked
// here instead of padded: rows and keys past S are loaded as zeros and never attend,
// which equals the pad-to-block semantics of kernels/blocking.py (seg -1, padded rows
// sliced off).  Delta = rowsum(do * o) is computed outside the kernels, as the TPU
// wrapper does.  No kernel uses atomics: every output element is written once, by one
// block, so the results are bitwise deterministic.
//
// Head dims.  Each kernel is instantiated at a tile width D of 64, 128 or 256 and takes
// the head dim hd (a multiple of 8, at most D; the dispatch takes the narrowest D) as an
// argument: hd is the global row stride, the columns [hd, D) of every tile are loaded
// as zeros, and only the columns < hd of o, dq, dk and dv are stored.  Zero columns
// add nothing to S = Q K^T or dP = dO V^T and give zero columns of the outputs, so
// nothing is padded or copied in device memory; the launchers take the softmax scale
// from hd, never from D.  D 72 and 80 thus run at the cost of D 128, D 24 and 32 at
// that of D 64.
// At D 256 one warpgroup cannot hold both 64 x 256 fp32 accumulators of K3 (256
// registers a thread), so K3 runs as two blocks per key tile, one for dk and one for
// dv, each recomputing S (and dP for dk); the fp32 K2 and K3 at D 256 stream their
// tiles through fewer shared-memory buffers (see bwd_dq_kernel, dkv_body).
//
// Bound on the H100.  At the shapes the smoke times (S = 1226..4096, D = 64..256) the
// work is ~S^2 D operations over ~S D bytes, far above the card's ridge of ~295
// operations per byte, so every kernel here is bound by the tensor cores' 989 TFLOP/s
// (bf16) over the (q, k) pairs the mask keeps.
//
// In bf16 (the main path's type) all three run on the tensor cores.  One warpgroup
// (128 threads) per block; 64 x 64 tiles held in shared memory in wgmma's
// 128-byte-swizzled layout, streamed through a double-buffered cp.async ring.
//   K1: one block per (b, query head, 64-row q tile).  It holds the Q tile and streams
//       K and V; per key tile S = Q K^T is wgmma m64n64k16 with both operands in shared
//       memory (K-major); the online softmax runs in fp32 registers (row max and sum
//       over the 4 lanes of a row by shuffles, O rescaled by 2^(m_prev - m_new)); p is
//       summed into l in fp32, rounded to bf16 and fed as register A fragments to
//       O += P V (V in shared memory read MN-major, so no transpose).  K1 is bound by
//       the instructions of the softmax more than by its products, so a tile costs as
//       few as it can: the scale and log2(e) fold into one FMA before ex2.approx.ftz;
//       a warp whose 64 x 64 elements all attend skips the mask selects; a tile whose
//       rows and keys each hold one segment gets its mask from 4 id ranges per side
//       (min and max of each 32 ids, reduced as the ids load) instead of 32 compares
//       a thread; O is not rescaled when no row max of the warp moved.  Shared memory
//       42,800 B (D 64) / 83,760 B (D 128) a block; with 122 / 172 registers an SM
//       holds 4 / 2 blocks.
//   K2: one block per (b, kv head, 64-row q tile).  For each of the G query heads it
//       holds the Q and dO tiles and streams K and V tiles; per key tile S = Q K^T and
//       dP = dO V^T are wgmma with both operands in shared memory (K-major),
//       p = exp(S scale - lse) and ds = p (dP - delta) scale are formed in fp32
//       registers, rounded to bf16 and fed as register A fragments to dQ += dS K (K
//       read MN-major).
//   K3: one block per (b, kv head, 64-key tile).  It holds K and V and streams Q, dO,
//       lse and delta through the ring over the G heads and the q tiles the causal and
//       window bounds allow, in the transposed form S^T = K Q^T, dP^T = V dO^T: P^T and
//       dS^T are then register A operands of dV += P^T dO and dK += dS^T Q.  dk and dv
//       stay in registers over all heads and tiles and are written once.
//   Tiles are skipped by the causal and window bounds and, after their segment ids are
//   loaded, by a block-wide vote when no (q, k) pair of the tile attends (exact: such
//   a tile adds 0), which drops the pairs that packed rows and padded tails never use.
//   A tile wholly in range, below the diagonal and inside the window takes its mask
//   from the segment ids alone.  One barrier a tile: the next tile's copies are issued
//   right after it, into the stage every thread has finished with.
//   p and ds are rounded to bf16 before the second products, as FlashAttention does;
//   the first products take the stored bf16 operands with fp32 accumulation.
//   What the design leaves on the table: the kernels are bound by the instructions
//   around the products (mask, exponentials, barriers) more than by the products.  One
//   warpgroup does its own loads (no producer warp, no TMA) and waits for each product
//   before the softmax step, so overlap comes only from the blocks an SM holds.  Later
//   steps: a TMA producer warp, two consumer warpgroups sharing K and V (the G heads
//   of a kv head in K1, or two q tiles), 128-key tiles.
//
// In fp32, K1-K3 are the first versions: fp32 FMAs on the CUDA cores from
// shared-memory tiles (16x16 threads, each owning a strided 4x4 (or 4xD/16) register
// micro-tile, bank conflicts avoided by row padding).  fp32 stays off the tensor cores
// on purpose: TF32 would break the fp32 tolerance of 1e-4.
#include <stdint.h>
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

// Rows [row0, row0 + 64) of a row-major (S, hd) matrix into shared memory with row
// stride D + 1, as fp32; rows past S and columns past hd are zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int S,
                                          int hd) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < S && c < hd ? src[(size_t)row * hd + c] : 0.f;
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

constexpr size_t SMEM_MAX = 232448;       // dynamic shared memory of one block (H100)

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * 64 * (D + 1) + BQ * PS) + sizeof(int) * (BQ + BK);
}
// K2 holds the Q, dO, K and V tiles; where four do not fit (D 256), K and V take
// turns in one buffer.
template <int D>
__host__ __device__ constexpr int dq_tiles() {
  return sizeof(float) * (4 * 64 * (D + 1) + BQ * PS + 2 * BQ) + sizeof(int) * (BQ + BK) <=
                 SMEM_MAX
             ? 4
             : 3;
}
template <int D>
__host__ __device__ constexpr size_t dq_smem() {
  return sizeof(float) * (dq_tiles<D>() * 64 * (D + 1) + BQ * PS + 2 * BQ) +
         sizeof(int) * (BQ + BK);
}
// K3's blocks compute dk and dv (PART 3: K, V, Q and dO tiles, P^T and dS^T), dk alone
// (PART 1: K, V and one buffer that takes dO, then Q; dS^T) or dv alone (PART 2: K, Q,
// dO; P^T).  Where PART 3 does not fit (D 256), each key tile takes a PART 1 block and
// a PART 2 block.
template <int D, int PART>
__host__ __device__ constexpr size_t dkv_smem() {
  return sizeof(float) * ((PART == 3 ? 4 : 3) * 64 * (D + 1) +
                          ((PART & 1) + (PART >> 1)) * BK * PS + 2 * BQ) +
         sizeof(int) * (BQ + BK);
}
template <int D>
__host__ __device__ constexpr bool dkv_split() { return dkv_smem<D, 3>() > SMEM_MAX; }
static_assert(fwd_smem<256>() <= SMEM_MAX && dq_smem<256>() <= SMEM_MAX &&
                  dkv_smem<256, 1>() <= SMEM_MAX && dkv_smem<256, 2>() <= SMEM_MAX &&
                  !dkv_split<128>(),
              "shared memory of one block");

// acc[i][j] += (row ty + 16 i of a) . (row tx + 16 j of b) over the D columns of two
// tiles of row stride D + 1.
template <int D>
__device__ __forceinline__ void tile_dots(float (&acc)[4][4], const float* a, const float* b,
                                          int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = a[(ty + 16 * i) * (D + 1) + d];
      y[i] = b[(tx + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += x[i] * y[j];
  }
}

// --------------------------------------------------------------------------- //
// K1 (fp32): forward.  grid (n q tiles, B * H), H = KH * G.
// --------------------------------------------------------------------------- //
template <int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const int* __restrict__ seg_q,
           const int* __restrict__ seg_k,
           float* __restrict__ o, float* __restrict__ lse,
           int H, int G, int Sq, int Sk, int hd, int causal, int window, float scale) {
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

  const float* kb = k + (size_t)bkv * Sk * hd;
  const float* vb = v + (size_t)bkv * Sk * hd;
  load_tile<D>(sQ, q + (size_t)bh * Sq * hd, q0, Sq, hd);
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
    load_tile<D>(sK, kb, k0, Sk, hd);
    load_tile<D>(sV, vb, k0, Sk, hd);
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
    float* orow = o + ((size_t)bh * Sq + qp) * hd;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (tx + 16 * j < hd) orow[tx + 16 * j] = live ? acc[i][j] / den : 0.f;
    if (tx == 0) lse[(size_t)bh * Sq + qp] = live ? m[i] + logf(den) : NEG_INF;
  }
}

// --------------------------------------------------------------------------- //
// K2 (fp32): dq.  grid (n q tiles, B * H); loops over key tiles.
// --------------------------------------------------------------------------- //
template <int D>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ seg_q,
              const int* __restrict__ seg_k,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq,
              int H, int G, int Sq, int Sk, int hd, int causal, int window, float scale) {
  constexpr int DS = D + 1;
  constexpr int DPT = D / 16;
  constexpr bool KV_TURNS = dq_tiles<D>() == 3;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BQ * DS;
  float* sK = sDO + BQ * DS;
  float* sV = KV_TURNS ? sK : sK + BK * DS;
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

  const float* kb = k + (size_t)bkv * Sk * hd;
  const float* vb = v + (size_t)bkv * Sk * hd;
  load_tile<D>(sQ, q + (size_t)bh * Sq * hd, q0, Sq, hd);
  load_tile<D>(sDO, dout + (size_t)bh * Sq * hd, q0, Sq, hd);
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
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    __syncthreads();
    if constexpr (KV_TURNS) {
      // dP = dO V^T first; then K takes V's buffer for S = Q K^T and dq += dS K
      load_tile<D>(sV, vb, k0, Sk, hd);
      load_ids(sSk, seg_k + (size_t)b * Sk, k0, Sk);
      __syncthreads();
      tile_dots<D>(dp, sDO, sV, ty, tx);
      __syncthreads();
      load_tile<D>(sK, kb, k0, Sk, hd);
      __syncthreads();
      tile_dots<D>(s, sQ, sK, ty, tx);
    } else {
      load_tile<D>(sK, kb, k0, Sk, hd);
      load_tile<D>(sV, vb, k0, Sk, hd);
      load_ids(sSk, seg_k + (size_t)b * Sk, k0, Sk);
      __syncthreads();
      tile_dots<D>(s, sQ, sK, ty, tx);
      tile_dots<D>(dp, sDO, sV, ty, tx);
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
    float* row = dq + ((size_t)bh * Sq + qp) * hd;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (tx + 16 * j < hd) row[tx + 16 * j] = acc[i][j];
  }
}

// --------------------------------------------------------------------------- //
// K3 (fp32): dk and / or dv (PART, see dkv_smem) of key tile ik of kv head bkv; loops
// over the G heads and q tiles.
// --------------------------------------------------------------------------- //
template <int D, int PART>
__device__ __forceinline__ void dkv_body(
    float* smem, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int ik,
    int bkv, int KH, int G, int Sq, int Sk, int hd, int causal, int window, float scale) {
  constexpr bool DK = PART & 1, DV = PART & 2;
  constexpr int DS = D + 1;
  constexpr int DPT = D / 16;
  float* sK = smem;
  float* sV = sK + BK * DS;                 // dP needs V only for dk
  float* sQ = sV + (DK ? BK * DS : 0);
  float* sDO = PART == 1 ? sQ : sQ + BQ * DS;   // dk alone: dO, then Q, in one buffer
  float* sPT = sDO + BQ * DS;               // p transposed: [key][query]
  float* sDST = sPT + (DV ? BK * PS : 0);   // ds transposed
  float* sLse = sDST + (DK ? BK * PS : 0);
  float* sDelta = sLse + BQ;
  int* sSq = reinterpret_cast<int*>(sDelta + BQ);
  int* sSk = sSq + BQ;

  const int b = bkv / KH;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = ik * BK;

  load_tile<D>(sK, k + (size_t)bkv * Sk * hd, k0, Sk, hd);
  if (DK) load_tile<D>(sV, v + (size_t)bkv * Sk * hd, k0, Sk, hd);
  load_ids(sSk, seg_k + (size_t)b * Sk, k0, Sk);

  float gk[4][DK ? DPT : 1], gv[4][DV ? DPT : 1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < (DK ? DPT : 1); ++j) gk[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < (DV ? DPT : 1); ++j) gv[i][j] = 0.f;
  }

  int qt_begin, qt_end;
  query_tile_range(k0, Sq, Sk, causal, window, &qt_begin, &qt_end);
  for (int g = 0; g < G; ++g) {
    const size_t bh = (size_t)bkv * G + g;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      // s[i][j] = k_c . q_r and dp[i][j] = v_c . do_r with c = ty + 16 i, r = tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      __syncthreads();
      load_row_f32(sLse, lse + bh * Sq, q0, Sq);
      load_row_f32(sDelta, delta + bh * Sq, q0, Sq);
      load_ids(sSq, seg_q + (size_t)b * Sq, q0, Sq);
      if constexpr (PART == 1) {
        // dP^T = V dO^T first; then Q takes dO's buffer for S^T = K Q^T and dk += dS^T Q
        load_tile<D>(sDO, dout + bh * Sq * hd, q0, Sq, hd);
        __syncthreads();
        tile_dots<D>(dp, sV, sDO, ty, tx);
        __syncthreads();
        load_tile<D>(sQ, q + bh * Sq * hd, q0, Sq, hd);
        __syncthreads();
        tile_dots<D>(s, sK, sQ, ty, tx);
      } else if constexpr (PART == 2) {
        load_tile<D>(sQ, q + bh * Sq * hd, q0, Sq, hd);
        load_tile<D>(sDO, dout + bh * Sq * hd, q0, Sq, hd);
        __syncthreads();
        tile_dots<D>(s, sK, sQ, ty, tx);
      } else {
        load_tile<D>(sQ, q + bh * Sq * hd, q0, Sq, hd);
        load_tile<D>(sDO, dout + bh * Sq * hd, q0, Sq, hd);
        __syncthreads();
        tile_dots<D>(s, sK, sQ, ty, tx);
        tile_dots<D>(dp, sV, sDO, ty, tx);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const bool mk = attend(q0 + r, k0 + c, sSq[r], sSk[c], Sq, Sk, causal, window);
          const float p = mk ? expf(s[i][j] * scale - sLse[r]) : 0.f;
          if (DV) sPT[c * PS + r] = p;
          if (DK) sDST[c * PS + r] = p * (dp[i][j] - sDelta[r]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pa[4], da[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (DV) pa[i] = sPT[(ty + 16 * i) * PS + r];
          if (DK) da[i] = sDST[(ty + 16 * i) * PS + r];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          if constexpr (DV) {
            const float oo = sDO[r * DS + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) gv[i][j] += pa[i] * oo;
          }
          if constexpr (DK) {
            const float qq = sQ[r * DS + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) gk[i][j] += da[i] * qq;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= Sk) continue;
    float* krow = dk + ((size_t)bkv * Sk + kp) * hd;
    float* vrow = dv + ((size_t)bkv * Sk + kp) * hd;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      if (tx + 16 * j >= hd) continue;
      if constexpr (DK) krow[tx + 16 * j] = gk[i][j];
      if constexpr (DV) vrow[tx + 16 * j] = gv[i][j];
    }
  }
}

// K3 (fp32): dk, dv.  grid (n key tiles, B * KH, 1), or 2 along z where one block
// cannot hold both (z = 0: dk, z = 1: dv).
template <int D>
__global__ void __launch_bounds__(NT)
bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ seg_q,
               const int* __restrict__ seg_k,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
               int KH, int G, int Sq, int Sk, int hd, int causal, int window, float scale) {
  extern __shared__ float smem[];
#define DKV_ARGS                                                                          \
  smem, q, k, v, seg_q, seg_k, dout, lse, delta, dk, dv, blockIdx.x, blockIdx.y, KH, G, Sq, \
      Sk, hd, causal, window, scale
  if constexpr (!dkv_split<D>())
    dkv_body<D, 3>(DKV_ARGS);
  else if (blockIdx.z == 0)
    dkv_body<D, 1>(DKV_ARGS);
  else
    dkv_body<D, 2>(DKV_ARGS);
#undef DKV_ARGS
}

// --------------------------------------------------------------------------- //
// K2 and K3 for bf16 on the tensor cores: wgmma, one warpgroup (128 threads) a block.
// --------------------------------------------------------------------------- //
constexpr int WG = 128;                   // threads of the tensor-core kernels
constexpr int SW_ROW = 128;               // bytes of one 128-byte-swizzled row: 64 bf16
constexpr int SW_SUB = 64 * SW_ROW;       // one 64-row x 64-column sub-tile
constexpr float LOG2E = 1.4426950408889634f;

// A 64 x D bf16 tile in shared memory is D / 64 sub-tiles of 64 rows x 128 bytes; the
// 16-byte chunk c of row r sits at chunk (c ^ r) % 8 of its row, the 128-byte swizzle
// that wgmma's descriptors name.  The same bytes serve as a K-major operand (rows are M
// or N, columns K) and as an MN-major one (rows are K, columns N), so no tile is ever
// transposed.
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() { return 64 * D * 2; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk c (0 .. D/8 - 1) of row r in a tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * SW_SUB + r * SW_ROW + (((c & 7) ^ (r & 7)) << 4);
}

// Rows [row0, row0 + 64) of a row-major (S, hd) bf16 matrix into the tile at `dst`, by
// 16-byte cp.async copies (8 neighbouring threads read one 128-byte row segment); rows
// past S and the chunks of columns past hd are filled with zeros.
template <int D>
__device__ __forceinline__ void tile_async(uint32_t dst, const __nv_bfloat16* src, int row0,
                                           int S, int hd) {
  constexpr int CPR = D / 8;              // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < 64 * CPR / WG; ++it) {
    const int i = it * WG + threadIdx.x;
    const int r = i / CPR, c = i % CPR;
    const bool in_row = c * 8 < hd;
    const bool ok = row0 + r < S && in_row;
    const __nv_bfloat16* g = src + (size_t)(ok ? row0 + r : 0) * hd + (in_row ? c * 8 : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst + swz(r, c)), "l"(g), "r"(ok ? 16 : 0) : "memory");
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// Orders this thread's generic-proxy writes to shared memory (cp.async, plain stores)
// before the async-proxy reads of wgmma that follow the next barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor with the 128-byte swizzle: start address, LBO, SBO =
// 1024 bytes between 8-row groups.  K-major operands ignore LBO; MN-major ones take it
// as the distance between 64-column sub-tiles.  Tiles are 1024-byte aligned, so the
// base-offset field stays 0.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// K-major operand: columns [16 kk, 16 kk + 16) of a tile, all 64 rows.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * SW_SUB + (kk & 3) * 32, 16);
}
// MN-major operand: rows [16 kk, 16 kk + 16) of a tile, all its columns.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * SW_ROW, SW_SUB);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The compiler sees a wgmma as done when it is issued.  Pinning its accumulators and A
// fragments after the wait keeps their registers from being read or reused before it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D += A B for one k16 slice, D (64 x 64) in fp32 registers, A and B bf16 K-major in
// shared memory; scale_d = 0 overwrites D.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A B for one k16 slice, A (64 x 16) bf16 in registers, B bf16 MN-major in shared
// memory (its transpose flag set); D is 64 x 64 or 64 x 128 fp32 in registers.
__device__ __forceinline__ void mma_rs_tb(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_rs_tb(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// Columns [OFF / 2, OFF / 2 + 128) of D (64 x 256, 128 fp32 a thread) += A B for one
// k16 slice, as mma_rs_tb: one m64n128k16 on the accumulator elements [OFF, OFF + 64).
#define ACC8(o)                                                                           \
  "+f"(d[OFF + o]), "+f"(d[OFF + o + 1]), "+f"(d[OFF + o + 2]), "+f"(d[OFF + o + 3]),     \
      "+f"(d[OFF + o + 4]), "+f"(d[OFF + o + 5]), "+f"(d[OFF + o + 6]), "+f"(d[OFF + o + 7])
template <int OFF>
__device__ __forceinline__ void mma_rs_tb_half(float (&d)[128], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}
#undef ACC8

// D (64 x 256) += A B for one k16 slice as two m64n128k16 products: B's columns
// [0, 128) by descriptor db0, [128, 256) by db1.  The accumulator layout is the
// n = 128 one for each half: 8-column block j of the tile at d[4 j .. 4 j + 3].
__device__ __forceinline__ void mma_rs_tb(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint64_t db0, uint64_t db1, int scale_d) {
  mma_rs_tb_half<0>(d, a0, a1, a2, a3, db0, scale_d);
  mma_rs_tb_half<64>(d, a0, a1, a2, a3, db1, scale_d);
}

// acc (64 x D) += A B for the k16 slice kk: A's fragments a0..a3 in registers, B the
// MN-major tile at `tile` (64 x D).
template <int D>
__device__ __forceinline__ void mma_acc(float (&acc)[D / 2], uint32_t a0, uint32_t a1,
                                        uint32_t a2, uint32_t a3, uint32_t tile, int kk) {
  if constexpr (D <= 128)
    mma_rs_tb(acc, a0, a1, a2, a3, desc_mn(tile, kk), 1);
  else
    mma_rs_tb(acc, a0, a1, a2, a3, desc_mn(tile, kk), desc_mn(tile + 2 * SW_SUB, kk), 1);
}

// Accumulator layout of wgmma m64nNk16 (fp32): thread t = 32 w + l holds, for each
// 8-column block j, d[4j + h] at row 16 w + l / 4 + 8 (h / 2), column 8 j + 2 (l % 4)
// + h % 2.  For a 64 x 64 accumulator the 32 elements of the 128 threads partition the
// tile; bit 4j + h of the result says whether that element attends.  Rows are queries
// and columns keys (ROWS_ARE_Q, K2) or the transpose (K3).
// A tile wholly in range, below the causal diagonal and inside the window: the same
// answer for every thread; such a tile is masked by the segment ids alone.
__device__ __forceinline__ bool interior_tile(int q0, int k0, int Sq, int Sk, int causal,
                                              int window) {
  return q0 + BQ <= Sq && k0 + BK <= Sk && (!causal || k0 + BK - 1 <= q0) &&
         (window <= 0 || q0 + BQ - 1 - k0 < window);
}

template <bool ROWS_ARE_Q>
__device__ __forceinline__ uint32_t tile_mask_bits(int row0, int col0, const int* seg_rows,
                                                   const int* seg_cols, int Sq, int Sk,
                                                   int causal, int window) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int q0 = ROWS_ARE_Q ? row0 : col0, k0 = ROWS_ARE_Q ? col0 : row0;
  uint32_t bits = 0;
  if (interior_tile(q0, k0, Sq, Sk, causal, window)) {
    const int r = 16 * w + (l >> 2);
    const int s0 = seg_rows[r], s1 = seg_rows[r + 8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int sc = seg_cols[8 * j + 2 * (l & 3) + e];
        bits |= ((uint32_t)(s0 == sc) << (4 * j + e)) | ((uint32_t)(s1 == sc) << (4 * j + 2 + e));
      }
    return bits;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = 16 * w + (l >> 2) + 8 * (h >> 1), c = 8 * j + 2 * (l & 3) + (h & 1);
      const bool ok =
          ROWS_ARE_Q
              ? attend(row0 + r, col0 + c, seg_rows[r], seg_cols[c], Sq, Sk, causal, window)
              : attend(col0 + c, row0 + r, seg_cols[c], seg_rows[r], Sq, Sk, causal, window);
      bits |= (uint32_t)ok << (4 * j + h);
    }
  return bits;
}

// Stores the columns < hd of a 64 x D fp32 accumulator as bf16 rows [row0, row0 + 64)
// of `dst` (row-major, row stride hd, rows past S skipped).
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst, const float (&acc)[D / 2],
                                          int row0, int S, int hd) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int r = row0 + 16 * w + (l >> 2);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (8 * j >= hd) break;                 // hd is a multiple of 8
    const int c = 8 * j + 2 * (l & 3);
    if (r < S)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r * hd + c) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < S)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r + 8) * hd + c) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int D>
constexpr size_t dq_tc_smem() {             // Q, dO, 2 stages of K and V; lse, delta, ids
  return 1024 + 6 * tile_bytes<D>() + sizeof(float) * 2 * BQ + sizeof(int) * (BQ + 2 * BK);
}
template <int D>
constexpr size_t dkv_tc_smem() {            // K, V, 2 stages of Q and dO, lse, delta, ids
  return 1024 + 6 * tile_bytes<D>() + sizeof(float) * 4 * BQ + sizeof(int) * (2 * BQ + BK);
}
static_assert(dq_tc_smem<256>() <= SMEM_MAX && dkv_tc_smem<256>() <= SMEM_MAX,
              "shared memory of one block");

// The first 1024-byte boundary in dynamic shared memory (the swizzle's period).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// --------------------------------------------------------------------------- //
// K2 (bf16): dq.  grid (n q tiles, B * KH); loops over the G heads of a kv head and,
// for each, over the key tiles, K and V double-buffered by cp.async.
// --------------------------------------------------------------------------- //
template <int D, bool PAD>
__global__ void __launch_bounds__(WG)
bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_k, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int KH, int G, int Sq, int Sk, int hd,
                 int causal, int window, float scale) {
  if constexpr (!PAD) hd = D;               // see PAD, at the launchers
  constexpr uint32_t TB = tile_bytes<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t sQ = smem_u32(sm), sDO = sQ + TB;
  const uint32_t sKV = sQ + 2 * TB;         // stage s: K at sKV + 2 s TB, V at sKV + (2 s + 1) TB
  float* sLse = reinterpret_cast<float*>(sm + 6 * TB);   // lse * log2(e)
  float* sDelta = sLse + BQ;
  int* sSq = reinterpret_cast<int*>(sDelta + BQ);
  int* sSk = sSq + BQ;                      // [2][BK]

  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;        // longest causal rows first
  const int bkv = blockIdx.y, b = bkv / KH;
  const __nv_bfloat16* kb = k + (size_t)bkv * Sk * hd;
  const __nv_bfloat16* vb = v + (size_t)bkv * Sk * hd;
  const float scale_log2 = scale * LOG2E;
  int kt_begin, kt_end;
  key_tile_range(q0, Sq, Sk, causal, window, &kt_begin, &kt_end);

  auto issue_kv = [&](int kt, int st) {
    tile_async<D>(sKV + 2 * st * TB, kb, kt * BK, Sk, hd);
    tile_async<D>(sKV + (2 * st + 1) * TB, vb, kt * BK, Sk, hd);
    load_ids(sSk + BK * st, seg_k + (size_t)b * Sk, kt * BK, Sk);
  };

  for (int g = 0; g < G; ++g) {
    const size_t bh = (size_t)bkv * G + g;
    __syncthreads();                        // the previous head's tiles are consumed
    tile_async<D>(sQ, q + bh * Sq * hd, q0, Sq, hd);
    tile_async<D>(sDO, dout + bh * Sq * hd, q0, Sq, hd);
    if (tid < BQ) {
      const int i = q0 + tid;
      sLse[tid] = i < Sq ? lse[bh * Sq + i] * LOG2E : 0.f;
      sDelta[tid] = i < Sq ? delta[bh * Sq + i] : 0.f;
      sSq[tid] = i < Sq ? seg_q[(size_t)b * Sq + i] : -1;
    }
    if (kt_begin < kt_end) issue_kv(kt_begin, 0);
    cp_commit();

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int st = (kt - kt_begin) & 1;
      cp_wait<0>();
      fence_async_smem();
      // Tile kt has landed, and every thread is done with tile kt - 1: its stage can
      // take tile kt + 1, which loads while this one computes.
      __syncthreads();
      if (kt + 1 < kt_end) {
        issue_kv(kt + 1, st ^ 1);
        cp_commit();
      }
      const uint32_t live = tile_mask_bits<true>(q0, kt * BK, sSq, sSk + BK * st, Sq, Sk,
                                                 causal, window);
      // A tile in which no (q, k) pair attends adds 0 to dq: the block skips it.
      if (__syncthreads_or(live != 0)) {
        const uint32_t sK = sKV + 2 * st * TB, sV = sK + TB;
        float s[32], dp[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) mma_ss(s, desc_k(sQ, kk), desc_k(sK, kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) mma_ss(dp, desc_k(sDO, kk), desc_k(sV, kk), kk);
        wg_commit();
        wg_wait0();
        pin(s);
        pin(dp);
        // ds = p (dp - delta) scale, p = exp(s scale - lse) where attended, else 0;
        // rounded to bf16 as the A fragments of dq += ds k.
        const int r0 = 16 * w + (l >> 2);
        const float lse0 = sLse[r0], lse1 = sLse[r0 + 8];
        const float del0 = sDelta[r0], del1 = sDelta[r0 + 8];
        uint32_t a[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float ds[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int e = 4 * j + h;
            const float p =
                (live >> e) & 1u ? exp2f(s[e] * scale_log2 - (h < 2 ? lse0 : lse1)) : 0.f;
            ds[h] = p * (dp[e] - (h < 2 ? del0 : del1)) * scale;
          }
          a[2 * j] = pack_bf16(ds[0], ds[1]);
          a[2 * j + 1] = pack_bf16(ds[2], ds[3]);
        }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_acc<D>(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], sK, kk);
        wg_commit();
        wg_wait0();
        pin(acc);
        pin(a);
      }
    }
    cp_wait<0>();                           // no copy outlives its head (empty key range)
    store_acc<D>(dq + bh * Sq * hd, acc, q0, Sq, hd);
  }
}

// --------------------------------------------------------------------------- //
// K3 (bf16): dk, dv.  grid (n key tiles, B * KH, 1); loops over the G heads and the q
// tiles, Q and dO double-buffered by cp.async, in the transposed form
// S^T = K Q^T, dP^T = V dO^T, so that P^T and dS^T are register A operands of
// dv += P^T dO and dk += dS^T Q.  At D 256 the two 64 x 256 fp32 accumulators would
// take 256 registers a thread, so the grid is 2 along z: the block with z = 0 computes
// dk alone (PART 1), z = 1 dv alone (PART 2: neither V nor dP^T), each recomputing S^T;
// PART 3 computes both.
// --------------------------------------------------------------------------- //
template <int D, int PART>
__device__ __forceinline__ void dkv_tc_body(
    unsigned char* smem_raw, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int KH, int G, int Sq, int Sk, int hd, int causal,
    int window, float scale) {
  constexpr bool DK = PART & 1, DV = PART & 2;
  constexpr uint32_t TB = tile_bytes<D>();
  unsigned char* sm = align1024(smem_raw);
  const uint32_t sK = smem_u32(sm), sV = sK + TB;
  const uint32_t sQO = sK + 2 * TB;         // stage s: Q at sQO + 2 s TB, dO at sQO + (2 s + 1) TB
  float* sLse = reinterpret_cast<float*>(sm + 6 * TB);   // [2][BQ], times log2(e)
  float* sDelta = sLse + 2 * BQ;                          // [2][BQ]
  int* sSq = reinterpret_cast<int*>(sDelta + 2 * BQ);     // [2][BQ]
  int* sSk = sSq + 2 * BQ;

  const int tid = threadIdx.x, l = tid & 31;
  const int k0 = blockIdx.x * BK;
  const int bkv = blockIdx.y, b = bkv / KH;
  const float scale_log2 = scale * LOG2E;
  int qt_begin, qt_end;
  query_tile_range(k0, Sq, Sk, causal, window, &qt_begin, &qt_end);
  const int nqt = max(qt_end - qt_begin, 0), n_tiles = G * nqt;

  // tile t is head t / nqt, q tile qt_begin + t % nqt
  auto issue_q = [&](int t, int st) {
    const int q0 = (qt_begin + t % nqt) * BQ;
    const size_t bh = (size_t)bkv * G + t / nqt;
    tile_async<D>(sQO + 2 * st * TB, q + bh * Sq * hd, q0, Sq, hd);
    tile_async<D>(sQO + (2 * st + 1) * TB, dout + bh * Sq * hd, q0, Sq, hd);
    if (tid < BQ) {
      const int i = q0 + tid;
      sLse[BQ * st + tid] = i < Sq ? lse[bh * Sq + i] * LOG2E : 0.f;
      sDelta[BQ * st + tid] = i < Sq ? delta[bh * Sq + i] : 0.f;
      sSq[BQ * st + tid] = i < Sq ? seg_q[(size_t)b * Sq + i] : -1;
    }
  };

  tile_async<D>(sK, k + (size_t)bkv * Sk * hd, k0, Sk, hd);
  if (DK) tile_async<D>(sV, v + (size_t)bkv * Sk * hd, k0, Sk, hd);
  load_ids(sSk, seg_k + (size_t)b * Sk, k0, Sk);
  if (n_tiles > 0) issue_q(0, 0);
  cp_commit();

  float gk[DK ? D / 2 : 1], gv[DV ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < (DK ? D / 2 : 1); ++i) gk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DV ? D / 2 : 1); ++i) gv[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    cp_wait<0>();
    fence_async_smem();
    __syncthreads();                        // as in K2: tile t landed, tile t - 1 consumed
    if (t + 1 < n_tiles) {
      issue_q(t + 1, st ^ 1);
      cp_commit();
    }
    const int q0 = (qt_begin + t % nqt) * BQ;
    const uint32_t live = tile_mask_bits<false>(k0, q0, sSk, sSq + BQ * st, Sq, Sk, causal,
                                                window);
    if (__syncthreads_or(live != 0)) {      // else the tile adds 0 to dk and dv
      const uint32_t sQ = sQO + 2 * st * TB, sDO = sQ + TB;
      const float* lse2 = sLse + BQ * st;
      const float* del = sDelta + BQ * st;
      float s[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) mma_ss(s, desc_k(sK, kk), desc_k(sQ, kk), kk);
      if constexpr (DK) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) mma_ss(dp, desc_k(sV, kk), desc_k(sDO, kk), kk);
      }
      wg_commit();
      wg_wait0();
      pin(s);
      if constexpr (DK) pin(dp);
      // rows are keys, columns queries: lse and delta vary along the columns
      uint32_t pa[16], da[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * (l & 3);
        const float lse_c[2] = {lse2[c], lse2[c + 1]}, del_c[2] = {del[c], del[c + 1]};
        float p[4], ds[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int e = 4 * j + h;
          p[h] = (live >> e) & 1u ? exp2f(s[e] * scale_log2 - lse_c[h & 1]) : 0.f;
          if (DK) ds[h] = p[h] * (dp[e] - del_c[h & 1]) * scale;
        }
        if (DV) {
          pa[2 * j] = pack_bf16(p[0], p[1]);
          pa[2 * j + 1] = pack_bf16(p[2], p[3]);
        }
        if (DK) {
          da[2 * j] = pack_bf16(ds[0], ds[1]);
          da[2 * j + 1] = pack_bf16(ds[2], ds[3]);
        }
      }
      wg_fence();
      if constexpr (DV) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_acc<D>(gv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], sDO, kk);
      }
      if constexpr (DK) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_acc<D>(gk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3], sQ, kk);
      }
      wg_commit();
      wg_wait0();
      if constexpr (DV) {
        pin(gv);
        pin(pa);
      }
      if constexpr (DK) {
        pin(gk);
        pin(da);
      }
    }
  }
  cp_wait<0>();                             // no copy outlives the block (empty q range)
  if constexpr (DK) store_acc<D>(dk + (size_t)bkv * Sk * hd, gk, k0, Sk, hd);
  if constexpr (DV) store_acc<D>(dv + (size_t)bkv * Sk * hd, gv, k0, Sk, hd);
}

template <int D, bool PAD>
__global__ void __launch_bounds__(WG)
bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
                  const int* __restrict__ seg_k, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int KH, int G,
                  int Sq, int Sk, int hd, int causal, int window, float scale) {
  if constexpr (!PAD) hd = D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
#define DKV_TC_ARGS                                                                         \
  smem_raw, q, k, v, seg_q, seg_k, dout, lse, delta, dk, dv, KH, G, Sq, Sk, hd, causal, window, \
      scale
  if constexpr (D <= 128)
    dkv_tc_body<D, 3>(DKV_TC_ARGS);
  else if (blockIdx.z == 0)
    dkv_tc_body<D, 1>(DKV_TC_ARGS);
  else
    dkv_tc_body<D, 2>(DKV_TC_ARGS);
#undef DKV_TC_ARGS
}

// --------------------------------------------------------------------------- //
// K1 (bf16): forward.  grid (n q tiles, B * H), H = KH * G; loops over the key
// tiles, K and V double-buffered by cp.async as in K2.  S = Q K^T on wgmma, the
// online softmax in fp32 registers, then O += P V with P as the register A operand.
// --------------------------------------------------------------------------- //
template <int D>
constexpr size_t fwd_tc_smem() {            // Q, 2 stages of K and V; ids and their ranges
  return 1024 + 5 * tile_bytes<D>() + sizeof(int) * (BQ + 2 * BK + 3 * 4);
}
static_assert(fwd_tc_smem<256>() <= SMEM_MAX, "shared memory of one block");

// 64 int32 ids starting at i0 (-1 past n) into dst, and into rng the min and max of
// each half (4 ints): a tile whose ids are all one segment is known by 4 loads.
__device__ __forceinline__ void load_ids_range(int* dst, int* rng, const int* src, int i0,
                                               int n) {
  if (threadIdx.x < 64) {
    const int i = i0 + threadIdx.x;
    const int x = i < n ? src[i] : -1;
    dst[threadIdx.x] = x;
    const int lo = __reduce_min_sync(0xffffffffu, x), hi = __reduce_max_sync(0xffffffffu, x);
    if ((threadIdx.x & 31) == 0) {
      rng[2 * (threadIdx.x >> 5)] = lo;
      rng[2 * (threadIdx.x >> 5) + 1] = hi;
    }
  }
}

// The one segment id of a tile's 64 rows or keys, or -1 if they hold several (a row
// or key past S counts as id -1).  Only ids >= 0 take the shortcut below.
__device__ __forceinline__ int uniform_id(const int* rng) {
  return rng[0] == rng[1] && rng[2] == rng[3] && rng[0] == rng[2] ? rng[0] : -1;
}

// 2^x with a denormal result flushed to 0; 2^(-1e30) = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax step of one key tile for this thread's two rows (accumulator
// elements 4 j + h, h < 2: row r0, h >= 2: row r0 + 8).  s holds the tile's scores on
// entry and p = 2^(s c - m c) on exit; m (unscaled, the same in the row's 4 lanes) and
// l (this thread's partial sum) are updated, corr returns 2^((m_prev - m_new) c).
// MASKED: some element of the warp does not attend.  Its score takes no part in the
// max, and its p is 0 by an explicit select: on a row masked everywhere m stays
// -1e30, and 2^(s c - m c) would be 1.  Without MASKED every element attends.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&s)[32], uint32_t live, float c,
                                             float& m0, float& m1, float& l0, float& l1,
                                             float& corr0, float& corr1) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const float x = !MASKED || (live >> e) & 1u ? s[e] : NEG_INF;
    if (e & 2) mx1 = fmaxf(mx1, x);
    else mx0 = fmaxf(mx0, x);
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  // 0 on a live row's first tile (m = -1e30), 1 on a row masked so far
  corr0 = ex2((m0 - mn0) * c);
  corr1 = ex2((m1 - mn1) * c);
  m0 = mn0;
  m1 = mn1;
  const float mc0 = mn0 * c, mc1 = mn1 * c;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const float p = ex2(fmaf(s[e], c, -(e & 2 ? mc1 : mc0)));
    s[e] = !MASKED || (live >> e) & 1u ? p : 0.f;
    if (e & 2) ps1 += s[e];
    else ps0 += s[e];
  }
  l0 = l0 * corr0 + ps0;
  l1 = l1 * corr1 + ps1;
}

template <int D, bool PAD>
__global__ void __launch_bounds__(WG)
fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
              const int* __restrict__ seg_k, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int H, int G, int Sq, int Sk, int hd, int causal,
              int window, float scale) {
  if constexpr (!PAD) hd = D;
  constexpr uint32_t TB = tile_bytes<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t sQ = smem_u32(sm);
  const uint32_t sKV = sQ + TB;             // stage s: K at sKV + 2 s TB, V at sKV + (2 s + 1) TB
  int* sSq = reinterpret_cast<int*>(sm + 5 * TB);
  int* sSk = sSq + BQ;                      // [2][BK]
  int* sRng = sSk + 2 * BK;                 // id ranges: Q's, then [2] K's, 4 ints each

  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;        // longest causal rows first
  const int bh = blockIdx.y, b = bh / H, bkv = bh / G;
  const __nv_bfloat16* kb = k + (size_t)bkv * Sk * hd;
  const __nv_bfloat16* vb = v + (size_t)bkv * Sk * hd;
  // p = 2^(s c - m c): the softmax scale and log2(e) in one factor
  const float c = scale * LOG2E;
  int kt_begin, kt_end;
  key_tile_range(q0, Sq, Sk, causal, window, &kt_begin, &kt_end);

  auto issue_kv = [&](int kt, int st) {
    tile_async<D>(sKV + 2 * st * TB, kb, kt * BK, Sk, hd);
    tile_async<D>(sKV + (2 * st + 1) * TB, vb, kt * BK, Sk, hd);
    load_ids_range(sSk + BK * st, sRng + 4 + 4 * st, seg_k + (size_t)b * Sk, kt * BK, Sk);
  };

  tile_async<D>(sQ, q + (size_t)bh * Sq * hd, q0, Sq, hd);
  load_ids_range(sSq, sRng, seg_q + (size_t)b * Sq, q0, Sq);
  if (kt_begin < kt_end) issue_kv(kt_begin, 0);
  cp_commit();

  // This thread's two rows are r0 = 16 w + l / 4 and r0 + 8; l sums this thread's p
  // of each row, so the 4 lanes' partial sums are added once, after the loop.
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    cp_wait<0>();
    fence_async_smem();
    // as in K2: tile kt has landed and tile kt - 1 is consumed, so its stage takes
    // tile kt + 1, which loads while this one computes
    __syncthreads();
    if (kt + 1 < kt_end) {
      issue_kv(kt + 1, st ^ 1);
      cp_commit();
    }
    // A tile whose rows and keys each hold one segment attends nowhere if the two
    // differ and everywhere if they agree on an interior tile; any other tile takes
    // its mask bits element by element.
    uint32_t live;
    const int uq = uniform_id(sRng), uk = uniform_id(sRng + 4 + 4 * st);
    if (uq >= 0 && uk >= 0 && (uq != uk || interior_tile(q0, kt * BK, Sq, Sk, causal, window)))
      live = uq == uk ? 0xffffffffu : 0u;
    else
      live = tile_mask_bits<true>(q0, kt * BK, sSq, sSk + BK * st, Sq, Sk, causal, window);
    // A tile in which no (q, k) pair attends changes no m, l or o: the block skips it.
    if (__syncthreads_or(live != 0)) {
      const uint32_t sK = sKV + 2 * st * TB, sV = sK + TB;
      float s[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) mma_ss(s, desc_k(sQ, kk), desc_k(sK, kk), kk);
      wg_commit();
      wg_wait0();
      pin(s);
      float corr0, corr1;
      if (__all_sync(0xffffffffu, live == 0xffffffffu))
        softmax_tile<false>(s, live, c, m0, m1, l0, l1, corr0, corr1);
      else
        softmax_tile<true>(s, live, c, m0, m1, l0, l1, corr0, corr1);
      // l is summed from the fp32 p; P V takes them rounded to bf16
      uint32_t a[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
        a[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }
      // rescale O unless no row max of the warp moved (a factor of 1 changes nothing)
      if (!__all_sync(0xffffffffu, corr0 == 1.f && corr1 == 1.f)) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= corr0;
          acc[4 * j + 1] *= corr0;
          acc[4 * j + 2] *= corr1;
          acc[4 * j + 3] *= corr1;
        }
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_acc<D>(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], sV, kk);
      wg_commit();
      wg_wait0();
      pin(acc);
      pin(a);
    }
  }
  cp_wait<0>();                             // no copy outlives the block (empty key range)

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // o = acc / l and lse = m scale + log l (natural log, as K2 and K3 read it) on a row
  // that attends anything; o = 0 and lse = -1e30 on a row masked everywhere
  const bool live0 = l0 > 0.f, live1 = l1 > 0.f;
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] = live0 ? acc[4 * j] / den0 : 0.f;
    acc[4 * j + 1] = live0 ? acc[4 * j + 1] / den0 : 0.f;
    acc[4 * j + 2] = live1 ? acc[4 * j + 2] / den1 : 0.f;
    acc[4 * j + 3] = live1 ? acc[4 * j + 3] / den1 : 0.f;
  }
  store_acc<D>(o + (size_t)bh * Sq * hd, acc, q0, Sq, hd);
  if ((l & 3) == 0) {
    const int r = q0 + 16 * w + (l >> 2);
    if (r < Sq) lse[(size_t)bh * Sq + r] = live0 ? m0 * scale + logf(den0) : NEG_INF;
    if (r + 8 < Sq) lse[(size_t)bh * Sq + r + 8] = live1 ? m1 * scale + logf(den1) : NEG_INF;
  }
}

// hd^-0.5 rounded to fp32, as the TPU wrapper's `D ** -0.5` is: the real head dim, not
// the tile width it is instantiated at.
float softmax_scale(int hd) { return (float)(1.0 / sqrt((double)hd)); }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* seg_q,
                       const int* seg_k, void* o, float* lse, int B, int KH, int G, int Sq,
                       int Sk, int hd, int causal, int window, cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  cudaError_t e = allow_smem(fwd_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, B * KH * G);
  fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seg_q, seg_k, static_cast<float*>(o), lse, KH * G, G, Sq,
      Sk, hd, causal, window, softmax_scale(hd));
  return cudaGetLastError();
}

// The tensor-core kernels' PAD: false where the head dim fills the tile (hd == D), and
// the kernel then takes D as a constant row stride and loads no zero chunks, the
// code of a kernel written for that one width; true where it does not.  Measured on
// an H100, the runtime stride alone cost the full-width kernels registers (K3 at D 128
// spilled) and 3-31 % of their time.  Built with -DPFA_PAD_ALWAYS=1, every launch takes
// the PAD true kernel, for measuring what PAD costs at a full-width head dim
// (tools/pfa_ab.py --baseline-flags).
#ifndef PFA_PAD_ALWAYS
#define PFA_PAD_ALWAYS 0
#endif
template <int D>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v, const int* seg_q,
                          const int* seg_k, void* o, float* lse, int B, int KH, int G, int Sq,
                          int Sk, int hd, int causal, int window, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = fwd_tc_smem<D>();
  const auto kernel = hd == D && !PFA_PAD_ALWAYS ? fwd_tc_kernel<D, false>
                                               : fwd_tc_kernel<D, true>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, B * KH * G);
  kernel<<<grid, WG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      seg_q, seg_k, static_cast<bf16*>(o), lse, KH * G, G, Sq, Sk, hd, causal, window,
      softmax_scale(hd));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const int* seg_q,
                      const int* seg_k, const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int KH, int G, int Sq, int Sk, int hd, int causal,
                      int window, cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
  cudaError_t e = allow_smem(bwd_dq_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, B * KH * G);
  bwd_dq_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seg_q, seg_k, static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), KH * G, G, Sq, Sk, hd, causal, window, softmax_scale(hd));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const int* seg_q,
                       const int* seg_k, const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int KH, int G, int Sq, int Sk, int hd,
                       int causal, int window, cudaStream_t stream) {
  constexpr bool split = dkv_split<D>();
  const size_t smem = split ? dkv_smem<D, 1>() : dkv_smem<D, 3>();
  cudaError_t e = allow_smem(bwd_dkv_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sk + BK - 1) / BK, B * KH, split ? 2 : 1);
  bwd_dkv_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seg_q, seg_k, static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), KH, G, Sq, Sk, hd, causal, window,
      softmax_scale(hd));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v, const int* seg_q,
                         const int* seg_k, const void* dout, const float* lse,
                         const float* delta, void* dq, int B, int KH, int G, int Sq, int Sk,
                         int hd, int causal, int window, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = dq_tc_smem<D>();
  const auto kernel = hd == D && !PFA_PAD_ALWAYS ? bwd_dq_tc_kernel<D, false>
                                               : bwd_dq_tc_kernel<D, true>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, B * KH);
  kernel<<<grid, WG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      seg_q, seg_k, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), KH, G,
      Sq, Sk, hd, causal, window, softmax_scale(hd));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v, const int* seg_q,
                          const int* seg_k, const void* dout, const float* lse,
                          const float* delta, void* dk, void* dv, int B, int KH, int G, int Sq,
                          int Sk, int hd, int causal, int window, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = dkv_tc_smem<D>();
  const auto kernel = hd == D && !PFA_PAD_ALWAYS ? bwd_dkv_tc_kernel<D, false>
                                               : bwd_dkv_tc_kernel<D, true>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sk + BK - 1) / BK, B * KH, D <= 128 ? 1 : 2);   // z: dk, dv at D 256
  kernel<<<grid, WG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      seg_q, seg_k, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), KH, G, Sq, Sk, hd, causal, window, softmax_scale(hd));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers, `stream` is
// a cudaStream_t; `bf16` selects bf16 (1) or fp32 (0) q/k/v/o; D is the head dim, a
// multiple of 8 from 8 to 256, run at the narrowest tile width of 64, 128 or 256 that
// holds it.  Every kernel runs on the tensor cores in bf16 and on the CUDA cores in
// fp32.  Each function returns the cudaError_t of its launch (0 on success), and
// cudaErrorInvalidValue for a head dim it does not take.
#define PFA_DISPATCH(TC, FP32)                                              \
  if (D < 8 || D > 256 || D % 8 != 0) return (int)cudaErrorInvalidValue;    \
  if (bf16 && D <= 64) return (int)TC(64);                                  \
  if (bf16 && D <= 128) return (int)TC(128);                                \
  if (bf16) return (int)TC(256);                                            \
  if (D <= 64) return (int)FP32(64);                                        \
  if (D <= 128) return (int)FP32(128);                                      \
  return (int)FP32(256);

extern "C" {

int pfa_fwd(const void* q, const void* k, const void* v, const void* seg_q, const void* seg_k,
            void* o, void* lse, int B, int KH, int G, int Sq, int Sk, int D, int causal,
            int window, int bf16, void* stream) {
#define ARGS                                                                             \
  q, k, v, static_cast<const int*>(seg_q), static_cast<const int*>(seg_k), o,             \
      static_cast<float*>(lse), B, KH, G, Sq, Sk, D, causal, window,                      \
      static_cast<cudaStream_t>(stream)
#define TC(DD) launch_fwd_tc<DD>(ARGS)
#define FP32(DD) launch_fwd<DD>(ARGS)
  PFA_DISPATCH(TC, FP32)
#undef FP32
#undef TC
#undef ARGS
}

int pfa_bwd_dq(const void* q, const void* k, const void* v, const void* seg_q,
               const void* seg_k, const void* dout, const void* lse, const void* delta,
               void* dq, int B, int KH, int G, int Sq, int Sk, int D, int causal, int window,
               int bf16, void* stream) {
#define ARGS                                                                             \
  q, k, v, static_cast<const int*>(seg_q), static_cast<const int*>(seg_k), dout,          \
      static_cast<const float*>(lse), static_cast<const float*>(delta), dq, B, KH, G, Sq, \
      Sk, D, causal, window, static_cast<cudaStream_t>(stream)
#define TC(DD) launch_dq_tc<DD>(ARGS)
#define FP32(DD) launch_dq<DD>(ARGS)
  PFA_DISPATCH(TC, FP32)
#undef FP32
#undef TC
#undef ARGS
}

int pfa_bwd_dkv(const void* q, const void* k, const void* v, const void* seg_q,
                const void* seg_k, const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int B, int KH, int G, int Sq, int Sk, int D, int causal,
                int window, int bf16, void* stream) {
#define ARGS                                                                             \
  q, k, v, static_cast<const int*>(seg_q), static_cast<const int*>(seg_k), dout,          \
      static_cast<const float*>(lse), static_cast<const float*>(delta), dk, dv, B, KH, G, \
      Sq, Sk, D, causal, window, static_cast<cudaStream_t>(stream)
#define TC(DD) launch_dkv_tc<DD>(ARGS)
#define FP32(DD) launch_dkv<DD>(ARGS)
  PFA_DISPATCH(TC, FP32)
#undef FP32
#undef TC
#undef ARGS
}

}  // extern "C"
