// Backward of the online-softmax attention (flash_attention.cu) for Hopper
// (sm_90a): dQ, dK and dV of causal, sliding-window or bidirectional
// attention with grouped KV heads, given q, k, v, the forward's output o and
// the output gradient dO.
//
// Replaces: the gradient XLA takes of the reference's plain `attend` in its
// `loss` (src/repro/models/common.py:131); no JAX kernel of the reference has
// a custom_vjp, so the TPU side never ran a hand-written backward.
//
// Bound on this card: five products of the forward's shape (S = QK^T
// recomputed, dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q), about 2.5
// times the forward's operations, halved by the causal mask; at training
// lengths that is operations over the bf16 tensor-core rate.
//
// Rows are folded as in the forward: row r of a (batch, kv head) is query
// position r / g and query head kvh * g + r % g, g = H / Hkv. Neither route
// uses atomics, so the bits depend on the shapes only: dQ has a kernel of its
// own over row blocks, and a block of KV positions sums its dK and dV over
// every row that sees it, the g query heads of its kv head included. Two
// routes, picked by the wrapper (ops.py, fa_bwd_route) by the forward's rule:
//  * wgmma (bf16, D = 64 or 128, Sq <= Skv, Sq * g >= 64, every tensor
//    16-byte aligned), three launches, each reading the rows' statistics in
//    the convention of flash_attention_wgmma.cuh (lse2 = m2 + log2(l), log2
//    units of the scaled scores, (B, H, Sq) f32): the forward writes them
//    under autograd; without them a fourth launch, the forward kernel
//    itself (flash_attention_wgmma.cuh), writes them first, with the same
//    bits, so the gradients are the same either way.
//     1. delta: sum_d dO * O of every row, (B, H, Sq) f32;
//     2. dq: the forward's work items (128 rows, two consumer warpgroups)
//        and TMA ring of K/V tiles; per tile S = Q K^T and dP = dO V^T
//        (wgmma, shared-memory operands), P = 2^(S scale log2(e) - lse2),
//        dS = P (dP - delta) rounded to bf16 in registers, dQ += dS K;
//     3. dkdv: 128 KV positions of one (batch, kv head) an item, K and V
//        resident (two buffers), row tiles of Q and dO streamed by TMA with
//        their lse2 and delta; per tile S^T = K Q^T, dP^T = V dO^T, P^T,
//        dV += P^T dO, dS^T = P^T (dP^T - delta), dK += dS^T Q, P^T and
//        dS^T as bf16 register operands. At D = 128 a consumer thread holds
//        dK and dV (2 x 64 f32), S^T and dP^T (2 x 32) and a bf16 operand
//        (16): it takes 240 registers and leaves the producer warpgroup 24,
//        which spills ~24 bytes of loop state there (ptxas) and none on the
//        consumers; 232 / 40 spilled on the consumers.
//    Blocks are persistent (one an SM) and take the heaviest items first;
//    tiles that no mask reaches skip the mask tests; the masks give P = 0
//    (every row sees a key when Sq <= Skv). Rounding P and dS to bf16 as
//    product operands, with f32 accumulation, is the route's one precision
//    change against the f32 plain version: relative L2 of dQ, dK and dV
//    2.3-2.5e-3 against attention_ref_backward at qwen3-1.7b's and
//    minicpm-2b's training calls on an H100 (chip_smoke.py, which gates it
//    at 2e-2).
//  * simt (f32, hubert's D = 80, recurrentgemma's D = 256, Sq > Skv, any
//    other head dim up to 256), f32 arithmetic throughout, three launches:
//     1. rows: each row's softmax statistics, kept as its own pair (the
//        running max m and the sum l of exp(s - m), natural units; a row
//        the mask hides entirely keeps the forward's uniform weights, which
//        m + log l would round away at the sentinel), and delta = dO . O;
//     2. dq: a block owns 64 rows and walks the KV tiles they see, as the
//        forward's simt route does: P = exp(s - m) / l, dS = P (dP - delta),
//        dQ += dS K;
//     3. dkdv: a block owns 32 KV positions of one (batch, kv head) and walks
//        the rows that see them in chunks of 32: dV += P^T dO, dK += dS^T Q.
//    Masks are the forward's (flash_attention.cu, fa_kernel): a key past Skv
//    contributes nothing; a key the causal or window mask hides keeps the
//    finite sentinel -1e30 as its score, so its weight is 0 in a row that
//    sees any key and uniform in a row that sees none (only possible when Sq
//    > Skv), and its dS is 0, as the gradient of the reference's
//    torch.where. When Sq <= Skv every row sees a key, and tiles or rows
//    that the masks hide from a whole block are skipped: that changes only
//    speed. Inputs f32 or bf16 are read into f32 shared memory; gradients
//    accumulate in f32 and are written in the input type. Tiles come in two
//    sizes, for D <= 128 and D <= 256, a template argument chosen by D.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_wgmma.cuh"

namespace {

constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kRows = 64;          // folded rows a block of the rows and dq kernels
constexpr int kCols = 32;          // KV positions a tile
constexpr int kKvRows = 32;        // folded rows a chunk of the dkdv kernel
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;  // the forward's masked-score sentinel

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Shared-memory rows are MD + 1 floats long: threads that read different rows
// at one head dim then hit different banks.
template <int MD>
constexpr size_t rows_smem() {  // 107,648 bytes at MD = 256
  return (size_t)kRows * (MD + 1) + kCols * (MD + 1) + kRows * (kCols + 1) + 2 * kRows;
}
template <int MD>
constexpr size_t dq_smem() {  // 206,592 bytes at MD = 256
  return 2 * (size_t)kRows * (MD + 1) + 2 * kCols * (MD + 1) + kRows * (kCols + 1) + 3 * kRows;
}
template <int MD>
constexpr size_t dkdv_smem() {  // 140,416 bytes at MD = 256
  return 2 * (size_t)kCols * (MD + 1) + 2 * kKvRows * (MD + 1) + 2 * kKvRows * (kCols + 1) + 3 * kKvRows;
}

// Whether key t is hidden from query position s by the causal or window mask.
__device__ __forceinline__ bool hidden(int s, int t, int causal, int window) {
  return (causal && s < t) || (window > 0 && s - t >= window);
}

// The KV tiles a block of folded rows [r0, r0 + kRows) must visit, as the
// forward computes them: all of them unless Sq <= Skv (skip_ok).
__device__ __forceinline__ void kv_range(int r0, int n_rows, int g, int Skv, int causal, int window,
                                         int skip_ok, int* t_begin, int* t_end) {
  *t_begin = 0;
  *t_end = Skv;
  if (skip_ok) {
    const int s_lo = r0 / g;
    const int s_hi = (min(n_rows, r0 + kRows) - 1) / g;
    if (causal) *t_end = min(Skv, s_hi + 1);
    if (window > 0) *t_begin = (max(0, s_lo - window + 1) / kCols) * kCols;
  }
}

// Loads rows [r0, r0 + n) of one (batch, kv head) of a (B, Sq, H, D) tensor
// into dst (rows of MD + 1 floats), times `mul`; rows at or past r_end are 0.
template <typename T, int MD>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int n, int r0,
                                          int r_end, int b, int kvh, int g, int Sq, int H, int D,
                                          float mul) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const int r = r0 + i;
    float val = 0.f;
    if (r < r_end) {
      const int s = r / g, h = kvh * g + r % g;
      val = to_float(src[(((size_t)b * Sq + s) * H + h) * D + d]) * mul;
    }
    dst[i * (MD + 1) + d] = val;
  }
}

// Loads KV positions [t0, t0 + kCols) of one (batch, kv head) of a (B, Skv,
// Hkv, D) tensor into dst (rows of MD + 1 floats); positions past Skv are 0.
template <typename T, int MD>
__device__ __forceinline__ void load_kv(float* dst, const T* __restrict__ src, int t0, int b,
                                        int kvh, int Skv, int Hkv, int D) {
  for (int idx = threadIdx.x; idx < kCols * D; idx += kThreads) {
    const int j = idx / D, d = idx % D;
    const int t = t0 + j;
    dst[j * (MD + 1) + d] = t < Skv ? to_float(src[(((size_t)b * Skv + t) * Hkv + kvh) * D + d]) : 0.f;
  }
}

// 1. Row statistics: m, l over the keys each row sees, and delta = dO . O.
// grid = (B * Hkv, ceil(Sq * g / 64)); stats laid out (B, Hkv, Sq * g).
template <typename T, int MD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
            const T* __restrict__ dout, float* __restrict__ stat_m, float* __restrict__ stat_l,
            float* __restrict__ stat_d, int Sq, int Skv, int H, int Hkv, int D, float scale,
            int causal, int window, int skip_ok) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kRows * (MD + 1);
  float* ps = ks + kCols * (MD + 1);
  float* row_m = ps + kRows * (kCols + 1);
  float* row_l = row_m + kRows;

  const int g = H / Hkv;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int n_rows = Sq * g;
  const int r0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const size_t stat0 = (size_t)blockIdx.x * n_rows;

  load_rows<T, MD>(qs, q, kRows, r0, n_rows, b, kvh, g, Sq, H, D, scale);
  if (tid < kRows) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }
  int t_begin, t_end;
  kv_range(r0, n_rows, g, Skv, causal, window, skip_ok, &t_begin, &t_end);

  for (int t0 = t_begin; t0 < t_end; t0 += kCols) {
    __syncthreads();  // q tile and stats written; previous tile consumed
    load_kv<T, MD>(ks, k, t0, b, kvh, Skv, Hkv, D);
    __syncthreads();
    float sc[4][2] = {};
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[2];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qs[(ty + 16 * a) * (MD + 1) + d];
#pragma unroll
      for (int c = 0; c < 2; ++c) kb[c] = ks[(tx + 16 * c) * (MD + 1) + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c) sc[a][c] = fmaf(qa[a], kb[c], sc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      const int s = (r0 + i) / g;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = tx + 16 * c, t = t0 + j;
        ps[i * (kCols + 1) + j] = t >= Skv ? -INFINITY : hidden(s, t, causal, window) ? kNegInf : sc[a][c];
      }
    }
    __syncthreads();
    // warp w updates rows 8w .. 8w + 7; lane = column
    for (int rr = 0; rr < kRows / 8; ++rr) {
      const int i = warp * (kRows / 8) + rr;
      const float val = ps[i * (kCols + 1) + lane];
      float mx = val;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = expf(val - m_new);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        row_l[i] = row_l[i] * expf(m_old - m_new) + sum;
        row_m[i] = m_new;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (tid < kRows && r0 + tid < n_rows) {
    stat_m[stat0 + r0 + tid] = row_m[tid];
    stat_l[stat0 + r0 + tid] = row_l[tid];
  }
  // delta: warp w sums rows 8w .. 8w + 7 over their head dims
  for (int rr = 0; rr < kRows / 8; ++rr) {
    const int r = r0 + warp * (kRows / 8) + rr;
    if (r >= n_rows) break;
    const int s = r / g, h = kvh * g + r % g;
    const size_t off = (((size_t)b * Sq + s) * H + h) * D;
    float sum = 0.f;
    for (int d = lane; d < D; d += 32) sum = fmaf(to_float(dout[off + d]), to_float(o[off + d]), sum);
#pragma unroll
    for (int w = 16; w > 0; w /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    if (lane == 0) stat_d[stat0 + r] = sum;
  }
}

// 2. dQ: grid = (B * Hkv, ceil(Sq * g / 64)), a block's 64 rows over the KV
// tiles they see. A thread owns rows ty + 16a and head dims tx + 16c.
template <typename T, int MD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ stat_m,
          const float* __restrict__ stat_l, const float* __restrict__ stat_d, T* __restrict__ dq,
          int Sq, int Skv, int H, int Hkv, int D, float scale, int causal, int window,
          int skip_ok) {
  constexpr int kAcc = MD / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kRows * (MD + 1);
  float* ks = dos + kRows * (MD + 1);
  float* vs = ks + kCols * (MD + 1);
  float* dss = vs + kCols * (MD + 1);
  float* row_m = dss + kRows * (kCols + 1);
  float* row_il = row_m + kRows;  // 1 / l
  float* row_d = row_il + kRows;

  const int g = H / Hkv;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int n_rows = Sq * g;
  const int r0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t stat0 = (size_t)blockIdx.x * n_rows;

  load_rows<T, MD>(qs, q, kRows, r0, n_rows, b, kvh, g, Sq, H, D, scale);
  load_rows<T, MD>(dos, dout, kRows, r0, n_rows, b, kvh, g, Sq, H, D, 1.f);
  if (tid < kRows) {
    const bool live = r0 + tid < n_rows;
    row_m[tid] = live ? stat_m[stat0 + r0 + tid] : 0.f;
    row_il[tid] = live ? 1.f / stat_l[stat0 + r0 + tid] : 0.f;
    row_d[tid] = live ? stat_d[stat0 + r0 + tid] : 0.f;
  }
  int t_begin, t_end;
  kv_range(r0, n_rows, g, Skv, causal, window, skip_ok, &t_begin, &t_end);

  float acc[4][kAcc];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[a][c] = 0.f;

  for (int t0 = t_begin; t0 < t_end; t0 += kCols) {
    __syncthreads();
    load_kv<T, MD>(ks, k, t0, b, kvh, Skv, Hkv, D);
    load_kv<T, MD>(vs, v, t0, b, kvh, Skv, Hkv, D);
    __syncthreads();
    float sc[4][2] = {}, dp[4][2] = {};
    for (int d = 0; d < D; ++d) {
      float qa[4], da[4], kb[2], vb[2];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qa[a] = qs[(ty + 16 * a) * (MD + 1) + d];
        da[a] = dos[(ty + 16 * a) * (MD + 1) + d];
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        kb[c] = ks[(tx + 16 * c) * (MD + 1) + d];
        vb[c] = vs[(tx + 16 * c) * (MD + 1) + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sc[a][c] = fmaf(qa[a], kb[c], sc[a][c]);
          dp[a][c] = fmaf(da[a], vb[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      const int s = (r0 + i) / g;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = tx + 16 * c, t = t0 + j;
        float ds = 0.f;
        if (t < Skv && !hidden(s, t, causal, window)) {
          const float p = expf(sc[a][c] - row_m[i]) * row_il[i];
          ds = p * (dp[a][c] - row_d[i]);
        }
        dss[i * (kCols + 1) + j] = ds;
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      for (int j = 0; j < kCols; ++j) {
        const float ds = dss[i * (kCols + 1) + j];
#pragma unroll
        for (int c = 0; c < kAcc; ++c) {
          const int d = tx + 16 * c;
          if (d < D) acc[a][c] = fmaf(ds, ks[j * (MD + 1) + d], acc[a][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty + 16 * a;
    if (r >= n_rows) continue;
    const int s = r / g, h = kvh * g + r % g;
    T* out = dq + (((size_t)b * Sq + s) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(out + d, acc[a][c] * scale);
    }
  }
}

// 3. dK and dV: grid = (B * Hkv, ceil(Skv / 32)), a block's 32 KV positions
// over the folded rows that see them, 32 at a time. A thread owns KV
// positions ty + 16a and head dims tx + 16c of both sums.
template <typename T, int MD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ stat_m,
            const float* __restrict__ stat_l, const float* __restrict__ stat_d,
            T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H, int Hkv, int D,
            float scale, int causal, int window, int skip_ok) {
  constexpr int kAcc = MD / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kCols * (MD + 1);
  float* qs = vs + kCols * (MD + 1);
  float* dos = qs + kKvRows * (MD + 1);
  float* ps = dos + kKvRows * (MD + 1);
  float* dss = ps + kKvRows * (kCols + 1);
  float* row_m = dss + kKvRows * (kCols + 1);
  float* row_il = row_m + kKvRows;
  float* row_d = row_il + kKvRows;

  const int g = H / Hkv;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int n_rows = Sq * g;
  const int t0 = blockIdx.y * kCols;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t stat0 = (size_t)blockIdx.x * n_rows;

  load_kv<T, MD>(ks, k, t0, b, kvh, Skv, Hkv, D);
  load_kv<T, MD>(vs, v, t0, b, kvh, Skv, Hkv, D);
  // the rows that see a key of this block: causal keeps s >= t0, a window
  // s < t_last + window
  int r_begin = 0, r_end = n_rows;
  if (skip_ok) {
    const int t_last = min(t0 + kCols, Skv) - 1;
    if (causal) r_begin = t0 * g;
    if (window > 0) r_end = min(Sq, t_last + window) * g;
  }

  float acc_k[2][kAcc], acc_v[2][kAcc];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kKvRows) {
    __syncthreads();  // K/V tile written; previous chunk consumed
    load_rows<T, MD>(qs, q, kKvRows, r0, r_end, b, kvh, g, Sq, H, D, scale);
    load_rows<T, MD>(dos, dout, kKvRows, r0, r_end, b, kvh, g, Sq, H, D, 1.f);
    if (tid < kKvRows) {
      const bool live = r0 + tid < r_end;
      row_m[tid] = live ? stat_m[stat0 + r0 + tid] : 0.f;
      row_il[tid] = live ? 1.f / stat_l[stat0 + r0 + tid] : 0.f;
      row_d[tid] = live ? stat_d[stat0 + r0 + tid] : 0.f;
    }
    __syncthreads();
    // S and dP: rows ty + 16a of the chunk, KV positions tx + 16c
    float sc[2][2] = {}, dp[2][2] = {};
    for (int d = 0; d < D; ++d) {
      float qa[2], da[2], kb[2], vb[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        qa[a] = qs[(ty + 16 * a) * (MD + 1) + d];
        da[a] = dos[(ty + 16 * a) * (MD + 1) + d];
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        kb[c] = ks[(tx + 16 * c) * (MD + 1) + d];
        vb[c] = vs[(tx + 16 * c) * (MD + 1) + d];
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sc[a][c] = fmaf(qa[a], kb[c], sc[a][c]);
          dp[a][c] = fmaf(da[a], vb[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int i = ty + 16 * a;
      const int r = r0 + i;
      const int s = r / g;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = tx + 16 * c, t = t0 + j;
        float p = 0.f, ds = 0.f;
        if (r < r_end && t < Skv) {
          if (hidden(s, t, causal, window)) {
            p = expf(kNegInf - row_m[i]) * row_il[i];  // > 0 only in a row that sees no key
          } else {
            p = expf(sc[a][c] - row_m[i]) * row_il[i];
            ds = p * (dp[a][c] - row_d[i]);
          }
        }
        ps[i * (kCols + 1) + j] = p;
        dss[i * (kCols + 1) + j] = ds;
      }
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q (Q pre-scaled): positions ty + 16a, dims tx + 16c
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int j = ty + 16 * a;
      for (int i = 0; i < kKvRows; ++i) {
        const float p = ps[i * (kCols + 1) + j];
        const float ds = dss[i * (kCols + 1) + j];
#pragma unroll
        for (int c = 0; c < kAcc; ++c) {
          const int d = tx + 16 * c;
          if (d < D) {
            acc_v[a][c] = fmaf(p, dos[i * (MD + 1) + d], acc_v[a][c]);
            acc_k[a][c] = fmaf(ds, qs[i * (MD + 1) + d], acc_k[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int t = t0 + ty + 16 * a;
    if (t >= Skv) continue;
    const size_t off = (((size_t)b * Skv + t) * Hkv + kvh) * D;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        store(dk + off + d, acc_k[a][c]);
        store(dv + off + d, acc_v[a][c]);
      }
    }
  }
}

// ---- wgmma route -------------------------------------------------------------

// The row pass: delta = sum_d dO * O of every row, in f32, laid out (B, H,
// Sq) like the statistics. D / 8 lanes a row, one 16-byte piece each, summed
// over the lanes in a fixed order. grid = ceil(B * Sq * H / rows a block).
template <int D>
__global__ void __launch_bounds__(256)
fa_bwd_delta(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
             float* __restrict__ delta, int n, int Sq, int H) {
  constexpr int kChunks = D / 8;
  constexpr int kRowsPerWarp = 32 / kChunks;
  const int lane = threadIdx.x % 32;
  const long row = ((long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) * kRowsPerWarp +
                   lane / kChunks;  // (b, s, h) in q's order
  float sum = 0.f;
  if (row < n) {
    const size_t off = (size_t)row * D + (lane % kChunks) * 8;
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(o + off));
    const uint4 d = __ldg(reinterpret_cast<const uint4*>(dout + off));
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pd = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa2 = __bfloat1622float2(pa[i]), fd2 = __bfloat1622float2(pd[i]);
      sum = fmaf(fd2.x, fa2.x, sum);
      sum = fmaf(fd2.y, fa2.y, sum);
    }
  }
#pragma unroll
  for (int off = kChunks / 2; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < n && lane % kChunks == 0) {
    const long b = row / ((long)Sq * H), s = (row / H) % Sq, h = row % H;
    delta[((size_t)b * H + h) * Sq + s] = sum;
  }
}

// Statistics of the thread's rows R0 and R0 + 8 of the dq kernel: lse2 and
// delta, or +inf and 0 past the last row (so that P = 0 there).
__device__ __forceinline__ void row_stats(const float* __restrict__ lse,
                                          const float* __restrict__ delta, int b, int kvh, int g,
                                          int Sq, int H, int r, int n_rows, float* l2, float* dl) {
  *l2 = INFINITY;
  *dl = 0.f;
  if (r < n_rows) {
    const size_t idx = ((size_t)b * H + kvh * g + r % g) * Sq + r / g;
    *l2 = lse[idx];
    *dl = delta[idx];
  }
}

template <int D>
struct DqLayout {
  using F = fa::FaLayout<D>;
  static constexpr int kSmem = 1024 + 2 * F::kQBytes + fa::kFaStages * F::kStageBytes +
                               2 * fa::kFaStages * 8;
};

// 2. dQ (wgmma): the forward's work items (128 folded rows of one (batch, kv
// head), two consumer warpgroups of 64) and its K/V ring. A warpgroup loads
// its Q and dO rows once an item; per KV tile: S = Q K^T and dP = dO V^T
// (both operands in shared memory, K-major), P = 2^(S * scale2 - lse2)
// with the masks, dS = P (dP - delta) rounded to bf16 in registers, dQ +=
// dS K (K MN-major, the transpose bit). dQ is scaled once at the end.
template <int D>
__global__ void __launch_bounds__(fa::kFaThreads, 1)
fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int B, int Sq, int Skv, int H, int Hkv, float scale,
                int causal, int window) {
  using F = fa::FaLayout<D>;
  extern __shared__ uint8_t dq_smem[];
  const uint32_t pad = (1024 - (hopper::smem_u32(dq_smem) & 1023)) & 1023;
  uint8_t* q_s = dq_smem + pad;
  uint8_t* do_s = q_s + F::kQBytes;
  uint8_t* kv_s = do_s + F::kQBytes;  // stage s: K tile, then V tile
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + fa::kFaStages * F::kStageBytes);
  uint64_t* empty = full + fa::kFaStages;

  const int g = H / Hkv;
  const int n_rows = Sq * g;
  const int n_items = B * Hkv * ((n_rows + fa::kFaRows - 1) / fa::kFaRows);
  const float scale2 = scale * fa::kLog2e;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < fa::kFaStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      fa::fa_produce_kv<D>(&tk, &tv, kv_s, full, empty, n_items, B, Hkv, g, n_rows, Skv, causal,
                           window);
  } else {
    hopper::setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const uint32_t q_addr = hopper::smem_u32(q_s) + c * 64 * 128;
    const uint32_t do_addr = hopper::smem_u32(do_s) + c * 64 * 128;
    int gi = 0;  // tiles consumed by this block so far

    for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
      const int it = fa::fa_item_index(k);
      if (it >= n_items) continue;
      const fa::FaItem w = fa::fa_item(it, B, Hkv, g, n_rows, Skv, causal, window);

      // this warpgroup's 64 Q and dO rows; the barrier first lets every warp
      // finish the previous item's products, which read them
      {
        fa::FaRows<D> qv, dv;
        fa::fa_fetch_rows<D>(qv, q, w.b, w.kvh, g, Sq, H, w.r0 + c * 64, n_rows, tid);
        fa::fa_fetch_rows<D>(dv, dout, w.b, w.kvh, g, Sq, H, w.r0 + c * 64, n_rows, tid);
        hopper::named_barrier(1 + c, 128);
        fa::fa_store_rows<D>(q_s + c * 64 * 128, fa::kFaRows * 128, qv, tid);
        fa::fa_store_rows<D>(do_s + c * 64 * 128, fa::kFaRows * 128, dv, tid);
        hopper::fence_proxy_async();
        hopper::named_barrier(1 + c, 128);
      }

      const int R0 = w.r0 + c * 64 + warp * 16 + lane / 4;  // this thread's rows: R0, R0 + 8
      const int pos[2] = {R0 / g, (R0 + 8) / g};
      const int warp_pos_lo = (w.r0 + c * 64 + warp * 16) / g;
      const int warp_pos_hi = (w.r0 + c * 64 + warp * 16 + 15) / g;
      float l2[2], dl[2];
      row_stats(lse, delta, w.b, w.kvh, g, Sq, H, R0, n_rows, &l2[0], &dl[0]);
      row_stats(lse, delta, w.b, w.kvh, g, Sq, H, R0 + 8, n_rows, &l2[1], &dl[1]);
      float dqacc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;

      for (int i = 0; i < w.n_tiles; ++i, ++gi) {
        const int s = gi % fa::kFaStages;
        const int t0 = w.t_begin + i * fa::kFaCols;
        hopper::mbar_wait(&full[s], (gi / fa::kFaStages) & 1);
        const uint32_t k_addr = hopper::smem_u32(kv_s + s * F::kStageBytes);
        const uint32_t v_addr = k_addr + F::kKBytes;

        float sacc[fa::kFaCols / 2], dpacc[fa::kFaCols / 2];
#pragma unroll
        for (int j = 0; j < fa::kFaCols / 2; ++j) sacc[j] = dpacc[j] = 0.f;
        hopper::fence_regs(sacc);
        hopper::fence_regs(dpacc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss<fa::kFaCols, 0>(
              sacc, hopper::desc_sw128(q_addr + (kk / 4) * (fa::kFaRows * 128) + (kk % 4) * 32, 16, 1024),
              hopper::desc_sw128(k_addr + (kk / 4) * fa::kKVBoxBytes + (kk % 4) * 32, 16, 1024), 1);
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss<fa::kFaCols, 0>(
              dpacc, hopper::desc_sw128(do_addr + (kk / 4) * (fa::kFaRows * 128) + (kk % 4) * 32, 16, 1024),
              hopper::desc_sw128(v_addr + (kk / 4) * fa::kKVBoxBytes + (kk % 4) * 32, 16, 1024), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(sacc);

        // P: sacc[4j + e] is row R0 + 8 (e / 2), column t0 + 8j + 2 (lane % 4)
        // + e % 2; tiles that no mask reaches for the warp's rows test nothing
        const bool masked = t0 + fa::kFaCols > Skv || (causal && t0 + fa::kFaCols - 1 > warp_pos_lo) ||
                            (window > 0 && warp_pos_hi - t0 >= window);
#pragma unroll
        for (int j = 0; j < fa::kFaCols / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = hopper::exp2_approx(fmaf(sacc[4 * j + e], scale2, -l2[e >> 1]));
            if (masked) {
              const int t = t0 + 8 * j + 2 * (lane % 4) + (e & 1);
              if (t >= Skv || hidden(pos[e >> 1], t, causal, window)) p = 0.f;
            }
            sacc[4 * j + e] = p;
          }
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dpacc);
        // dS = P (dP - delta) in bf16, the A operand of dQ += dS K
        uint32_t dsf[fa::kFaCols / 16][4];
#pragma unroll
        for (int kk = 0; kk < fa::kFaCols / 16; ++kk) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = 8 * kk + 2 * u;
            dsf[kk][u] = hopper::pack_bf16x2(sacc[j] * (dpacc[j] - dl[u & 1]),
                                             sacc[j + 1] * (dpacc[j + 1] - dl[u & 1]));
          }
        }
        hopper::fence_regs(dqacc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < fa::kFaCols / 16; ++kk)
          hopper::wgmma_rs<D>(dqacc, dsf[kk],
                              hopper::desc_sw128(k_addr + kk * 16 * 128, fa::kKVBoxBytes, 1024), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dqacc);
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      }

#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = R0 + 8 * rr;
        if (r >= n_rows) continue;
        const int h = w.kvh * g + r % g;
        __nv_bfloat16* out = dq + (((size_t)w.b * Sq + pos[rr]) * H + h) * D + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(out + 8 * j) =
              hopper::pack_bf16x2(dqacc[4 * j + 2 * rr] * scale, dqacc[4 * j + 2 * rr + 1] * scale);
      }
    }
  }
}

// 3. dK and dV (wgmma). A work item is 128 KV positions of one (batch, kv
// head), two consumer warpgroups of 64; items are numbered by KV block
// first, so the causal mask's heaviest (the first keys, which every later
// row sees) go first. K and V of the item stay in shared memory (two
// buffers, so the next item's load overlaps this one's work). The producer
// warpgroup streams row tiles through a ring: a row tile is P positions x G
// query heads of the group (P * G <= 64 rows, folded in that order: G = g,
// P = 64 / g when g <= 64; G = 64 heads of one position otherwise, the
// group in ceil(g / 64) chunks), loaded by TMA as one box of a 4-D map over
// (D, H, Sq, B) for Q and for dO, with each row's lse2 and delta beside
// them (+inf and 0 for rows past the tile, the sequence or the group, so
// that their P is 0). Per row tile a warpgroup computes S^T = K Q^T and
// dP^T = V dO^T (shared-memory operands, K-major), P^T = 2^(S^T * scale2 -
// lse2) with the masks, dV += P^T dO (P^T in bf16 registers, dO MN-major),
// dS^T = P^T (dP^T - delta), dK += dS^T Q (dS^T in bf16 registers, Q
// MN-major); dK is scaled once at the end.
constexpr int kKvCols = 128;  // KV positions an item

template <int D>
struct KvLayout {
  static constexpr int kBoxes = D / 64;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kKBytes = kBoxes * kKvCols * 128;  // K (or V) of an item
  static constexpr int kBufBytes = 2 * kKBytes;           // K, then V
  static constexpr int kTileBytes = kBoxes * 64 * 128;    // Q (or dO) of a row tile
  static constexpr int kStageBytes = 2 * kTileBytes + 1024;  // Q, dO, 64 lse2 and 64 delta
  static constexpr int kSmem = 1024 + 2 * kBufBytes + kStages * kStageBytes + (2 * kStages + 4) * 8;
};

struct KvItem {
  int b, kvh, t0, i_begin, n_tiles;
};

// Item it's (batch, kv head), first key, and the row tiles that see one of
// its keys: causal rows sit at positions >= t0, windowed ones at positions
// < the last key + window. Row tile i is position block i / C, head chunk i % C.
__device__ __forceinline__ KvItem kv_item(int it, int B, int Hkv, int Sq, int Skv, int P, int C,
                                          int causal, int window) {
  KvItem w;
  const int bh = it % (B * Hkv);
  w.b = bh / Hkv;
  w.kvh = bh % Hkv;
  w.t0 = (it / (B * Hkv)) * kKvCols;
  int pb_lo = 0, pb_hi = (Sq + P - 1) / P - 1;
  if (causal) pb_lo = w.t0 / P;
  if (window > 0) pb_hi = min(pb_hi, (min(w.t0 + kKvCols, Skv) - 1 + window - 1) / P);
  w.i_begin = pb_lo * C;
  w.n_tiles = pb_hi >= pb_lo ? (pb_hi - pb_lo + 1) * C : 0;
  return w;
}

template <int D>
__global__ void __launch_bounds__(fa::kFaThreads, 1)
fa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B, int Sq,
                  int Skv, int H, int Hkv, float scale, int causal, int window, int P, int G) {
  using L = KvLayout<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t kv_smem[];
  const uint32_t pad = (1024 - (hopper::smem_u32(kv_smem) & 1023)) & 1023;
  uint8_t* kv_s = kv_smem + pad;                  // buffer u: K, then V
  uint8_t* ring = kv_s + 2 * L::kBufBytes;        // stage s: Q tile, dO tile, lse2[64], delta[64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * L::kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;
  uint64_t* kv_empty = kv_full + 2;

  const int g = H / Hkv;
  const int C = (g + G - 1) / G;  // head chunks a position
  const int n_items = B * Hkv * ((Skv + kKvCols - 1) / kKvCols);
  const float scale2 = scale * fa::kLog2e;
  const int wg = threadIdx.x / 128;
  const uint32_t tile_tx = 2 * L::kBoxes * 128 * P * G;  // Q and dO boxes of a row tile

  // Rows P * G .. 63 of a tile are never loaded: zero them once, so that
  // they add nothing to dV and dK.
  for (int i = threadIdx.x; i < kStages * L::kStageBytes / 16; i += fa::kFaThreads)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  hopper::fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1 + 128);  // the TMA's, and every producer thread's statistics
      hopper::mbar_init(&empty[s], 8);       // lane 0 of each consumer warp
    }
    for (int u = 0; u < 2; ++u) {
      hopper::mbar_init(&kv_full[u], 1);
      hopper::mbar_init(&kv_empty[u], 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<24>();
    const int ptid = threadIdx.x;
    int gi = 0, ni = 0;  // row tiles and items loaded by this block so far
    for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
      const int it = fa::fa_item_index(k);
      if (it >= n_items) continue;
      const KvItem w = kv_item(it, B, Hkv, Sq, Skv, P, C, causal, window);
      const int u = ni % 2;
      if (ptid == 0) {
        if (ni >= 2) hopper::mbar_wait(&kv_empty[u], ((ni / 2) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&kv_full[u], L::kBufBytes);
        uint8_t* k_s = kv_s + u * L::kBufBytes;
#pragma unroll
        for (int j = 0; j < L::kBoxes; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint8_t* dst = k_s + j * (kKvCols * 128) + half * fa::kKVBoxBytes;
            hopper::tma_load_4d(dst, &tk, &kv_full[u], 64 * j, w.kvh, w.t0 + 64 * half, w.b);
            hopper::tma_load_4d(dst + L::kKBytes, &tv, &kv_full[u], 64 * j, w.kvh, w.t0 + 64 * half,
                                w.b);
          }
      }
      for (int i = 0; i < w.n_tiles; ++i, ++gi) {
        const int s = gi % kStages;
        if (gi >= kStages) hopper::mbar_wait(&empty[s], ((gi / kStages) - 1) & 1);
        const int tile = w.i_begin + i, pb = tile / C, hc = tile % C;
        uint8_t* q_s = ring + s * L::kStageBytes;
        if (ptid == 0) {
          hopper::mbar_arrive_expect_tx(&full[s], tile_tx);
#pragma unroll
          for (int j = 0; j < L::kBoxes; ++j) {
            hopper::tma_load_4d(q_s + j * 8192, &tq, &full[s], 64 * j, w.kvh * g + hc * G, pb * P, w.b);
            hopper::tma_load_4d(q_s + L::kTileBytes + j * 8192, &tdo, &full[s], 64 * j,
                                w.kvh * g + hc * G, pb * P, w.b);
          }
        }
        // thread rho < 64: lse2 of row rho; thread 64 + rho: its delta
        const int rho = ptid % 64;
        const int sp = pb * P + rho / G, hg = hc * G + rho % G;
        const bool live = rho < P * G && sp < Sq && hg < g;
        const size_t idx = ((size_t)w.b * H + w.kvh * g + hg) * Sq + sp;
        float* stat = reinterpret_cast<float*>(q_s + 2 * L::kTileBytes);
        stat[ptid] = ptid < 64 ? (live ? lse[idx] : INFINITY) : (live ? delta[idx] : 0.f);
        hopper::mbar_arrive(&full[s]);
      }
      ++ni;
    }
  } else {
    // dK and dV (2 x D / 2), S^T and dP^T (2 x 32) and a bf16 operand (16)
    // a thread: 240 registers keep them from spilling at D = 128
    hopper::setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    int gi = 0, ni = 0;
    for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
      const int it = fa::fa_item_index(k);
      if (it >= n_items) continue;
      const KvItem w = kv_item(it, B, Hkv, Sq, Skv, P, C, causal, window);
      const int u = ni % 2;
      hopper::mbar_wait(&kv_full[u], (ni / 2) & 1);
      const uint32_t k_addr = hopper::smem_u32(kv_s + u * L::kBufBytes) + c * 64 * 128;
      const uint32_t v_addr = k_addr + L::kKBytes;
      const int tw0 = w.t0 + 64 * c;             // this warpgroup's keys: tw0 .. tw1
      const int tw1 = min(tw0 + 63, Skv - 1);
      const int T = tw0 + warp * 16 + lane / 4;  // this thread's keys: T, T + 8
      float dkacc[D / 2], dvacc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.f;

      for (int i = 0; i < w.n_tiles; ++i, ++gi) {
        const int s = gi % kStages;
        hopper::mbar_wait(&full[s], (gi / kStages) & 1);
        const int tile = w.i_begin + i, pb = tile / C;
        const int p_lo = pb * P, p_hi = min(p_lo + P, Sq) - 1;  // the tile's positions
        const bool none = tw0 >= Skv || (causal && p_hi < tw0) || (window > 0 && p_lo - tw1 >= window);
        if (!none) {
          const bool masked = (causal && p_lo < tw1) || (window > 0 && p_hi - tw0 >= window);
          uint8_t* q_s = ring + s * L::kStageBytes;
          const uint32_t q_addr = hopper::smem_u32(q_s);
          const uint32_t do_addr = q_addr + L::kTileBytes;
          const float* lse_s = reinterpret_cast<const float*>(q_s + 2 * L::kTileBytes);
          const float* dl_s = lse_s + 64;

          // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 rows a warpgroup
          float st[32], dpt[32];
#pragma unroll
          for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
          hopper::fence_regs(st);
          hopper::fence_regs(dpt);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            hopper::wgmma_ss<64, 0>(
                st, hopper::desc_sw128(k_addr + (kk / 4) * (kKvCols * 128) + (kk % 4) * 32, 16, 1024),
                hopper::desc_sw128(q_addr + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024), 1);
          hopper::wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            hopper::wgmma_ss<64, 0>(
                dpt, hopper::desc_sw128(v_addr + (kk / 4) * (kKvCols * 128) + (kk % 4) * 32, 16, 1024),
                hopper::desc_sw128(do_addr + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024), 1);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();
          hopper::fence_regs(st);

          // P^T: st[4j + e] is key T + 8 (e / 2), row 8j + 2 (lane % 4) + e % 2
          // of the tile
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * (lane % 4));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = hopper::exp2_approx(fmaf(st[4 * j + e], scale2, (e & 1) ? -l2.y : -l2.x));
              if (masked) {
                const int rho = 8 * j + 2 * (lane % 4) + (e & 1);
                if (hidden(p_lo + rho / G, T + 8 * (e >> 1), causal, window)) p = 0.f;
              }
              st[4 * j + e] = p;
            }
          }
          uint32_t af[4][4];  // P^T, then dS^T, in bf16: k-step kk is rows 16kk .. 16kk + 15
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int u2 = 0; u2 < 4; ++u2)
              af[kk][u2] = hopper::pack_bf16x2(st[8 * kk + 2 * u2], st[8 * kk + 2 * u2 + 1]);
          // dV += P^T dO: dO MN-major, 16 rows of 128 bytes a k-step
          hopper::fence_regs(dvacc);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::wgmma_rs<D>(dvacc, af[kk], hopper::desc_sw128(do_addr + kk * 16 * 128, 8192, 1024), 1);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dvacc);
          hopper::fence_regs(dpt);

          // dS^T = P^T (dP^T - delta); dK += dS^T Q
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float2 d0 = *reinterpret_cast<const float2*>(dl_s + 16 * kk + 2 * (lane % 4));
            const float2 d1 = *reinterpret_cast<const float2*>(dl_s + 16 * kk + 8 + 2 * (lane % 4));
#pragma unroll
            for (int u2 = 0; u2 < 4; ++u2) {
              const int j = 8 * kk + 2 * u2;
              const float2 d = u2 < 2 ? d0 : d1;
              af[kk][u2] = hopper::pack_bf16x2(st[j] * (dpt[j] - d.x), st[j + 1] * (dpt[j + 1] - d.y));
            }
          }
          hopper::fence_regs(dkacc);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::wgmma_rs<D>(dkacc, af[kk], hopper::desc_sw128(q_addr + kk * 16 * 128, 8192, 1024), 1);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dkacc);
        }
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      }
      if (lane == 0) hopper::mbar_arrive(&kv_empty[u]);

#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int t = T + 8 * rr;
        if (t >= Skv) continue;
        const size_t off = (((size_t)w.b * Skv + t) * Hkv + w.kvh) * D + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
              hopper::pack_bf16x2(dkacc[4 * j + 2 * rr] * scale, dkacc[4 * j + 2 * rr + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
              hopper::pack_bf16x2(dvacc[4 * j + 2 * rr], dvacc[4 * j + 2 * rr + 1]);
        }
      }
      ++ni;
    }
  }
}

// The wgmma route's launches: the forward with a statistics buffer when the
// caller has none (its O goes to dq, which the dq kernel overwrites), the
// row pass (delta), dQ, then dK and dV. work: 2 * B * H * Sq floats (lse2,
// delta).
template <int D>
int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                     void* dq, void* dk, void* dv, float* work, const float* lse, int B, int Sq,
                     int Skv, int H, int Hkv, float scale, int causal, int window, int sms,
                     cudaStream_t stream) {
  const int g = H / Hkv;
  const int n = B * Sq * H;
  float* delta = work + n;
  int err = 0;
  if (lse == nullptr) {
    err = fa::launch_wgmma<D>(q, k, v, dq, work, B, Sq, Skv, H, Hkv, scale, causal, window, sms, stream);
    if (err != 0) return err;
    lse = work;
  }
  constexpr int kRowsPerBlock = 8 * (32 / (D / 8));
  fa_bwd_delta<D><<<(n + kRowsPerBlock - 1) / kRowsPerBlock, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), delta, n, Sq, H);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  CUtensorMap tk, tv, tq, tdo;
  err = fa::encode_kv_maps<D>(&tk, &tv, k, v, B, Skv, Hkv);
  // Q and dO as (D, H, Sq, B) in boxes of 64 head dims x G heads x P positions
  const int G = g <= 64 ? g : 64, P = g <= 64 ? 64 / g : 1;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2, (cuuint64_t)Sq * H * D * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)G, (cuuint32_t)P, 1};
  if (err == 0) err = hopper::encode_bf16_sw128(&tq, q, 4, dims, strides, box);
  if (err == 0) err = hopper::encode_bf16_sw128(&tdo, dout, 4, dims, strides, box);
  static std::atomic<uint32_t> set_dq{0}, set_kv{0};
  if (err == 0) err = hopper::allow_smem(fa_bwd_dq_wgmma<D>, DqLayout<D>::kSmem, set_dq);
  if (err == 0) err = hopper::allow_smem(fa_bwd_dkdv_wgmma<D>, KvLayout<D>::kSmem, set_kv);
  if (err != 0) return err;

  const int dq_items = B * Hkv * ((Sq * g + fa::kFaRows - 1) / fa::kFaRows);
  fa_bwd_dq_wgmma<D><<<min(dq_items, sms), fa::kFaThreads, DqLayout<D>::kSmem, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(dout), lse,
      delta, static_cast<__nv_bfloat16*>(dq), B, Sq, Skv, H, Hkv, scale, causal, window);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int kv_items = B * Hkv * ((Skv + kKvCols - 1) / kKvCols);
  fa_bwd_dkdv_wgmma<D><<<min(kv_items, sms), fa::kFaThreads, KvLayout<D>::kSmem, stream>>>(
      tk, tv, tq, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B,
      Sq, Skv, H, Hkv, scale, causal, window, P, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MD>
int run_md(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
           void* dk, void* dv, float* work, int B, int Sq, int Skv, int H, int Hkv, int D,
           float scale, int causal, int window, cudaStream_t stream) {
  static std::atomic<uint32_t> set_rows{0}, set_dq{0}, set_dkdv{0};
  const size_t s_rows = rows_smem<MD>() * sizeof(float);
  const size_t s_dq = dq_smem<MD>() * sizeof(float);
  const size_t s_dkdv = dkdv_smem<MD>() * sizeof(float);
  int err = hopper::allow_smem(fa_bwd_rows<T, MD>, static_cast<int>(s_rows), set_rows);
  if (err == 0) err = hopper::allow_smem(fa_bwd_dq<T, MD>, static_cast<int>(s_dq), set_dq);
  if (err == 0) err = hopper::allow_smem(fa_bwd_dkdv<T, MD>, static_cast<int>(s_dkdv), set_dkdv);
  if (err != 0) return err;
  const int g = H / Hkv;
  const int skip_ok = Sq <= Skv ? 1 : 0;
  const size_t n_stat = (size_t)B * H * Sq;
  float* stat_m = work;
  float* stat_l = work + n_stat;
  float* stat_d = work + 2 * n_stat;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const dim3 row_grid(B * Hkv, (Sq * g + kRows - 1) / kRows);
  fa_bwd_rows<T, MD><<<row_grid, kThreads, s_rows, stream>>>(
      tq, tk, static_cast<const T*>(o), tdo, stat_m, stat_l, stat_d, Sq, Skv, H, Hkv, D, scale,
      causal, window, skip_ok);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  fa_bwd_dq<T, MD><<<row_grid, kThreads, s_dq, stream>>>(
      tq, tk, tv, tdo, stat_m, stat_l, stat_d, static_cast<T*>(dq), Sq, Skv, H, Hkv, D, scale,
      causal, window, skip_ok);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 kv_grid(B * Hkv, (Skv + kCols - 1) / kCols);
  fa_bwd_dkdv<T, MD><<<kv_grid, kThreads, s_dkdv, stream>>>(
      tq, tk, tv, tdo, stat_m, stat_l, stat_d, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Skv, H, Hkv, D, scale, causal, window, skip_ok);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
        void* dk, void* dv, float* work, int B, int Sq, int Skv, int H, int Hkv, int D,
        float scale, int causal, int window, cudaStream_t stream) {
  if (D <= 128)
    return run_md<T, 128>(q, k, v, o, dout, dq, dk, dv, work, B, Sq, Skv, H, Hkv, D, scale, causal,
                          window, stream);
  return run_md<T, 256>(q, k, v, o, dout, dq, dk, dv, work, B, Sq, Skv, H, Hkv, D, scale, causal,
                        window, stream);
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Skv, Hkv, D); one dtype, 0 =
// float32, 1 = bfloat16. D <= 256; window = 0: no window. route: 0 = simt
// (work: 3 * B * H * Sq floats of scratch, the row statistics; lse is
// ignored), 1 = wgmma (bfloat16, D = 64 or 128, Sq <= Skv, Sq * H / Hkv >=
// 64, q, k, v, o and dout 16-byte aligned; work: 2 * B * H * Sq floats; lse:
// the forward's statistics, (B, H, Sq) f32 in the convention of
// flash_attention_wgmma.cuh, or null: then the forward runs first to make
// them); anything else is refused. `sms`: the device's SM count, the wgmma
// kernels' most blocks. Three launches on `stream` (four on the wgmma route
// without lse); returns cudaGetLastError() after the last, or the first
// error.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* work,
                                   const void* lse, int B, int Sq, int Skv, int H, int Hkv, int D,
                                   float scale, int causal, int window, int dtype, int route,
                                   int sms, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > kMaxD ||
      window < 0 || work == nullptr || route < 0 || route > 1 || (route == 1 && sms <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  if (route == 1) {
    const bool aligned =
        (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
         reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
    if (dtype != 1 || Sq > Skv || Sq * (H / Hkv) < 64 || !aligned)
      return static_cast<int>(cudaErrorInvalidValue);
    const float* stats = static_cast<const float*>(lse);
    if (D == 64)
      return launch_bwd_wgmma<64>(q, k, v, o, dout, dq, dk, dv, w, stats, B, Sq, Skv, H, Hkv, scale,
                                  causal, window, sms, s);
    if (D == 128)
      return launch_bwd_wgmma<128>(q, k, v, o, dout, dq, dk, dv, w, stats, B, Sq, Skv, H, Hkv, scale,
                                   causal, window, sms, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, w, B, Sq, Skv, H, Hkv, D, scale, causal,
                              window, s);
  if (dtype == 0)
    return run<float>(q, k, v, o, dout, dq, dk, dv, w, B, Sq, Skv, H, Hkv, D, scale, causal, window,
                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}
