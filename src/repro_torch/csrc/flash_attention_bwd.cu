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
//  * wgmma (bf16, D = 64, 80, 128 or 256, Sq <= Skv, Sq * g >= 64, every
//    tensor 16-byte aligned), three launches, each reading the rows' statistics in
//    the convention of flash_attention_wgmma.cuh (lse2 = m2 + log2(l), log2
//    units of the scaled scores, (B, H, Sq) f32): the forward writes them
//    under autograd; without them a fourth launch, the forward kernel
//    itself (flash_attention_wgmma.cuh), writes them first, with the same
//    bits, so the gradients are the same either way.
//     1. delta: sum_d dO * O of every row, (B, H, Sq) f32;
//     2. dq: the forward's work items (128 rows, two consumer warpgroups;
//        64 rows and one at D = 256) and TMA ring of K/V tiles; per tile S
//        = Q K^T and dP = dO V^T
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
//        consumers; 232 / 40 spilled on the consumers. At D = 256 the two
//        warpgroups split one 64-key item's products instead (KvLayout).
//    D = 80 reads two 64-wide boxes whose head dims past 80 TMA fills with
//    zeros; no product reads them (5 k16 steps, N = 80 wgmma).
//    Blocks are persistent (one an SM) and take the heaviest items first;
//    tiles that no mask reaches skip the mask tests; the masks give P = 0
//    (every row sees a key when Sq <= Skv). Rounding P and dS to bf16 as
//    product operands, with f32 accumulation, is the route's one precision
//    change against the f32 plain version: relative L2 of dQ, dK and dV
//    2.3-2.5e-3 against attention_ref_backward at qwen3-1.7b's and
//    minicpm-2b's training calls on an H100 (chip_smoke.py, which gates it
//    at 2e-2).
//  * simt (f32, fewer than 64 folded rows, Sq > Skv, any other head dim up
//    to 256), f32 arithmetic throughout, three launches:
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
// By positions (the reference attend's mask, flash_attention_wgmma.cuh) both
// routes walk the tiles and rows of the pre-pass's ranges (fa_pos_ranges, a
// launch each for the row blocks and the key blocks), mask every tile
// element by element, and a hidden key's P is 0 on both routes, so a row
// that sees no key (the forward's 0 and -inf) adds nothing to dQ, dK or dV.
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

// Whether key t (< Skv) is hidden from query index s of batch b: by index,
// or by positions (kPos; a row past the last, live false, sees what position
// 0 does: its results are never written).
template <bool kPos>
__device__ __forceinline__ bool masked_at(const int* __restrict__ qp, const int* __restrict__ kp, int b, int Sq,
                                          int Skv, bool live, int s, int t, int causal, int window) {
  if constexpr (kPos) {
    return !fa::visible(live ? qp[(size_t)b * Sq + s] : 0, kp[(size_t)b * Skv + t], causal, window);
  } else {
    return hidden(s, t, causal, window);
  }
}

// The KV tiles a block of folded rows [r0, r0 + kRows) must visit, as the
// forward computes them: all of them unless Sq <= Skv (skip_ok); by
// positions (kPos) the pre-pass's range of block (blockIdx.x / Hkv, blockIdx.y).
template <bool kPos>
__device__ __forceinline__ void kv_range(int r0, int n_rows, int g, int Skv, int causal, int window,
                                         int skip_ok, const int2* rng, int Hkv, int* t_begin, int* t_end) {
  *t_begin = 0;
  *t_end = Skv;
  if constexpr (kPos) {
    const int2 r = rng[blockIdx.x / Hkv * gridDim.y + blockIdx.y];
    *t_begin = r.x * kCols;
    *t_end = min(Skv, r.y * kCols);
  } else if (skip_ok) {
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
template <typename T, int MD, bool kPos>
__global__ void __launch_bounds__(kThreads)
fa_bwd_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
            const T* __restrict__ dout, float* __restrict__ stat_m, float* __restrict__ stat_l,
            float* __restrict__ stat_d, const int* __restrict__ qp, const int* __restrict__ kp,
            const int2* __restrict__ rng, int Sq, int Skv, int H, int Hkv, int D, float scale,
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
  kv_range<kPos>(r0, n_rows, g, Skv, causal, window, skip_ok, rng, Hkv, &t_begin, &t_end);

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
        ps[i * (kCols + 1) + j] = t >= Skv ? -INFINITY
                                  : masked_at<kPos>(qp, kp, b, Sq, Skv, r0 + i < n_rows, s, t, causal, window) ? kNegInf
                                                                                                  : sc[a][c];
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
template <typename T, int MD, bool kPos>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ stat_m,
          const float* __restrict__ stat_l, const float* __restrict__ stat_d, T* __restrict__ dq,
          const int* __restrict__ qp, const int* __restrict__ kp, const int2* __restrict__ rng,
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
  kv_range<kPos>(r0, n_rows, g, Skv, causal, window, skip_ok, rng, Hkv, &t_begin, &t_end);

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
        if (t < Skv && !masked_at<kPos>(qp, kp, b, Sq, Skv, r0 + i < n_rows, s, t, causal, window)) {
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
template <typename T, int MD, bool kPos>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ stat_m,
            const float* __restrict__ stat_l, const float* __restrict__ stat_d,
            T* __restrict__ dk, T* __restrict__ dv, const int* __restrict__ qp,
            const int* __restrict__ kp, const int2* __restrict__ rng, int Sq, int Skv, int H, int Hkv,
            int D, float scale, int causal, int window, int skip_ok) {
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
  if constexpr (kPos) {  // the pre-pass's query positions, as folded rows
    const int2 r = rng[blockIdx.x / Hkv * gridDim.y + blockIdx.y];
    r_begin = r.x * g;
    r_end = min(n_rows, r.y * g);
  } else if (skip_ok) {
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
          if constexpr (kPos) {  // a hidden key's P is 0, also in a row that sees none
            if (!masked_at<kPos>(qp, kp, b, Sq, Skv, true, s, t, causal, window)) {
              p = expf(sc[a][c] - row_m[i]) * row_il[i];
              ds = p * (dp[a][c] - row_d[i]);
            }
          } else if (hidden(s, t, causal, window)) {
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
// Sq) like the statistics. A row takes the power of two of lanes at or above
// its D / 8 16-byte pieces (8 at D = 64, 16 at 80 and 128, 32 at 256), one
// piece a lane, the lanes past the pieces adding 0, summed over the lanes by
// a butterfly in a fixed order. grid = ceil(B * Sq * H / rows a block).
template <int D>
__host__ __device__ constexpr int delta_lanes() {
  return D / 8 <= 8 ? 8 : D / 8 <= 16 ? 16 : 32;
}

template <int D>
__global__ void __launch_bounds__(256)
fa_bwd_delta(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
             float* __restrict__ delta, int n, int Sq, int H) {
  constexpr int kChunks = D / 8;
  constexpr int kLanes = delta_lanes<D>();
  constexpr int kRowsPerWarp = 32 / kLanes;
  const int lane = threadIdx.x % 32;
  const int piece = lane % kLanes;
  const long row = ((long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) * kRowsPerWarp +
                   lane / kLanes;  // (b, s, h) in q's order
  float sum = 0.f;
  if (row < n && piece < kChunks) {
    const size_t off = (size_t)row * D + piece * 8;
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
  for (int off = kLanes / 2; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < n && piece == 0) {
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

// The dq kernel's block: kCons consumer warpgroups of 64 rows and a K/V
// ring of kStages. At D = 256 Q and dO of 128 rows (2 x 64 KiB) and a
// 3-stage ring (3 x 64 KiB) would not fit a block's 227 KB: one consumer of
// 64 rows and 2 stages take 193 KB.
template <int D>
struct DqLayout {
  using F = fa::FaLayout<D>;
  static constexpr int kCons = D > 128 ? 1 : 2;
  static constexpr int kRows = 64 * kCons;  // folded rows an item
  static constexpr int kStages = F::kStages;
  static constexpr int kThreads = 128 * (1 + kCons);
  static constexpr int kQBytes = F::kBoxes * kRows * 128;  // Q (or dO) of an item
  static constexpr int kSmem = 1024 + 2 * kQBytes + kStages * F::kStageBytes + 2 * kStages * 8;
};

// 2. dQ (wgmma): the forward's work items (128 folded rows of one (batch, kv
// head), two consumer warpgroups of 64; at D = 256 64 rows, one consumer)
// and its K/V ring. A warpgroup loads its Q and dO rows once an item; per KV
// tile: S = Q K^T and dP = dO V^T (both operands in shared memory,
// K-major), P = 2^(S * scale2 - lse2) with the masks, dS = P (dP - delta)
// rounded to bf16 in registers, dQ += dS K (K MN-major, the transpose bit).
// dQ is scaled once at the end.
template <int D, bool kPos>
__global__ void __launch_bounds__(DqLayout<D>::kThreads, 1)
fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, const int* __restrict__ qp, const int* __restrict__ kp,
                const int2* __restrict__ rng, const int2* __restrict__ kts, int B, int Sq, int Skv, int H,
                int Hkv, float scale, int causal, int window) {
  using F = fa::FaLayout<D>;
  using L = DqLayout<D>;
  constexpr int kStages = L::kStages, kRows = L::kRows;
  extern __shared__ uint8_t dq_smem[];
  const uint32_t pad = (1024 - (hopper::smem_u32(dq_smem) & 1023)) & 1023;
  uint8_t* q_s = dq_smem + pad;
  uint8_t* do_s = q_s + L::kQBytes;
  uint8_t* kv_s = do_s + L::kQBytes;  // stage s: K tile, then V tile
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + kStages * F::kStageBytes);
  uint64_t* empty = full + kStages;

  const int g = H / Hkv;
  const int n_rows = Sq * g;
  const int n_items = B * Hkv * ((n_rows + kRows - 1) / kRows);
  const float scale2 = scale * fa::kLog2e;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * L::kCons);  // lane 0 of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // one consumer (256 threads a block) may keep up to 255 registers a
    // thread without handing any over
    if constexpr (L::kCons == 2) hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      fa::fa_produce_kv<D, kRows, kStages, kPos>(&tk, &tv, kv_s, full, empty, n_items, B, Hkv, g, n_rows, Skv,
                                                 causal, window, rng);
  } else {
    if constexpr (L::kCons == 2) hopper::setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const uint32_t q_addr = hopper::smem_u32(q_s) + c * 64 * 128;
    const uint32_t do_addr = hopper::smem_u32(do_s) + c * 64 * 128;
    int gi = 0;  // tiles consumed by this block so far

    for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
      const int it = fa::fa_item_index(k);
      if (it >= n_items) continue;
      const fa::FaItem w = fa::fa_item<kRows, kPos>(it, B, Hkv, g, n_rows, Skv, causal, window, rng);

      // this warpgroup's 64 Q and dO rows; the barrier first lets every warp
      // finish the previous item's products, which read them
      {
        fa::FaRows<D> qv, dv;
        fa::fa_fetch_rows<D>(qv, q, w.b, w.kvh, g, Sq, H, w.r0 + c * 64, n_rows, tid);
        fa::fa_fetch_rows<D>(dv, dout, w.b, w.kvh, g, Sq, H, w.r0 + c * 64, n_rows, tid);
        hopper::named_barrier(1 + c, 128);
        fa::fa_store_rows<D>(q_s + c * 64 * 128, kRows * 128, qv, tid);
        fa::fa_store_rows<D>(do_s + c * 64 * 128, kRows * 128, dv, tid);
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
      int qpos[2] = {0, 0};  // by positions: the rows' query positions
      const int* krow = kp + (size_t)w.b * Skv;
      if constexpr (kPos) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          if (R0 + 8 * rr < n_rows) qpos[rr] = __ldg(qp + (size_t)w.b * Sq + pos[rr]);
      }
      const int2 wq = kPos ? fa::warp_positions(qpos, R0, n_rows) : make_int2(0, 0);
      const int2* ktiles = kts + (size_t)w.b * ((Skv + fa::kFaCols - 1) / fa::kFaCols);
      float dqacc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;

      for (int i = 0; i < w.n_tiles; ++i, ++gi) {
        const int s = gi % kStages;
        const int t0 = w.t_begin + i * fa::kFaCols;
        hopper::mbar_wait(&full[s], (gi / kStages) & 1);
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
              sacc, hopper::desc_sw128(q_addr + (kk / 4) * (kRows * 128) + (kk % 4) * 32, 16, 1024),
              hopper::desc_sw128(k_addr + (kk / 4) * fa::kKVBoxBytes + (kk % 4) * 32, 16, 1024), 1);
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss<fa::kFaCols, 0>(
              dpacc, hopper::desc_sw128(do_addr + (kk / 4) * (kRows * 128) + (kk % 4) * 32, 16, 1024),
              hopper::desc_sw128(v_addr + (kk / 4) * fa::kKVBoxBytes + (kk % 4) * 32, 16, 1024), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(sacc);

        // P: sacc[4j + e] is row R0 + 8 (e / 2), column t0 + 8j + 2 (lane % 4)
        // + e % 2; tiles that no mask reaches for the warp's rows test nothing
        const bool masked =
            kPos ? !fa::tile_visible(ktiles[t0 / fa::kFaCols], t0, Skv, wq.x, wq.y, causal, window)
                            : t0 + fa::kFaCols > Skv || (causal && t0 + fa::kFaCols - 1 > warp_pos_lo) ||
                                  (window > 0 && warp_pos_hi - t0 >= window);
        if (kPos && masked) {  // by positions, element by element
#pragma unroll
          for (int j = 0; j < fa::kFaCols / 8; ++j) {
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int t = t0 + 8 * j + 2 * (lane % 4) + cc;
              const int kpos = t < Skv ? __ldg(krow + t) : -1;
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) {
                const int e = 2 * rr + cc;
                const float p = hopper::exp2_approx(fmaf(sacc[4 * j + e], scale2, -l2[rr]));
                sacc[4 * j + e] = fa::visible(qpos[rr], kpos, causal, window) ? p : 0.f;
              }
            }
          }
        } else {
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

// 3. dK and dV (wgmma). A work item is kCols KV positions of one (batch, kv
// head); items are numbered by KV block first, so the causal mask's heaviest
// (the first keys, which every later row sees) go first. K and V of the item
// stay in shared memory (two buffers at D <= 128, so the next item's load
// overlaps this one's work). The producer warpgroup streams row tiles
// through a ring: a row tile is P positions x G query heads of the group (P
// * G <= 64 rows, folded in that order: G = g, P = 64 / g when g <= 64; G =
// 64 heads of one position otherwise, the group in ceil(g / 64) chunks),
// loaded by TMA as one box of a 4-D map over (D, H, Sq, B) for Q and for dO,
// with each row's lse2 and delta beside them (+inf and 0 for rows past the
// tile, the sequence or the group, so that their P is 0). Per row tile:
// S^T = K Q^T and dP^T = V dO^T (shared-memory operands, K-major), P^T =
// 2^(S^T * scale2 - lse2) with the masks, dV += P^T dO (P^T in bf16
// registers, dO MN-major), dS^T = P^T (dP^T - delta), dK += dS^T Q (dS^T in
// bf16 registers, Q MN-major); dK is scaled once at the end.
//  * D <= 128: an item is 128 keys, and each consumer warpgroup runs all of
//    that for its 64.
//  * D = 256 (kSplit): dK and dV of 64 keys are 2 x 128 f32 a thread, more
//    than the 255 registers a thread may have, so the two consumer
//    warpgroups split the products of one 64-key item instead: warpgroup 0
//    computes S^T and P^T and accumulates dV; it hands P^T (f32, 16 KiB)
//    through shared memory to warpgroup 1, which computes dP^T, forms dS^T
//    and accumulates dK (named barriers 1 and 2: P^T written, read). Each
//    keeps one 128-register accumulator. K and V of the item (64 KiB) take
//    one buffer and the ring 2 stages of 65 KiB: 211 KB. Splitting D in two
//    halves instead would compute S^T and dP^T twice. recurrentgemma-9b has
//    one KV head, so its 4 x 1024 call has only 64 such items for 132 SMs,
//    the first of which sees all 1,024 x 16 rows: the rows of each key block
//    are cut into R contiguous runs of row tiles (R = chunks, the wrapper's
//    rule of shapes, fa_bwd_row_chunks), each an item of its own that writes
//    f32 partial sums of dK and dV; a last pass (fa_bwd_sum_chunks) adds
//    the R partials in order, so no atomics and the same bits every call.
template <int D>
struct KvLayout {
  static constexpr bool kSplit = D > 128;
  static constexpr int kBoxes = (D + 63) / 64;
  static constexpr int kCols = kSplit ? 64 : 128;  // KV positions an item
  static constexpr int kBufs = kSplit ? 1 : 2;     // K/V buffers
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kKBytes = kBoxes * kCols * 128;   // K (or V) of an item
  static constexpr int kBufBytes = 2 * kKBytes;          // K, then V
  static constexpr int kTileBytes = kBoxes * 64 * 128;   // Q (or dO) of a row tile
  static constexpr int kStageBytes = 2 * kTileBytes + 1024;  // Q, dO, 64 lse2 and 64 delta
  static constexpr int kPBytes = kSplit ? 32 * 128 * 4 : 0;  // P^T handed over: 32 f32 a thread
  static constexpr int kSmem =
      1024 + kBufs * kBufBytes + kStages * kStageBytes + kPBytes + (2 * kStages + 2 * kBufs) * 8;
};

constexpr int kBarPFull = 1, kBarPFree = 2;  // kSplit's P^T hand-over: written, read

struct KvItem {
  int b, kvh, t0, rc, i_begin, n_tiles;
};

// Item it's (batch, kv head), first key, row chunk rc of R, and its run of
// the row tiles that see one of its kCols keys: causal rows sit at
// positions >= t0, windowed ones at positions < the last key + window (by
// positions: the pre-pass's hull of P-position blocks, rng). Row
// tile i is position block i / C, head chunk i % C. Items go by key block
// first (the causal mask's heaviest first), then row chunk.
template <int kCols, bool kPos>
__device__ __forceinline__ KvItem kv_item(int it, int B, int Hkv, int Sq, int Skv, int P, int C,
                                          int causal, int window, int R, const int2* __restrict__ rng) {
  KvItem w;
  const int bh = it % (B * Hkv);
  w.b = bh / Hkv;
  w.kvh = bh % Hkv;
  w.t0 = (it / (B * Hkv) / R) * kCols;
  w.rc = it / (B * Hkv) % R;
  int pb_lo = 0, pb_hi = (Sq + P - 1) / P - 1;
  if constexpr (kPos) {  // the pre-pass's position blocks for this key block
    const int2 r = rng[w.b * ((Skv + kCols - 1) / kCols) + w.t0 / kCols];
    pb_lo = r.x;
    pb_hi = r.y - 1;
  } else {
    if (causal) pb_lo = w.t0 / P;
    if (window > 0) pb_hi = min(pb_hi, (min(w.t0 + kCols, Skv) - 1 + window - 1) / P);
  }
  const int n = pb_hi >= pb_lo ? (pb_hi - pb_lo + 1) * C : 0;
  w.i_begin = pb_lo * C + n * w.rc / R;
  w.n_tiles = n * (w.rc + 1) / R - n * w.rc / R;
  return w;
}

template <int D, bool kPos>
__global__ void __launch_bounds__(fa::kFaThreads, 1)
fa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                  float* __restrict__ part, const int* __restrict__ qp, const int* __restrict__ kp,
                  const int2* __restrict__ rng, int B, int Sq, int Skv, int H, int Hkv, float scale,
                  int causal, int window, int P, int G, int R) {
  using L = KvLayout<D>;
  constexpr int kStages = L::kStages, kCols = L::kCols, kBufs = L::kBufs;
  extern __shared__ uint8_t kv_smem[];
  const uint32_t pad = (1024 - (hopper::smem_u32(kv_smem) & 1023)) & 1023;
  uint8_t* kv_s = kv_smem + pad;                  // buffer u: K, then V
  uint8_t* ring = kv_s + kBufs * L::kBufBytes;    // stage s: Q tile, dO tile, lse2[64], delta[64]
  float* pt_s = reinterpret_cast<float*>(ring + kStages * L::kStageBytes);  // kSplit's P^T
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * L::kStageBytes + L::kPBytes);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;
  uint64_t* kv_empty = kv_full + kBufs;

  const int g = H / Hkv;
  const int C = (g + G - 1) / G;  // head chunks a position
  const int n_items = B * Hkv * ((Skv + kCols - 1) / kCols) * R;
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
    for (int u = 0; u < kBufs; ++u) {
      hopper::mbar_init(&kv_full[u], 1);
      hopper::mbar_init(&kv_empty[u], 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // 128 x 24 + 256 x 240 = 384 x 168, the registers the block launched
    // with: setmaxnreg.inc waits for registers the block's own warps freed
    hopper::setmaxnreg_dec<24>();
    const int ptid = threadIdx.x;
    int gi = 0, ni = 0;  // row tiles and items loaded by this block so far
    for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
      const int it = fa::fa_item_index(k);
      if (it >= n_items) continue;
      const KvItem w = kv_item<kCols, kPos>(it, B, Hkv, Sq, Skv, P, C, causal, window, R, rng);
      const int u = ni % kBufs;
      if (ptid == 0) {
        if (ni >= kBufs) hopper::mbar_wait(&kv_empty[u], ((ni / kBufs) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&kv_full[u], L::kBufBytes);
        uint8_t* k_s = kv_s + u * L::kBufBytes;
#pragma unroll
        for (int j = 0; j < L::kBoxes; ++j)
#pragma unroll
          for (int half = 0; half < kCols / 64; ++half) {
            uint8_t* dst = k_s + j * (kCols * 128) + half * fa::kKVBoxBytes;
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
        // thread rho < 64: lse2 of row rho (and by positions its query
        // position, after the deltas); thread 64 + rho: its delta
        const int rho = ptid % 64;
        const int sp = pb * P + rho / G, hg = hc * G + rho % G;
        const bool live = rho < P * G && sp < Sq && hg < g;
        const size_t idx = ((size_t)w.b * H + w.kvh * g + hg) * Sq + sp;
        float* stat = reinterpret_cast<float*>(q_s + 2 * L::kTileBytes);
        stat[ptid] = ptid < 64 ? (live ? lse[idx] : INFINITY) : (live ? delta[idx] : 0.f);
        if (kPos && ptid < 64)
          reinterpret_cast<int*>(stat)[128 + ptid] = live ? __ldg(qp + (size_t)w.b * Sq + sp) : 0;
        hopper::mbar_arrive(&full[s]);
      }
      ++ni;
    }
  } else {
    // D <= 128: dK and dV (2 x D / 2), S^T and dP^T (2 x 32) and a bf16
    // operand (16) a thread: 240 registers keep them from spilling at D =
    // 128. kSplit: one accumulator (D / 2 = 128), S^T or dP^T (32) and the
    // bf16 operand (16); warpgroup 0's path (S^T, P^T, dV) still spills
    // there, and ptxas serialises its wgmmas (C7512).
    hopper::setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    int gi = 0, ni = 0;
    if constexpr (L::kSplit) {
      if (c == 1) hopper::named_barrier_arrive(kBarPFree, 256);  // P^T's buffer starts free
    }
    for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
      const int it = fa::fa_item_index(k);
      if (it >= n_items) continue;
      const KvItem w = kv_item<kCols, kPos>(it, B, Hkv, Sq, Skv, P, C, causal, window, R, rng);
      const int u = ni % kBufs;
      hopper::mbar_wait(&kv_full[u], (ni / kBufs) & 1);
      // this warpgroup's 64 keys tw0 .. tw1: its half of the item, or (kSplit) all of it
      const int cw = L::kSplit ? 0 : c;
      const uint32_t k_addr = hopper::smem_u32(kv_s + u * L::kBufBytes) + cw * 64 * 128;
      const uint32_t v_addr = k_addr + L::kKBytes;
      const int tw0 = w.t0 + 64 * cw;
      const int tw1 = min(tw0 + 63, Skv - 1);
      const int T = tw0 + warp * 16 + lane / 4;  // this thread's keys: T, T + 8
      int kpos[2] = {-1, -1};  // by positions: their key positions
      if constexpr (kPos) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          if (T + 8 * rr < Skv) kpos[rr] = __ldg(kp + (size_t)w.b * Skv + T + 8 * rr);
      }
      float dkacc[L::kSplit ? 1 : D / 2], dvacc[D / 2];  // kSplit: dvacc holds dV (c = 0) or dK (c = 1)
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dvacc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < (L::kSplit ? 1 : D / 2); ++i) dkacc[i] = 0.f;

      for (int i = 0; i < w.n_tiles; ++i, ++gi) {
        const int s = gi % kStages;
        hopper::mbar_wait(&full[s], (gi / kStages) & 1);
        const int tile = w.i_begin + i, pb = tile / C;
        const int p_lo = pb * P, p_hi = min(p_lo + P, Sq) - 1;  // the tile's positions
        const bool none = tw0 >= Skv || (!kPos && ((causal && p_hi < tw0) || (window > 0 && p_lo - tw1 >= window)));
        if (!none) {
          const bool masked = kPos || (causal && p_lo < tw1) || (window > 0 && p_hi - tw0 >= window);
          uint8_t* q_s = ring + s * L::kStageBytes;
          const uint32_t q_addr = hopper::smem_u32(q_s);
          const uint32_t do_addr = q_addr + L::kTileBytes;
          const float* lse_s = reinterpret_cast<const float*>(q_s + 2 * L::kTileBytes);
          const float* dl_s = lse_s + 64;
          const int* qpos_s = reinterpret_cast<const int*>(lse_s + 128);  // by positions
          if constexpr (L::kSplit) {
            // warpgroup 0: S^T = K Q^T, P^T, dV += P^T dO; warpgroup 1: dP^T =
            // V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q
            float st[32];
#pragma unroll
            for (int j = 0; j < 32; ++j) st[j] = 0.f;
            hopper::fence_regs(st);
            hopper::wgmma_fence();
            const uint32_t a_addr = c == 0 ? k_addr : v_addr, b_addr = c == 0 ? q_addr : do_addr;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
              hopper::wgmma_ss<64, 0>(
                  st, hopper::desc_sw128(a_addr + (kk / 4) * (kCols * 128) + (kk % 4) * 32, 16, 1024),
                  hopper::desc_sw128(b_addr + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024), 1);
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs(st);
            uint32_t af[4][4];
            if (c == 0) {
              // P^T: st[4j + e] is key T + 8 (e / 2), row 8j + 2 (lane % 4) + e % 2
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * (lane % 4));
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  float p = hopper::exp2_approx(fmaf(st[4 * j + e], scale2, (e & 1) ? -l2.y : -l2.x));
                  if (masked) {
                    const int rho = 8 * j + 2 * (lane % 4) + (e & 1);
                    if (kPos ? !fa::visible(qpos_s[rho], kpos[e >> 1], causal, window)
                                      : hidden(p_lo + rho / G, T + 8 * (e >> 1), causal, window))
                      p = 0.f;
                  }
                  st[4 * j + e] = p;
                }
              }
              // the same fragment is warpgroup 1's dP^T: hand it over thread for thread
              hopper::named_barrier(kBarPFree, 256);
#pragma unroll
              for (int j = 0; j < 32; ++j) pt_s[j * 128 + tid] = st[j];
              hopper::named_barrier_arrive(kBarPFull, 256);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int u2 = 0; u2 < 4; ++u2)
                  af[kk][u2] = hopper::pack_bf16x2(st[8 * kk + 2 * u2], st[8 * kk + 2 * u2 + 1]);
            } else {
              // P^T read as it is used, so that it never takes 32 registers
              // beside dK (128) and dP^T (32)
              hopper::named_barrier(kBarPFull, 256);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const float2 d0 = *reinterpret_cast<const float2*>(dl_s + 16 * kk + 2 * (lane % 4));
                const float2 d1 = *reinterpret_cast<const float2*>(dl_s + 16 * kk + 8 + 2 * (lane % 4));
#pragma unroll
                for (int u2 = 0; u2 < 4; ++u2) {
                  const int j = 8 * kk + 2 * u2;
                  const float2 d = u2 < 2 ? d0 : d1;
                  af[kk][u2] = hopper::pack_bf16x2(pt_s[j * 128 + tid] * (st[j] - d.x),
                                                   pt_s[(j + 1) * 128 + tid] * (st[j + 1] - d.y));
                }
              }
              hopper::named_barrier_arrive(kBarPFree, 256);
            }
            // dV += P^T dO (c = 0) or dK += dS^T Q (c = 1): MN-major, 16 rows of 128 bytes a k-step
            const uint32_t n_addr = c == 0 ? do_addr : q_addr;
            hopper::fence_regs(dvacc);
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              hopper::wgmma_rs<D>(dvacc, af[kk], hopper::desc_sw128(n_addr + kk * 16 * 128, 8192, 1024), 1);
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs(dvacc);
          } else {
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
                  st, hopper::desc_sw128(k_addr + (kk / 4) * (kCols * 128) + (kk % 4) * 32, 16, 1024),
                  hopper::desc_sw128(q_addr + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024), 1);
            hopper::wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
              hopper::wgmma_ss<64, 0>(
                  dpt, hopper::desc_sw128(v_addr + (kk / 4) * (kCols * 128) + (kk % 4) * 32, 16, 1024),
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
                  if (kPos ? !fa::visible(qpos_s[rho], kpos[e >> 1], causal, window)
                                    : hidden(p_lo + rho / G, T + 8 * (e >> 1), causal, window))
                    p = 0.f;
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
        }
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      }
      if (lane == 0) hopper::mbar_arrive(&kv_empty[u]);

#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int t = T + 8 * rr;
        if (t >= Skv) continue;
        const size_t off = (((size_t)w.b * Skv + t) * Hkv + w.kvh) * D + 2 * (lane % 4);
        if constexpr (L::kSplit) {
          if (R > 1) {  // this chunk's f32 partial: part[rc][dK, dV][B][Skv][Hkv][D], dK unscaled
            float* dst = part + (size_t)(2 * w.rc + (c == 0)) * B * Skv * Hkv * D + off;
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
              *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(dvacc[4 * j + 2 * rr], dvacc[4 * j + 2 * rr + 1]);
            continue;
          }
          __nv_bfloat16* dst = (c == 0 ? dv : dk) + off;
          const float mul = c == 0 ? 1.f : scale;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(dst + 8 * j) =
                hopper::pack_bf16x2(dvacc[4 * j + 2 * rr] * mul, dvacc[4 * j + 2 * rr + 1] * mul);
        } else {
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
                hopper::pack_bf16x2(dkacc[4 * j + 2 * rr] * scale, dkacc[4 * j + 2 * rr + 1] * scale);
            *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
                hopper::pack_bf16x2(dvacc[4 * j + 2 * rr], dvacc[4 * j + 2 * rr + 1]);
          }
        }
      }
      ++ni;
    }
    // kSplit: warpgroup 1's last arrival on the free barrier, so that no
    // barrier is left half arrived
    if constexpr (L::kSplit) {
      if (c == 0) hopper::named_barrier(kBarPFree, 256);
    }
  }
}

// The row chunks' sum (kSplit with R > 1): dk = scale * sum_r part[r][0],
// dv = sum_r part[r][1], r in order, in bf16; n = B * Skv * Hkv * D, 4
// elements a thread.
__global__ void __launch_bounds__(256)
fa_bwd_sum_chunks(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, long n, int R, float scale) {
  const long i = ((long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int r = 0; r < R; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(part + (size_t)(2 * r) * n + i);
    const float4 b = *reinterpret_cast<const float4*>(part + (size_t)(2 * r + 1) * n + i);
    sk = make_float4(sk.x + a.x, sk.y + a.y, sk.z + a.z, sk.w + a.w);
    sv = make_float4(sv.x + b.x, sv.y + b.y, sv.z + b.z, sv.w + b.w);
  }
  *reinterpret_cast<uint2*>(dk + i) =
      make_uint2(hopper::pack_bf16x2(sk.x * scale, sk.y * scale), hopper::pack_bf16x2(sk.z * scale, sk.w * scale));
  *reinterpret_cast<uint2*>(dv + i) = make_uint2(hopper::pack_bf16x2(sv.x, sv.y), hopper::pack_bf16x2(sv.z, sv.w));
}

// The wgmma route's launches: the forward with a statistics buffer when the
// caller has none (its O goes to dq, which the dq kernel overwrites), the
// row pass (delta), dQ, then dK and dV (and at R > 1 the chunks' sum).
// work: 2 * B * H * Sq floats (lse2, delta); part: R x 2 x B * Skv * Hkv * D
// floats when R > 1. By positions (qp, kp) rng takes the pre-pass's ranges
// of the forward's items (when it runs), of dq's and of dkdv's, in turn.
template <int D>
int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                     void* dq, void* dk, void* dv, float* work, const float* lse, float* part, int R,
                     const int* qp, const int* kp, int2* rng, int B, int Sq, int Skv, int H, int Hkv,
                     float scale, int causal, int window, int sms, cudaStream_t stream) {
  const int g = H / Hkv;
  const int n = B * Sq * H;
  float* delta = work + n;
  int err = 0;
  int2* kts = nullptr;  // by positions: the 64-key tiles' positions, then the ranges
  if (rng != nullptr) {
    kts = rng;
    rng += B * ((Skv + fa::kFaCols - 1) / fa::kFaCols);
  }
  if (lse == nullptr) {
    err = fa::launch_wgmma<D>(q, k, v, dq, work, qp, kp, rng, kts, B, Sq, Skv, H, Hkv, scale, causal, window,
                              sms, stream);
    if (err != 0) return err;
    lse = work;
    if (rng != nullptr) rng += B * ((Sq * g + fa::kFaRows - 1) / fa::kFaRows);
  } else if (qp != nullptr) {
    err = fa::launch_pos_tiles(kp, B, Skv, kts, stream);
    if (err != 0) return err;
  }
  constexpr int kRowsPerBlock = 8 * (32 / delta_lanes<D>());
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
  static std::atomic<uint32_t> set_dq{0}, set_kv{0}, set_dq_pos{0}, set_kv_pos{0};
  const bool by_pos = qp != nullptr;
  auto dq_kernel = by_pos ? fa_bwd_dq_wgmma<D, true> : fa_bwd_dq_wgmma<D, false>;
  auto kv_kernel = by_pos ? fa_bwd_dkdv_wgmma<D, true> : fa_bwd_dkdv_wgmma<D, false>;
  if (err == 0) err = hopper::allow_smem(dq_kernel, DqLayout<D>::kSmem, by_pos ? set_dq_pos : set_dq);
  if (err == 0) err = hopper::allow_smem(kv_kernel, KvLayout<D>::kSmem, by_pos ? set_kv_pos : set_kv);
  // by positions: dq's row blocks' tiles, then dkdv's key blocks' position blocks of P
  int2* rng_dq = rng;
  int2* rng_kv = rng == nullptr ? nullptr : rng + B * ((Sq * g + DqLayout<D>::kRows - 1) / DqLayout<D>::kRows);
  if (err == 0 && qp != nullptr)
    err = fa::launch_pos_ranges(qp, kp, B, Sq, Skv, g, 1, DqLayout<D>::kRows, fa::kFaCols, causal, window, rng_dq,
                                stream);
  if (err == 0 && qp != nullptr)
    err = fa::launch_pos_ranges(qp, kp, B, Sq, Skv, g, 0, KvLayout<D>::kCols, P, causal, window, rng_kv, stream);
  if (err != 0) return err;

  const int dq_items = B * Hkv * ((Sq * g + DqLayout<D>::kRows - 1) / DqLayout<D>::kRows);
  dq_kernel<<<min(dq_items, sms), DqLayout<D>::kThreads, DqLayout<D>::kSmem, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(dout), lse,
      delta, static_cast<__nv_bfloat16*>(dq), qp, kp, rng_dq, kts, B, Sq, Skv, H, Hkv, scale, causal, window);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int kv_items = B * Hkv * ((Skv + KvLayout<D>::kCols - 1) / KvLayout<D>::kCols) * R;
  kv_kernel<<<min(kv_items, sms), fa::kFaThreads, KvLayout<D>::kSmem, stream>>>(
      tk, tv, tq, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), part, qp,
      kp, rng_kv, B, Sq, Skv, H, Hkv, scale, causal, window, P, G, R);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || R == 1) return err;
  const long n_kv = (long)B * Skv * Hkv * D;
  fa_bwd_sum_chunks<<<(unsigned)((n_kv / 4 + 255) / 256), 256, 0, stream>>>(
      part, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n_kv, R, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MD>
int run_md(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
           void* dk, void* dv, float* work, const int* qp, const int* kp, int2* rng, int B, int Sq, int Skv,
           int H, int Hkv, int D, float scale, int causal, int window, cudaStream_t stream) {
  static std::atomic<uint32_t> set_rows{0}, set_dq{0}, set_dkdv{0}, set_rows_pos{0}, set_dq_pos{0}, set_dkdv_pos{0};
  const size_t s_rows = rows_smem<MD>() * sizeof(float);
  const size_t s_dq = dq_smem<MD>() * sizeof(float);
  const size_t s_dkdv = dkdv_smem<MD>() * sizeof(float);
  const bool by_pos = qp != nullptr;
  auto rows_kernel = by_pos ? fa_bwd_rows<T, MD, true> : fa_bwd_rows<T, MD, false>;
  auto dq_kernel = by_pos ? fa_bwd_dq<T, MD, true> : fa_bwd_dq<T, MD, false>;
  auto dkdv_kernel = by_pos ? fa_bwd_dkdv<T, MD, true> : fa_bwd_dkdv<T, MD, false>;
  int err = hopper::allow_smem(rows_kernel, static_cast<int>(s_rows), by_pos ? set_rows_pos : set_rows);
  if (err == 0) err = hopper::allow_smem(dq_kernel, static_cast<int>(s_dq), by_pos ? set_dq_pos : set_dq);
  if (err == 0) err = hopper::allow_smem(dkdv_kernel, static_cast<int>(s_dkdv), by_pos ? set_dkdv_pos : set_dkdv);
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
  const dim3 kv_grid(B * Hkv, (Skv + kCols - 1) / kCols);
  // by positions: the row blocks' tiles, then the key blocks' query positions
  int2* rng_rows = nullptr;
  int2* rng_kv = nullptr;
  if (qp != nullptr) {
    rng_rows = rng;
    rng_kv = rng + B * row_grid.y;
    err = fa::launch_pos_ranges(qp, kp, B, Sq, Skv, g, 1, kRows, kCols, causal, window, rng_rows, stream);
    if (err == 0) err = fa::launch_pos_ranges(qp, kp, B, Sq, Skv, g, 0, kCols, 1, causal, window, rng_kv, stream);
    if (err != 0) return err;
  }
  rows_kernel<<<row_grid, kThreads, s_rows, stream>>>(
      tq, tk, static_cast<const T*>(o), tdo, stat_m, stat_l, stat_d, qp, kp, rng_rows, Sq, Skv, H, Hkv, D,
      scale, causal, window, skip_ok);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dq_kernel<<<row_grid, kThreads, s_dq, stream>>>(
      tq, tk, tv, tdo, stat_m, stat_l, stat_d, static_cast<T*>(dq), qp, kp, rng_rows, Sq, Skv, H, Hkv, D,
      scale, causal, window, skip_ok);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dkdv_kernel<<<kv_grid, kThreads, s_dkdv, stream>>>(
      tq, tk, tv, tdo, stat_m, stat_l, stat_d, static_cast<T*>(dk), static_cast<T*>(dv), qp, kp, rng_kv, Sq,
      Skv, H, Hkv, D, scale, causal, window, skip_ok);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
        void* dk, void* dv, float* work, const int* qp, const int* kp, int2* rng, int B, int Sq, int Skv,
        int H, int Hkv, int D, float scale, int causal, int window, cudaStream_t stream) {
  if (D <= 128)
    return run_md<T, 128>(q, k, v, o, dout, dq, dk, dv, work, qp, kp, rng, B, Sq, Skv, H, Hkv, D, scale,
                          causal, window, stream);
  return run_md<T, 256>(q, k, v, o, dout, dq, dk, dv, work, qp, kp, rng, B, Sq, Skv, H, Hkv, D, scale,
                        causal, window, stream);
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Skv, Hkv, D); one dtype, 0 =
// float32, 1 = bfloat16. D <= 256; window = 0: no window. route: 0 = simt
// (work: 3 * B * H * Sq floats of scratch, the row statistics; lse is
// ignored), 1 = wgmma (bfloat16, D = 64, 80, 128 or 256, Sq <= Skv, Sq * H /
// Hkv >= 64, q, k, v, o and dout 16-byte aligned; work: 2 * B * H * Sq floats; lse:
// the forward's statistics, (B, H, Sq) f32 in the convention of
// flash_attention_wgmma.cuh, or null: then the forward runs first to make
// them); anything else is refused. chunks: the dK/dV kernel's row chunks,
// 1 but on the wgmma route at D = 256, where up to 4 take part: chunks x 2
// x B * Skv * Hkv * D floats of scratch for their partial sums. `sms`: the
// device's SM count, the wgmma kernels' most blocks. qpos, kvpos: null (the
// index), or int32 (B, Sq) and (B, Skv) positions, with ranges scratch of B *
// (2 * ceil(Sq * H / Hkv / 64) + 2 * ceil(Skv / 32)) int pairs for the
// pre-passes' ranges and tiles' positions. Three launches on `stream` (one
// more on the wgmma route without lse, one at chunks > 1, and by positions
// a pre-pass for each kernel's blocks and, on the wgmma route, one for the
// tiles' positions); returns cudaGetLastError() after the last, or the first
// error.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* work,
                                   const void* lse, void* part, const void* qpos, const void* kvpos,
                                   void* ranges, int B, int Sq, int Skv, int H, int Hkv, int D, float scale,
                                   int causal, int window, int dtype, int route, int chunks, int sms,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > kMaxD ||
      window < 0 || work == nullptr || route < 0 || route > 1 || (route == 1 && sms <= 0) ||
      chunks < 1 || chunks > 4 || (chunks > 1 && (route != 1 || D != 256 || part == nullptr)) ||
      ((qpos == nullptr) != (kvpos == nullptr)) || (qpos != nullptr && ranges == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kvpos);
  int2* rng = static_cast<int2*>(ranges);
  if (route == 1) {
    const bool aligned =
        (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
         reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
    if (dtype != 1 || Sq > Skv || Sq * (H / Hkv) < 64 || !aligned)
      return static_cast<int>(cudaErrorInvalidValue);
    const float* stats = static_cast<const float*>(lse);
    if (D == 64)
      return launch_bwd_wgmma<64>(q, k, v, o, dout, dq, dk, dv, w, stats, static_cast<float*>(part),
                                  chunks, qp, kp, rng, B, Sq, Skv, H, Hkv, scale, causal, window, sms, s);
    if (D == 80)
      return launch_bwd_wgmma<80>(q, k, v, o, dout, dq, dk, dv, w, stats, static_cast<float*>(part),
                                  chunks, qp, kp, rng, B, Sq, Skv, H, Hkv, scale, causal, window, sms, s);
    if (D == 128)
      return launch_bwd_wgmma<128>(q, k, v, o, dout, dq, dk, dv, w, stats, static_cast<float*>(part),
                                   chunks, qp, kp, rng, B, Sq, Skv, H, Hkv, scale, causal, window, sms, s);
    if (D == 256)
      return launch_bwd_wgmma<256>(q, k, v, o, dout, dq, dk, dv, w, stats, static_cast<float*>(part),
                                   chunks, qp, kp, rng, B, Sq, Skv, H, Hkv, scale, causal, window, sms, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, w, qp, kp, rng, B, Sq, Skv, H, Hkv, D, scale,
                              causal, window, s);
  if (dtype == 0)
    return run<float>(q, k, v, o, dout, dq, dk, dv, w, qp, kp, rng, B, Sq, Skv, H, Hkv, D, scale, causal,
                      window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
