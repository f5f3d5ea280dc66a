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
// lengths that is operations over the tensor-core rate. This first version
// runs in f32 SIMT arithmetic (no tensor cores) and recomputes S three times
// and dP twice, so it sits well below that bound: it is the simple, right
// version, and a wgmma route is later work.
//
// Rows are folded as in the forward: row r of a (batch, kv head) is query
// position r / g and query head kvh * g + r % g, g = H / Hkv. Three kernels,
// launched in order on one stream, none with atomics, so the bits depend on
// the shapes only:
//  1. rows: each row's softmax statistics, the running max m and the sum l
//     of exp(s - m) over the keys it sees (its log-sum-exp is m + log l,
//     kept as the pair so that a row the mask hides entirely keeps the
//     forward's uniform weights), and delta = sum_d dO * O;
//  2. dq: a block owns 64 rows and walks the KV tiles they see, as the
//     forward's simt route does: P = exp(s - m) / l, dS = P (dP - delta),
//     dQ += dS K;
//  3. dkdv: a block owns 32 KV positions of one (batch, kv head) and walks
//     the rows that see them in chunks of 32, the g query heads of the kv
//     head included, so a kv head's dK and dV are summed inside one block:
//     dV += P^T dO, dK += dS^T Q.
// Masks are the forward's (flash_attention.cu, fa_kernel): a key past Skv
// contributes nothing; a key the causal or window mask hides keeps the
// finite sentinel -1e30 as its score, so its weight is 0 in a row that sees
// any key and uniform in a row that sees none (only possible when Sq > Skv),
// and its dS is 0, as the gradient of the reference's torch.where is. When
// Sq <= Skv every row sees a key, and tiles or rows that the masks hide from
// a whole block are skipped: that changes only speed. Inputs are f32 or
// bf16, read into f32 shared memory; gradients accumulate in f32 and are
// written in the input type. Tiles come in two sizes, for D <= 128 and D <=
// 256, a template argument chosen by D as in the forward.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
// float32, 1 = bfloat16. work: 3 * B * H * Sq floats of scratch (the row
// statistics). D <= 256; window = 0: no window. Three launches on `stream`;
// returns cudaGetLastError() after the last, or the first error.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* work,
                                   int B, int Sq, int Skv, int H, int Hkv, int D, float scale,
                                   int causal, int window, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > kMaxD ||
      window < 0 || work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, w, B, Sq, Skv, H, Hkv, D, scale, causal,
                              window, s);
  if (dtype == 0)
    return run<float>(q, k, v, o, dout, dq, dk, dv, w, B, Sq, Skv, H, Hkv, D, scale, causal, window,
                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}
