// Online-softmax attention for Hopper (sm_90a), causal, sliding-window or
// bidirectional, with grouped KV heads.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, flash_attention /
// _fa_kernel, a (B*Hkv, Sq/bq) Pallas grid whose body loops over KV blocks
// with a running max and denominator in f32.
//
// Bound on this card: at prefill lengths the QK^T and PV products dominate
// (4*Sq*Skv*H*D flops, halved by the causal mask), so the time is operations
// over the peak rate; at the live step (Sq = Skv = 1) it is a few KiB of
// q/k/v and the launch itself.
//
// Design: one block per (batch * kv head, tile of 64 rows), where a row is one
// (query position, query head of the group): the g = H / Hkv query heads that
// share a KV head are folded into the rows, so K and V tiles are loaded once
// for the whole group. The block walks KV tiles of 32 positions through shared
// memory; scores, the running max m, the denominator l and the output
// accumulator stay in f32 (registers and shared memory), so the (Sq, Skv)
// score matrix never reaches device memory. This is plain SIMT f32 arithmetic,
// not yet tensor cores (wgmma and TMA come later).
// Masking keeps the reference's finite sentinel -1e30 and max(l, 1e-30): a
// window can mask every column of a row's first tile, where -inf would give
// exp(-inf + inf) = NaN; with -1e30 the next visible score rescales that tile
// away. Columns past Skv are -inf and contribute exactly 0. When Sq <= Skv
// every row sees at least one key, so tiles that the causal or window mask
// hides from every row of the block are skipped: that changes only speed.
// Any Sq and Skv; head dim D <= 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kRows = 64;      // rows (query position x group head) per block
constexpr int kCols = 32;      // KV positions per tile
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;  // the reference's masked-score sentinel

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr size_t kSmemFloats =
    kRows * kMaxD            // q tile, pre-scaled
    + kCols * (kMaxD + 1)    // k tile (+1 pad: threads read different rows)
    + kCols * kMaxD          // v tile
    + kRows * (kCols + 1)    // scores, then probabilities
    + 3 * kRows;             // running max, denominator, rescale factor

// q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D); o like q. grid = (B*Hkv, ceil(Sq*g/64)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int Sq, int Skv, int H, int Hkv, int D, float scale,
          int causal, int window, int skip_ok) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kRows * kMaxD;
  float* vs = ks + kCols * (kMaxD + 1);
  float* ps = vs + kCols * kMaxD;
  float* row_m = ps + kRows * (kCols + 1);
  float* row_l = row_m + kRows;
  float* row_alpha = row_l + kRows;

  const int g = H / Hkv;
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int n_rows = Sq * g;
  const int r0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const int r = r0 + i;
    float val = 0.f;
    if (r < n_rows) {
      const int s = r / g, h = kvh * g + r % g;
      val = to_float(q[(((size_t)b * Sq + s) * H + h) * D + d]) * scale;
    }
    qs[i * kMaxD + d] = val;
  }
  if (tid < kRows) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  // KV range this block must visit.
  const int s_lo = r0 / g;
  const int s_hi = (min(n_rows, r0 + kRows) - 1) / g;
  int t_begin = 0, t_end = Skv;
  if (skip_ok) {
    if (causal) t_end = min(Skv, s_hi + 1);
    if (window > 0) t_begin = (max(0, s_lo - window + 1) / kCols) * kCols;
  }

  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;

  for (int t0 = t_begin; t0 < t_end; t0 += kCols) {
    __syncthreads();  // q tile and stats written; previous tile fully consumed
    for (int idx = tid; idx < kCols * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int t = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (t < Skv) {
        const size_t off = (((size_t)b * Skv + t) * Hkv + kvh) * D + d;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      ks[j * (kMaxD + 1) + d] = kv;
      vs[j * kMaxD + d] = vv;
    }
    __syncthreads();

    // Scores: rows ty + 16a, columns tx + 16c.
    float sc[4][2] = {};
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[2];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qs[(ty + 16 * a) * kMaxD + d];
#pragma unroll
      for (int c = 0; c < 2; ++c) kb[c] = ks[(tx + 16 * c) * (kMaxD + 1) + d];
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
        const int j = tx + 16 * c;
        const int t = t0 + j;
        float val = sc[a][c];
        if (t >= Skv) {
          val = -INFINITY;
        } else if ((causal && s < t) || (window > 0 && s - t >= window)) {
          val = kNegInf;
        }
        ps[i * (kCols + 1) + j] = val;
      }
    }
    __syncthreads();

    // Online softmax: warp w updates rows 8w .. 8w+7; lane = column.
    for (int rr = 0; rr < kRows / 8; ++rr) {
      const int i = warp * (kRows / 8) + rr;
      const float val = ps[i * (kCols + 1) + lane];
      float mx = val;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[i];
      const float m_new = fmaxf(m_old, mx);
      const float p = __expf(val - m_new);
      ps[i * (kCols + 1) + lane] = p;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        row_l[i] = row_l[i] * alpha + sum;
        row_m[i] = m_new;
        row_alpha[i] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: rows ty + 16a, head dims tx + 16c.
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      const float alpha = row_alpha[i];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] *= alpha;
      for (int j = 0; j < kCols; ++j) {
        const float p = ps[i * (kCols + 1) + j];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int d = tx + 16 * c;
          if (d < D) acc[a][c] = fmaf(p, vs[j * kMaxD + d], acc[a][c]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    const int r = r0 + i;
    if (r >= n_rows) continue;
    const int s = r / g, h = kvh * g + r % g;
    const float inv = 1.f / fmaxf(row_l[i], 1e-30f);
    T* out = o + (((size_t)b * Sq + s) * H + h) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(out + d, acc[a][c] * inv);
    }
  }
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int H,
        int Hkv, int D, float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fa_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = H / Hkv;
  dim3 grid(B * Hkv, (Sq * g + kRows - 1) / kRows);
  fa_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, Hkv, D, scale, causal, window, Sq <= Skv ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// window = 0: no window. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int Sq, int Skv, int H, int Hkv, int D, float scale,
                               int causal, int window, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > kMaxD ||
      window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, Hkv, D, scale, causal, window, s);
  if (dtype == 0)
    return run<float>(q, k, v, o, B, Sq, Skv, H, Hkv, D, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
