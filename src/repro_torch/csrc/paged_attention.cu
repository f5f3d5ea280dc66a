// Paged-KV decode attention for Hopper (sm_90a): one query token per sequence
// against a KV cache kept in a page pool and read through a page table.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py, paged_attention /
// _pa_kernel, a Pallas grid over B, called once per KV head, whose body walks
// ceil(len / page_tokens) pages of the pool with an f32 online softmax.
//
// Bound on this card: a decode call does 4 flops for every K/V element it
// reads (2 for q.k, 2 for p.v), far below the ~295 flop/byte where the tensor
// cores become the limit. The least time is the K/V bytes of the valid pages
// (ceil(len / pt) pages of pt * D elements, for K and for V, per sequence and
// KV head) over the HBM rate.
//
// Design: one launch, grid (B, Hkv, ceil(g / G)) with G = 8 at most. A block
// serves the g = H / Hkv query heads of one KV head of one sequence (any g,
// llama3.2's 3 included), so every K and V row it loads is used by the whole
// group. The block reads its sequence's length and page ids itself. Its warps
// split the sequence's tokens (in each round of kUnroll * kWarps tokens, token
// base + u * kWarps + w goes to warp w), so the page walk needs no barrier;
// each warp keeps its own f32 running max m, denominator l and accumulator,
// with lane i holding head dims 4i .. 4i+3 (K and V rows in 8- or 16-byte
// loads when D % 4 == 0 and the pool is aligned). A row walks no token at or
// past its length, so no page past ceil(len / pt). At the end the warps'
// states are merged through shared memory in warp order: no atomics, the same
// bits on every run. Masked slots carry the reference's finite -1e30, and the
// output is acc / max(l, 1e-30), so a row of length 0 writes zeros, as the
// Pallas kernel does.
// What bounds this design: only B * Hkv blocks (32 at the decode shapes of
// qwen3-1.7b and llama3.2-3b with B = 4) stream the cache, far fewer than the
// 132 SMs, so the kernel sits well below the HBM rate. Splitting each walk
// across blocks (with a fixed-order merge) is later work.
// Any page_tokens, any lengths (clamped to the table's max_pages * page_tokens
// slots); head dim D <= 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;    // tokens a warp has in flight per round
constexpr int kMaxD = 128;    // 32 lanes x 4 head dims
constexpr int kMaxG = 8;      // query heads per block
constexpr float kNegInf = -1e30f;  // the reference's masked-score sentinel

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Head dims 4 * lane .. 4 * lane + 3 of one row, zero past D.
template <bool kVec>
__device__ __forceinline__ void load4(const float* row, int d0, int D, float* out) {
  if (kVec) {
    if (d0 < D) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(row + d0));
      out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
    } else {
      out[0] = out[1] = out[2] = out[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = d0 + e < D ? __ldg(row + d0 + e) : 0.f;
  }
}
template <bool kVec>
__device__ __forceinline__ void load4(const __nv_bfloat16* row, int d0, int D, float* out) {
  if (kVec) {
    if (d0 < D) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + d0));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float2 a = __bfloat1622float2(h[0]);
      const float2 b = __bfloat1622float2(h[1]);
      out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
    } else {
      out[0] = out[1] = out[2] = out[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = d0 + e < D ? __bfloat162float(row[d0 + e]) : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// q: (B, H, D); pool_k, pool_v: (n_pages, pt, Hkv, D); page_table: (B, max_pages)
// int32; lengths: (B,) int32; o like q. grid = (B, Hkv, ceil(g / G)).
template <typename T, int G, bool kVec>
__global__ void __launch_bounds__(kThreads)
pa_kernel(const T* __restrict__ q, const T* __restrict__ pool_k, const T* __restrict__ pool_v,
          const int* __restrict__ page_table, const int* __restrict__ lengths,
          T* __restrict__ o, int H, int Hkv, int D, int pt, int max_pages, float scale) {
  __shared__ float acc_s[kWarps][G][kMaxD];
  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = H / Hkv;
  const int h0 = blockIdx.z * G;           // first head of the group this block serves
  const int gb = min(G, g - h0);           // heads this block serves
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = 4 * lane;
  const int len = min(max(lengths[b], 0), max_pages * pt);
  const int* table = page_table + (size_t)b * max_pages;
  const size_t head0 = (size_t)b * H + (size_t)kvh * g + h0;

  float qv[G][4];
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + e;
      qv[h][e] = (h < gb && d < D) ? to_float(q[(head0 + h) * D + d]) * scale : 0.f;
    }
  }
  float m[G], l[G], acc[G][4];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = 0.f;
  }

  // Each round: token base + u * kWarps + warp for u < kUnroll. The warp's
  // first token of the round is its smallest, so a round that starts holds at
  // least one valid token and the running max is a real score after it.
  for (int base = 0; base + warp < len; base += kUnroll * kWarps) {
    float kx[kUnroll][4], vx[kUnroll][4];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * kWarps + warp;
      valid[u] = t < len;
      if (valid[u]) {
        const int page = __ldg(table + t / pt);
        const size_t row = (((size_t)page * pt + t % pt) * Hkv + kvh) * D;
        load4<kVec>(pool_k + row, d0, D, kx[u]);
        load4<kVec>(pool_v + row, d0, D, vx[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) kx[u][e] = vx[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h >= gb) continue;  // block-uniform: this block serves fewer heads
      float s[kUnroll];
      float mx = m[h];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) part = fmaf(qv[h][e], kx[u][e], part);
        s[u] = valid[u] ? warp_sum(part) : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = __expf(m[h] - mx);
      float lsum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = __expf(s[u] - mx);
        lsum += p;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][e] = fmaf(p, vx[u][e], acc[h][e]);
      }
      l[h] = l[h] * alpha + lsum;
      m[h] = mx;
    }
  }

#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_s[warp][h][d0 + e] = acc[h][e];
    if (lane == 0) {
      m_s[warp][h] = m[h];
      l_s[warp][h] = l[h];
    }
  }
  __syncthreads();

  // Merge the warps' states in warp order.
  for (int idx = threadIdx.x; idx < gb * D; idx += kThreads) {
    const int h = idx / D, d = idx % D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][h]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(m_s[w][h] - mx);
      lsum = fmaf(l_s[w][h], f, lsum);
      a = fmaf(acc_s[w][h][d], f, a);
    }
    store(o + (head0 + h) * D + d, a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int G>
int launch_g(const void* q, const void* k, const void* v, const int* table, const int* lens,
             void* o, int B, int H, int Hkv, int D, int pt, int max_pages, float scale,
             cudaStream_t stream) {
  const int g = H / Hkv;
  const dim3 grid(B, Hkv, (g + G - 1) / G);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(k) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(v) % (4 * sizeof(T)) == 0;
  if (vec) {
    pa_kernel<T, G, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), table,
        lens, static_cast<T*>(o), H, Hkv, D, pt, max_pages, scale);
  } else {
    pa_kernel<T, G, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), table,
        lens, static_cast<T*>(o), H, Hkv, D, pt, max_pages, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// The smallest group width of {1, 2, 4, 8} that holds g heads (8 for g > 8:
// the block's third grid axis then walks the group in chunks of 8).
template <typename T>
int run(const void* q, const void* k, const void* v, const int* table, const int* lens, void* o,
        int B, int H, int Hkv, int D, int pt, int max_pages, float scale, cudaStream_t s) {
  const int g = H / Hkv;
  if (g <= 1) return launch_g<T, 1>(q, k, v, table, lens, o, B, H, Hkv, D, pt, max_pages, scale, s);
  if (g <= 2) return launch_g<T, 2>(q, k, v, table, lens, o, B, H, Hkv, D, pt, max_pages, scale, s);
  if (g <= 4) return launch_g<T, 4>(q, k, v, table, lens, o, B, H, Hkv, D, pt, max_pages, scale, s);
  return launch_g<T, kMaxG>(q, k, v, table, lens, o, B, H, Hkv, D, pt, max_pages, scale, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, the pools and o share it);
// page_table and lengths are int32. Returns cudaGetLastError() after the launch.
extern "C" int paged_attention(const void* q, const void* pool_k, const void* pool_v,
                               const void* page_table, const void* lengths, void* o, int B,
                               int H, int Hkv, int D, int page_tokens, int max_pages,
                               float scale, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || H <= 0 || H % Hkv != 0 || D <= 0 || D > kMaxD ||
      page_tokens <= 0 || max_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, pool_k, pool_v, table, lens, o, B, H, Hkv, D, page_tokens,
                              max_pages, scale, s);
  if (dtype == 0)
    return run<float>(q, pool_k, pool_v, table, lens, o, B, H, Hkv, D, page_tokens, max_pages,
                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
