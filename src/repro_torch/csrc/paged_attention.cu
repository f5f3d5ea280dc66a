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
// KV head) over the HBM rate: about 5 us at the decode shapes of qwen3-1.7b
// and llama3.2-3b (B = 4, Hkv = 8, D = 128, ~1056 tokens a row).
//
// Design (split-KV): B * Hkv rows of work are far fewer than the 132 SMs, so
// each row's walk is cut across blocks. Grid (splits, Hkv * ceil(g / G), B):
// block (s, kvh, b) owns pages [s * pps, (s + 1) * pps) of its row, pps =
// ceil(max_pages / splits) <= kMaxSplitPages; the wrapper picks `splits` from
// B, Hkv, max_pages and the SM count alone (ops.py, pa_splits), never from
// the lengths. A block serves the g = H / Hkv query heads of one KV head (G at
// most, g > 8 in chunks of 8), so each K and V row it loads is used by the
// whole group. It reads its length, then its page ids into shared memory
// once, then walks its tokens in tiles of kTile = 64: warp w takes tokens
// w * 8 .. w * 8 + 7 of a tile, each lane loading 16 bytes of a row (8 bf16
// or 4 f32 head dims), so a half-warp (bf16) or a warp (f32) covers a row of
// up to 128 dims and every lane has all of its K and V loads of the tile in
// flight before the softmax math. One online-softmax rescale per warp tile;
// scores are kept in log2 units (log2 e folded into the query scale). The
// warps' states are merged through shared memory in warp order. With one
// split the block writes the output; else it writes its f32 (acc[D], m, l)
// to a workspace of B * H * splits * (D + 2) floats, and a second kernel on
// the same stream merges the splits in split order. A split past its row's
// length writes m = -1e30, l = 0, acc = 0, so a row whose splits are all
// empty (length 0) gives acc / max(l, 1e-30) = 0, as the Pallas kernel does.
// No atomics: the split count and every merge order depend on shapes only,
// so a call gives the same bits on every run.
// Head dims up to 256 (recurrentgemma) take a second instance of the kernel,
// MD = 256: a warp covers a row (bf16), or each lane holds two 16-byte
// vectors of it, 128 dims apart (f32); a block then serves at most 4 query
// heads (g = 16 in 4 chunks), so that a lane's q, accumulators and loads in
// flight stay in registers and the warps' accumulators (8 x 4 x 256 f32) in
// 32 KB of static shared memory. D <= 128 keeps MD = 128, the code and the
// bits it always had.
// Any page_tokens, any lengths (clamped to the table's max_pages * page_tokens
// slots); head dim D <= 256; f32 and bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpTile = 8;                  // tokens a warp takes of a tile
constexpr int kTile = kWarps * kWarpTile;     // tokens a block walks per tile
constexpr int kMaxD = 256;
constexpr int kMaxG = 8;                      // query heads per block (4 at D > 128)
constexpr int kMaxSplitPages = 64;            // page ids a block holds (pa_splits caps pps)
constexpr float kNegInf = -1e30f;             // the reference's masked-score sentinel
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes of one row: dims d0 .. d0 + V - 1 (V = 16 / sizeof(T)), zero past D.
template <typename T, bool kVec>
__device__ __forceinline__ uint4 load_row(const T* row, int d0, int D) {
  constexpr int V = 16 / sizeof(T);
  if (kVec) return d0 < D ? __ldg(reinterpret_cast<const uint4*>(row + d0)) : make_uint4(0, 0, 0, 0);
  T tmp[V];
#pragma unroll
  for (int e = 0; e < V; ++e) tmp[e] = d0 + e < D ? row[d0 + e] : T(0.f);
  uint4 u;
  memcpy(&u, tmp, 16);
  return u;
}

__device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// q: (B, H, D); pool_k, pool_v: (n_pages, pt, Hkv, D); page_table: (B, max_pages)
// int32; lengths: (B,) int32; o like q; work: (B, H, splits, D + 2) f32 when
// splits > 1, else unused. grid = (splits, Hkv * ceil(g / G), B). MD (128 or
// 256) bounds D.
template <typename T, int G, bool kVec, int MD>
__global__ void __launch_bounds__(kThreads)
pa_split_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                const T* __restrict__ pool_v, const int* __restrict__ page_table,
                const int* __restrict__ lengths, T* __restrict__ o, float* __restrict__ work,
                int H, int Hkv, int D, int pt, int max_pages, int pps, float scale) {
  constexpr int V = 16 / sizeof(T);           // head dims of one 16-byte vector
  constexpr int VPR = MD / V;                 // vectors across one row
  constexpr int NV = VPR > 32 ? VPR / 32 : 1; // vectors of a row a lane holds, LPR * V dims apart
  constexpr int LPR = VPR / NV;               // lanes across one row
  constexpr int RPW = 32 / LPR;               // rows a warp loads at once
  constexpr int U = kWarpTile / RPW;          // rows of K (and of V) a lane has in flight
  constexpr int E = NV * V;                   // head dims a lane holds
  __shared__ float acc_s[kWarps][G][MD];
  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];
  __shared__ int pages_s[kMaxSplitPages];

  const int split = blockIdx.x, splits = gridDim.x;
  const int b = blockIdx.z;
  const int g = H / Hkv;
  const int chunks = (g + G - 1) / G;
  const int kvh = blockIdx.y / chunks;
  const int h0 = (blockIdx.y % chunks) * G;   // first head of the group this block serves
  const int gb = min(G, g - h0);              // heads this block serves
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / LPR;                   // which of the warp's rows this lane loads
  const int d0 = (lane % LPR) * V;
  const size_t head0 = (size_t)b * H + (size_t)kvh * g + h0;

  const int len = min(max(lengths[b], 0), max_pages * pt);
  const int p_begin = split * pps;
  const int t_begin = p_begin * pt;
  const int t_end = min(len, min(max_pages, p_begin + pps) * pt);

  if (t_begin >= t_end) {  // nothing of this row lies in this split
    for (int idx = threadIdx.x; idx < gb * D; idx += kThreads) {
      const int h = idx / D, d = idx % D;
      if (splits == 1) {
        store(o + (head0 + h) * D + d, 0.f);
      } else {
        float* w = work + ((head0 + h) * splits + split) * (D + 2);
        w[d] = 0.f;
        if (d == 0) {
          w[D] = kNegInf;
          w[D + 1] = 0.f;
        }
      }
    }
    return;
  }

  const int n_pages = (t_end - 1) / pt - p_begin + 1;
  for (int i = threadIdx.x; i < n_pages; i += kThreads)
    pages_s[i] = __ldg(page_table + (size_t)b * max_pages + p_begin + i);

  float qv[G][E];
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      float f[V];
      unpack(h < gb ? load_row<T, false>(q + (head0 + h) * D, d0 + n * LPR * V, D) : make_uint4(0, 0, 0, 0), f);
#pragma unroll
      for (int e = 0; e < V; ++e) qv[h][n * V + e] = f[e] * scale * kLog2e;
    }
  }
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.f;
  }
  __syncthreads();

  for (int base = t_begin + warp * kWarpTile; base < t_end; base += kTile) {
    // every K and V load of the warp's tile, then the math
    uint4 kr[U][NV], vr[U][NV];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * RPW + r;
      valid[u] = t < t_end;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        if (valid[u]) {
          const int page = pages_s[t / pt - p_begin];
          const size_t row = (((size_t)page * pt + t % pt) * Hkv + kvh) * D;
          kr[u][n] = load_row<T, kVec>(pool_k + row, d0 + n * LPR * V, D);
          vr[u][n] = load_row<T, kVec>(pool_v + row, d0 + n * LPR * V, D);
        } else {
          kr[u][n] = vr[u][n] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    float s[G][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float f[V];
        unpack(kr[u][n], f);
#pragma unroll
        for (int e = 0; e < V; ++e) kf[n * V + e] = f[e];
      }
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qv[h][e], kf[e], part);
#pragma unroll
        for (int off = LPR / 2; off > 0; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
        s[h][u] = valid[u] ? part : kNegInf;
      }
    }
    // one rescale a tile; the max is taken over the warp's rows, so every lane
    // of the warp holds the same m and the rows' sums add at the end
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float mx = m[h];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[h][u]);
#pragma unroll
      for (int off = 16; off >= LPR; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = exp2f(m[h] - mx);
      float lsum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[h][u] = valid[u] ? exp2f(s[h][u] - mx) : 0.f;  // the score's weight p
        lsum += s[h][u];
      }
      l[h] = fmaf(l[h], alpha, lsum);
      m[h] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[h][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float f[V];
        unpack(vr[u][n], f);
#pragma unroll
        for (int e = 0; e < V; ++e) vf[n * V + e] = f[e];
      }
#pragma unroll
      for (int h = 0; h < G; ++h)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] = fmaf(s[h][u], vf[e], acc[h][e]);
    }
  }

  // the warp's rows share m: add their l and acc, then hand the warp's state
  // to shared memory
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int off = 16; off >= LPR; off /= 2) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], off);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[h][e] += __shfl_xor_sync(0xffffffffu, acc[h][e], off);
    }
    if (r == 0) {
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < V; ++e) acc_s[warp][h][d0 + n * LPR * V + e] = acc[h][n * V + e];
    }
    if (lane == 0) {
      m_s[warp][h] = m[h];
      l_s[warp][h] = l[h];
    }
  }
  __syncthreads();

  // merge the warps' states in warp order
  for (int idx = threadIdx.x; idx < gb * D; idx += kThreads) {
    const int h = idx / D, d = idx % D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][h]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(m_s[w][h] - mx);
      lsum = fmaf(l_s[w][h], f, lsum);
      a = fmaf(acc_s[w][h][d], f, a);
    }
    if (splits == 1) {
      store(o + (head0 + h) * D + d, a / fmaxf(lsum, 1e-30f));
    } else {
      float* w = work + ((head0 + h) * splits + split) * (D + 2);
      w[d] = a;
      if (d == 0) {
        w[D] = mx;
        w[D + 1] = lsum;
      }
    }
  }
}

// o[bh, d] = the splits of row bh merged in split order. grid = B * H,
// block = MD threads (MD >= D: 128 or 256).
template <typename T, int MD>
__global__ void __launch_bounds__(MD)
pa_merge_kernel(const float* __restrict__ work, T* __restrict__ o, int D, int splits) {
  const int d = threadIdx.x;
  const float* w = work + (size_t)blockIdx.x * splits * (D + 2);
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, w[s * (D + 2) + D]);
  float lsum = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* ws = w + s * (D + 2);
    const float f = exp2f(ws[D] - mx);
    lsum = fmaf(ws[D + 1], f, lsum);
    if (d < D) a = fmaf(ws[d], f, a);
  }
  if (d < D) store(o + (size_t)blockIdx.x * D + d, a / fmaxf(lsum, 1e-30f));
}

template <typename T, int G, int MD>
int launch_g(const void* q, const void* k, const void* v, const int* table, const int* lens,
             void* o, float* work, int B, int H, int Hkv, int D, int pt, int max_pages,
             int splits, float scale, cudaStream_t stream) {
  const int g = H / Hkv;
  const int pps = (max_pages + splits - 1) / splits;
  const dim3 grid(splits, Hkv * ((g + G - 1) / G), B);
  const bool vec = D % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (vec)
    pa_split_kernel<T, G, true, MD><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, table, lens, ot, work, H, Hkv, D, pt, max_pages, pps, scale);
  else
    pa_split_kernel<T, G, false, MD><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, table, lens, ot, work, H, Hkv, D, pt, max_pages, pps, scale);
  if (splits > 1) pa_merge_kernel<T, MD><<<B * H, MD, 0, stream>>>(work, ot, D, splits);
  return static_cast<int>(cudaGetLastError());
}

// G: g itself up to 4 (llama3.2's 3 included), else 8 (g > 8 in chunks of 8)
// for D <= 128; at most 4 (g > 4 in chunks of 4) for D <= 256.
template <typename T>
int run(const void* q, const void* k, const void* v, const int* table, const int* lens, void* o,
        float* work, int B, int H, int Hkv, int D, int pt, int max_pages, int splits, float scale,
        cudaStream_t s) {
  const int g = H / Hkv;
#define PA_LAUNCH(GG, MD) \
  launch_g<T, GG, MD>(q, k, v, table, lens, o, work, B, H, Hkv, D, pt, max_pages, splits, scale, s)
  if (D > 128) {
    if (g == 1) return PA_LAUNCH(1, 256);
    if (g == 2) return PA_LAUNCH(2, 256);
    if (g == 3) return PA_LAUNCH(3, 256);
    return PA_LAUNCH(4, 256);
  }
  if (g == 1) return PA_LAUNCH(1, 128);
  if (g == 2) return PA_LAUNCH(2, 128);
  if (g == 3) return PA_LAUNCH(3, 128);
  if (g == 4) return PA_LAUNCH(4, 128);
  return PA_LAUNCH(kMaxG, 128);
#undef PA_LAUNCH
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, the pools and o share it);
// page_table and lengths are int32; D <= 256. `splits` cuts each row's pages into runs
// of ceil(max_pages / splits) <= 64 pages; splits > 1 needs a float32
// workspace of B * H * splits * (D + 2). Returns cudaGetLastError() after the
// launches.
extern "C" int paged_attention(const void* q, const void* pool_k, const void* pool_v,
                               const void* page_table, const void* lengths, void* o, void* work,
                               int B, int H, int Hkv, int D, int page_tokens, int max_pages,
                               int splits, float scale, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || H <= 0 || H % Hkv != 0 || D <= 0 || D > kMaxD ||
      page_tokens <= 0 || max_pages <= 0 || splits <= 0 || splits > max_pages ||
      (max_pages + splits - 1) / splits > kMaxSplitPages || B > 65535 ||
      (splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(lengths);
  float* ws = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, pool_k, pool_v, table, lens, o, ws, B, H, Hkv, D, page_tokens,
                              max_pages, splits, scale, s);
  if (dtype == 0)
    return run<float>(q, pool_k, pool_v, table, lens, o, ws, B, H, Hkv, D, page_tokens,
                      max_pages, splits, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
