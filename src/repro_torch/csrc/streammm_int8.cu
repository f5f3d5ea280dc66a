// int8-weight streaming matmul for Hopper (sm_90a):
// out = x @ (float(w_q) * scale), the scale taken per (k-group of block_k
// rows, output column), x read as f32, an f32 accumulator, cast to the
// output type.
//
// Replaces: src/repro/kernels/streammm/kernel.py, stream_matmul_int8 /
// _mm_int8_kernel, a (M/bm, N/bn, K/bk) Pallas grid with K innermost that
// streams int8 weight tiles HBM->VMEM with their (1, bn) scale row and
// dequantises each tile in VMEM before the MXU product.
//
// Bound on this card: the kernel was written for decode of the paper's int8
// Llama3-8B (M = 1..8 tokens). There every weight is read once and used for
// 2 * M flops: far below the ~295 flop/byte where the tensor cores become the
// limit. The time is the bytes over the HBM rate (3.35 TB/s): K * N int8
// weights plus the scales, 4 / block_k bytes a weight (3% at block_k = 128),
// half the bytes of the bf16 stream_matmul at the same (K, N).
//
// Design:
//  * gemv path (M <= 8): a block owns a slab of 256 output columns and a run
//    of whole k-groups. Each thread reads 16 int8 weights of one row with one
//    16-byte load (16 threads across the slab's row, 16 rows in flight a
//    block), and dequantises them in registers with its 16 columns' scales
//    of the row's group, loaded once a group (four 16-byte loads), not once
//    a weight. Each weight is dequantised to f32 as the reference does
//    (float(w_q) * scale) before the f32 FMA with x. The row groups are
//    added in a fixed order through shared memory. The wrapper splits K
//    across blocks on block_k boundaries, so a split never crosses a scale
//    group; each split writes its partial sums to a workspace and a second
//    kernel adds them in split order. No atomics: the same bits every run.
//  * tiled path (M > 8): 64x64 shared-memory tiles with a 4x4 register
//    micro-tile a thread, f32 throughout; each weight is dequantised with its
//    scale as the tile is loaded into shared memory. It is off the decode
//    path; tensor-core tiles (int8 wgmma, or bf16 after dequant) are later
//    work.
// Any M and N: ragged edges are masked; 16-byte loads are used only when N is
// a multiple of 16 and the weights and scales are 16-byte aligned, else the
// kernel loads element by element. K must be a multiple of block_k (the
// scales' contract).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kV = 16;                   // int8 weights in one 16-byte load
constexpr int kGemvCols = 256;           // output columns per gemv block
constexpr int kTPR = kGemvCols / kV;     // threads across one row of the slab
constexpr int kRPI = kThreads / kTPR;    // rows read per iteration
constexpr int kGemvMaxM = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename O>
__device__ __forceinline__ O from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 int8 weights -> 16 floats, one 16-byte load.
__device__ __forceinline__ void load_w16(const int8_t* p, float* out) {
  int4 u = __ldg(reinterpret_cast<const int4*>(p));
  const char4* c = reinterpret_cast<const char4*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[4 * i] = static_cast<float>(c[i].x);
    out[4 * i + 1] = static_cast<float>(c[i].y);
    out[4 * i + 2] = static_cast<float>(c[i].z);
    out[4 * i + 3] = static_cast<float>(c[i].w);
  }
}

// 16 scales -> 16 floats, four 16-byte loads.
__device__ __forceinline__ void load_s16(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 u = __ldg(reinterpret_cast<const float4*>(p) + i);
    out[4 * i] = u.x; out[4 * i + 1] = u.y; out[4 * i + 2] = u.z; out[4 * i + 3] = u.w;
  }
}

// grid = (ceil(N / 256), splits); block = 256 threads. Split s takes the
// k-groups [s * gps, (s + 1) * gps). MM is M rounded up to 1, 2, 4 or 8.
template <typename T, typename O, int MM>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scales, O* __restrict__ out,
            float* __restrict__ work, int M, int N, int K, int block_k, int gps,
            int vec_ok) {
  __shared__ float red[kRPI][kGemvCols];

  const int c = threadIdx.x % kTPR;
  const int r = threadIdx.x / kTPR;
  const int col0 = blockIdx.x * kGemvCols + c * kV;
  const int groups = K / block_k;
  const int g_begin = blockIdx.y * gps;
  const int g_end = min(groups, g_begin + gps);

  float acc[MM][kV];
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int v = 0; v < kV; ++v) acc[m][v] = 0.f;

  for (int g = g_begin; g < g_end; ++g) {
    // this thread's 16 columns' scales for the group
    float s[kV];
    const float* srow = scales + (size_t)g * N;
    if (vec_ok) {
      if (col0 < N) {
        load_s16(srow + col0, s);
      } else {
#pragma unroll
        for (int v = 0; v < kV; ++v) s[v] = 0.f;
      }
    } else {
#pragma unroll
      for (int v = 0; v < kV; ++v) s[v] = (col0 + v < N) ? __ldg(srow + col0 + v) : 0.f;
    }
    const int k_end = (g + 1) * block_k;
#pragma unroll 4
    for (int k = g * block_k + r; k < k_end; k += kRPI) {
      float wv[kV];
      const int8_t* row = w + (size_t)k * N;
      if (vec_ok) {
        if (col0 < N) {
          load_w16(row + col0, wv);
        } else {
#pragma unroll
          for (int v = 0; v < kV; ++v) wv[v] = 0.f;
        }
      } else {
#pragma unroll
        for (int v = 0; v < kV; ++v)
          wv[v] = (col0 + v < N) ? static_cast<float>(row[col0 + v]) : 0.f;
      }
#pragma unroll
      for (int v = 0; v < kV; ++v) wv[v] *= s[v];  // dequantise: float(w_q) * scale
#pragma unroll
      for (int m = 0; m < MM; ++m) {
        if (m < M) {
          const float xm = to_float(x[(size_t)m * K + k]);
#pragma unroll
          for (int v = 0; v < kV; ++v) acc[m][v] = fmaf(xm, wv[v], acc[m][v]);
        }
      }
    }
  }

  // Reduce the kRPI row groups in a fixed order, one row of x at a time.
  const int col = blockIdx.x * kGemvCols + threadIdx.x;
#pragma unroll
  for (int m = 0; m < MM; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int v = 0; v < kV; ++v) red[r][c * kV + v] = acc[m][v];
    __syncthreads();
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kRPI; ++i) sum += red[i][threadIdx.x];
    if (col < N) {
      if (work != nullptr)
        work[((size_t)blockIdx.y * M + m) * N + col] = sum;
      else
        out[(size_t)m * N + col] = from_float<O>(sum);
    }
    __syncthreads();
  }
}

// out[m, n] = sum over splits s, in order, of work[s, m, n].
template <typename O>
__global__ void split_reduce_kernel(const float* __restrict__ work, O* __restrict__ out,
                                    int MN, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int j = 0; j < splits; ++j) s += work[(size_t)j * MN + i];
  out[i] = from_float<O>(s);
}

constexpr int kTile = 64;
constexpr int kTileK = 16;

// grid = (ceil(N / 64), ceil(M / 64)); block = 256 threads, 4x4 outputs each.
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scales, O* __restrict__ out, int M, int N, int K,
             int block_k) {
  __shared__ float xs[kTileK][kTile + 4];  // x tile, transposed: xs[k][m]
  __shared__ float ws[kTileK][kTile + 4];  // dequantised w tile: ws[k][n]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kTileK) {
#pragma unroll
    for (int e = 0; e < (kTile * kTileK) / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int xm = idx / kTileK, xk = idx % kTileK;
      const int gm = m0 + xm, gk = k0 + xk;
      xs[xk][xm] = (gm < M && gk < K) ? to_float(x[(size_t)gm * K + gk]) : 0.f;
      const int wk = idx / kTile, wn = idx % kTile;
      const int hk = k0 + wk, hn = n0 + wn;
      ws[wk][wn] = (hk < K && hn < N)
                       ? static_cast<float>(w[(size_t)hk * N + hn]) *
                             __ldg(scales + (size_t)(hk / block_k) * N + hn)
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) out[(size_t)gm * N + gn] = from_float<O>(acc[i][j]);
    }
  }
}

template <typename T, typename O, int MM>
void launch_gemv(const T* x, const int8_t* w, const float* scales, O* out, float* work,
                 int M, int N, int K, int block_k, int splits, cudaStream_t stream) {
  const int groups = K / block_k;
  const int gps = (groups + splits - 1) / splits;
  const int vec_ok = (N % kV == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(scales) % 16 == 0);
  dim3 grid((N + kGemvCols - 1) / kGemvCols, splits);
  gemv_kernel<T, O, MM><<<grid, kThreads, 0, stream>>>(
      x, w, scales, out, splits > 1 ? work : nullptr, M, N, K, block_k, gps, vec_ok);
  if (splits > 1) {
    const int mn = M * N;
    split_reduce_kernel<O><<<(mn + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        work, out, mn, splits);
  }
}

template <typename T, typename O>
int run(const void* x_, const void* w_, const void* s_, void* out_, void* work, int M, int N,
        int K, int block_k, int splits, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const int8_t* w = static_cast<const int8_t*>(w_);
  const float* s = static_cast<const float*>(s_);
  O* out = static_cast<O*>(out_);
  float* ws = static_cast<float*>(work);
  if (splits == 0) {
    dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
    tiled_kernel<T, O><<<grid, kThreads, 0, stream>>>(x, w, s, out, M, N, K, block_k);
  } else if (M == 1) {
    launch_gemv<T, O, 1>(x, w, s, out, ws, M, N, K, block_k, splits, stream);
  } else if (M <= 2) {
    launch_gemv<T, O, 2>(x, w, s, out, ws, M, N, K, block_k, splits, stream);
  } else if (M <= 4) {
    launch_gemv<T, O, 4>(x, w, s, out, ws, M, N, K, block_k, splits, stream);
  } else {
    launch_gemv<T, O, kGemvMaxM>(x, w, s, out, ws, M, N, K, block_k, splits, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) of in_dtype, w (K, N) int8, scales (K / block_k, N) float32.
// dtype codes: 0 = float32, 1 = bfloat16. splits = 0 selects the tiled path;
// splits >= 1 the gemv path (M <= 8) with the K / block_k groups cut into
// that many runs, which needs a float32 workspace of splits * M * N when
// splits > 1. Returns cudaGetLastError() after the launches.
extern "C" int stream_matmul_int8(const void* x, const void* w, const void* scales, void* out,
                                  void* work, int M, int N, int K, int block_k, int splits,
                                  int in_dtype, int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block_k <= 0 || K % block_k != 0 || splits < 0 ||
      splits > K / block_k || (splits > 0 && M > kGemvMaxM))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && out_dtype == 1)
    return run<__nv_bfloat16, __nv_bfloat16>(x, w, scales, out, work, M, N, K, block_k, splits, s);
  if (in_dtype == 1 && out_dtype == 0)
    return run<__nv_bfloat16, float>(x, w, scales, out, work, M, N, K, block_k, splits, s);
  if (in_dtype == 0 && out_dtype == 1)
    return run<float, __nv_bfloat16>(x, w, scales, out, work, M, N, K, block_k, splits, s);
  if (in_dtype == 0 && out_dtype == 0)
    return run<float, float>(x, w, scales, out, work, M, N, K, block_k, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
