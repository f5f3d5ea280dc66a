// Weight-streaming matmul for Hopper (sm_90a): out = x @ w with an f32
// accumulator, cast to the output type.
//
// Replaces: src/repro/kernels/streammm/kernel.py, stream_matmul / _mm_kernel,
// a (M/bm, N/bn, K/bk) Pallas grid with K innermost that streams weight tiles
// HBM->VMEM in K order.
//
// Bound on this card: on the live path every call has M = 1 (one decode token),
// so the work is a GEMV that reads each weight byte once and does 2 flops per
// weight: about 1 flop per byte, far below the ~295 flop/byte where the tensor
// cores become the limit. The time is the weight bytes over the HBM rate. At
// prefill (M = 4096) the same product does 2 * 4096 flops a weight and is
// bound by the bf16 tensor-core rate (989 TFLOP/s).
//
// Three routes, chosen by the wrapper (ops.py, mm_route) from dtype and shape:
//  * gemv (M <= 8): a block owns a slab of 256 output columns and a chunk
//    of K rows. Its threads read the slab row by row with 16-byte loads
//    (neighbouring threads on neighbouring columns), keep one f32 partial sum
//    per (row of x, column) in registers, and reduce the row groups through
//    shared memory in a fixed order. Narrow projections (N = 1024..8192) have
//    too few column slabs to fill 132 SMs, so the wrapper splits K across
//    blocks; each split writes its partial sums to a workspace and a second
//    kernel adds them in split order. No atomics: the result is the same bits
//    on every run, which the live runtime's transparency check relies on.
//  * wgmma (bf16, M > 8, K and N multiples of 8, 16-byte aligned operands):
//    tensor cores fed by TMA. A block owns a 128 x kWgmmaBN output tile. One
//    producer thread streams 128 x 64 tiles of x (K-major) and 64 x kWgmmaBN
//    tiles of w, as 64-column boxes of its (K, N) row-major layout (MN-major,
//    the wgmma transpose bit; the weights are used in place, never copied),
//    through a ring of stages in shared memory with 128-byte swizzle; full and
//    empty mbarriers hand the stages over. Two consumer warpgroups (setmaxnreg
//    moves registers to them) each run wgmma m64nNk16 over 64 rows into f32
//    registers, keeping one k-tile's wgmma group in flight, and store their
//    rows with masks. TMA zero-fills past M, N and K, so a K tail adds 0 and
//    ragged M and N are masked at the store. No split-K, no atomics.
//  * simt (f32, or shapes TMA cannot describe): plain 64x64 shared-memory
//    tiles with a 4x4 register micro-tile per thread, f32 throughout: f32
//    products stay exact f32 (never TF32).
// Any M, N, K on the gemv and simt routes: ragged edges are masked; 16-byte
// loads are used only when the weight rows are 16-byte aligned.
//
// K-major weights (w_layout = 1, "nk"): out = x @ w^T for w of shape (N, K),
// the tied LM head x @ embed^T, which reads the (V, d) embedding table in
// place (a transposed copy would be V * d * 2 bytes that no segment holds):
//  * gemv (M <= 8): each output column is a dot product over one contiguous
//    row of w. A warp owns 4 rows and streams them with 16-byte loads (4 in
//    flight a lane) against x, which the block stages in shared memory in
//    chunks of 1024 K-columns; a butterfly of shuffles sums each row's
//    lanes. One launch, no split-K, no atomics: the same bits on every run.
//    Bound: the weight bytes over HBM, as the (K, N) gemv.
//  * wgmma (bf16, M > 8, K a multiple of 8, 16-byte aligned operands): the
//    same pipeline with a K-major B, the form wgmma reads without the
//    transpose bit: one TMA box of 64 K-columns by kWgmmaBN weight rows a
//    stage, 128-byte swizzled like the x tile. N may be ragged (minicpm-2b's
//    V = 122753 is odd): TMA zero-fills the rows past N and the store is
//    masked; at odd N output rows are not 4-byte aligned, so the epilogue
//    stores single elements there.
//  * simt: the f32 tiles indexing w[n, k].
//
// Expert-batched form (E > 1): out[e] = x[e] @ w[e] for
// x (E, M, K), w (E, K, N), out (E, M, N), in one launch with the expert on
// the grid's z axis. It computes the MoE layer's expert products, the
// einsum("ecd,edf->ecf") of src/repro/models/layers.py:241-243, which the
// reference leaves to XLA; the kernel extends the TPU stream_matmul
// (src/repro/kernels/streammm/kernel.py:50). An optional int32 `rows` (E,)
// gives each expert's filled slots (the dispatch's count, clamped to M):
// rows at or past rows[e] are written as zeros and their x values never reach
// the output, and an expert whose rows[e] is 0 reads none of its weight.
// Bound: at decode (M = the capacity, <= 8) the weight bytes of the experts
// that hold a row; at prefill the operations over the filled rows, or, where
// the capacity is small beside K and N (arctic's 80 rows against 7168 x
// 4864 weights), again the weight bytes. The same three routes:
//  * gemv: grid (column slabs, K splits, E); the split-K workspace is
//    (splits, E, M, N), added in split order as before;
//  * wgmma: 3-D tensor maps, x as (K, M, E) and w as (N, K, E), so that a
//    64-deep K tile never straddles two experts and TMA zero-fills rows past
//    M and K inside each expert; a 128-row tile at or past rows[e] loads
//    nothing and stores zeros; the epilogue stores zeros for rows past
//    rows[e] in a partly filled tile (each output row depends only on its
//    own row of x, so the rows it loaded there reach nothing);
//  * simt: x rows at or past rows[e] load as 0, and a 64-row tile past them
//    stores zeros without loading.
//
// Gradients (the MoE layer's backward, which the reference leaves to XLA's
// derivative of the same einsum). With dY (E, M, N) of out[e] = x[e] @ w[e]:
//  * dX[e] = dY[e] @ w[e]^T is the K-major form over the expert stack: w[e]
//    (K, N) row-major read in place as the (N', K') = (K, N) weight of a
//    product whose sum runs over N, with the same `rows` (rows past rows[e]
//    written as 0, their dY never read). The gemv route takes E on the
//    grid's y axis; wgmma and simt on z, as above. Bound: the weight bytes
//    of the experts that hold a row, or the filled rows' operations.
//  * dW[e] = x[e]^T @ dY[e] (x_layout = 1: x given as (K', M') = (M, K), out
//    (K, N)), the sum over the filled slots only. On the wgmma route x is an
//    MN-major A (the transpose bit of wgmma's A; two 64 x 64 TMA boxes of x
//    as (K, M, E) a stage), dY an MN-major B as the forward's (K, N)
//    weight; the k-loop of expert e ends at ceil(rows[e] / 64) stages, and
//    in the last one the consumers zero the rows at or past rows[e] of both
//    tiles in shared memory (fence.proxy.async, then a barrier of the two
//    consumer warpgroups) before the products, so slots past the count add
//    nothing whatever they hold; an expert with rows[e] = 0 writes zeros
//    and reads nothing. The simt route loads those terms as 0. Bound: the
//    filled rows' operations, or the bytes of dW written plus x and dY read.
// The 2-D form's dW uses the same x_layout = 1 (E = 1, no rows), so x is
// read in place there too.
// Tuning (persistent tiles across experts, splits sized to the experts hit)
// is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGemvCols = 256;  // output columns per gemv block
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

// 16 bytes of weights -> V floats.
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  float4 u = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The rows of expert e that hold data: min(rows[e], M), or M without `rows`.
__device__ __forceinline__ int expert_rows(const int* rows, int e, int M) {
  return rows == nullptr ? M : max(0, min(__ldg(rows + e), M));
}

// grid = (ceil(N / 256), splits, E); block = 256 threads. Expert e =
// blockIdx.z reads x[e] (M, K) and w[e] (K, N) and writes out[e] (M, N), or
// with splits its slice work[split, e] of the (splits, E, M, N) workspace.
// MM is M rounded up to 1, 2, 4 or 8 (register arrays need a fixed size).
template <typename T, typename O, int MM>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const T* __restrict__ x, const T* __restrict__ w, O* __restrict__ out,
            float* __restrict__ work, const int* __restrict__ rows, int M, int N, int K,
            int k_chunk, int vec_ok) {
  constexpr int V = 16 / sizeof(T);         // elements in one 16-byte load
  constexpr int TPR = kGemvCols / V;        // threads across one row of the slab
  constexpr int RPI = kThreads / TPR;       // rows read per iteration
  __shared__ float red[RPI][kGemvCols];

  const int e = blockIdx.z;
  const int me = expert_rows(rows, e, M);
  x += (size_t)e * M * K;
  w += (size_t)e * K * N;
  out += (size_t)e * M * N;
  if (work != nullptr) work += ((size_t)blockIdx.y * gridDim.z + e) * M * N;
  const int col = blockIdx.x * kGemvCols + threadIdx.x;
  if (me == 0) {  // an empty expert: zeros, and none of its weight is read
    if (col < N) {
      for (int m = 0; m < M; ++m) {
        if (work != nullptr)
          work[(size_t)m * N + col] = 0.f;
        else
          out[(size_t)m * N + col] = from_float<O>(0.f);
      }
    }
    return;
  }

  const int c = threadIdx.x % TPR;
  const int r = threadIdx.x / TPR;
  const int col0 = blockIdx.x * kGemvCols + c * V;
  const int k_begin = blockIdx.y * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  float acc[MM][V];
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[m][v] = 0.f;

#pragma unroll 4
  for (int k = k_begin + r; k < k_end; k += RPI) {
    float wv[V];
    const T* row = w + (size_t)k * N;
    if (vec_ok) {
      if (col0 < N) {
        load_vec(row + col0, wv);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) wv[v] = 0.f;
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) wv[v] = (col0 + v < N) ? to_float(row[col0 + v]) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < MM; ++m) {
      if (m < me) {
        const float xm = to_float(x[(size_t)m * K + k]);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] = fmaf(xm, wv[v], acc[m][v]);
      }
    }
  }

  // Reduce the RPI row groups in a fixed order, one row of x at a time; rows
  // at or past `me` kept their zero sums.
#pragma unroll
  for (int m = 0; m < MM; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int v = 0; v < V; ++v) red[r][c * V + v] = acc[m][v];
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < RPI; ++i) s += red[i][threadIdx.x];
    if (col < N) {
      if (work != nullptr)
        work[(size_t)m * N + col] = s;
      else
        out[(size_t)m * N + col] = from_float<O>(s);
    }
    __syncthreads();
  }
}

// out[i] = sum over splits s, in order, of work[s, i], i over the E * M * N
// outputs.
template <typename O>
__global__ void split_reduce_kernel(const float* __restrict__ work, O* __restrict__ out,
                                    int MN, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int j = 0; j < splits; ++j) s += work[(size_t)j * MN + i];
  out[i] = from_float<O>(s);
}

constexpr int kNkRowsPerWarp = 4;  // rows of a K-major weight a gemv warp owns
constexpr int kNkChunk = 1024;     // K-columns of x a gemv block stages at a time

// out[e, m, n] = sum_k x[e, m, k] * w[e, n, k], w[e] (N, K) row-major.
// grid = (ceil(N / (8 warps * kNkRowsPerWarp)), E); block = 256 threads.
// Rows of x at or past the expert's filled rows are not read and come out 0;
// an expert with none reads none of its weight.
template <typename T, typename O, int MM>
__global__ void __launch_bounds__(kThreads)
gemv_nk_kernel(const T* __restrict__ x, const T* __restrict__ w, O* __restrict__ out,
               const int* __restrict__ rows, int M, int N, int K, int vec_ok) {
  constexpr int V = 16 / sizeof(T);
  constexpr int R = kNkRowsPerWarp;
  constexpr int kBlockRows = (kThreads / 32) * R;
  __shared__ __align__(16) float xs[MM][kNkChunk];
  const int e = blockIdx.y;
  const int me = expert_rows(rows, e, M);
  x += (size_t)e * M * K;
  w += (size_t)e * N * K;
  out += (size_t)e * M * N;
  if (me == 0) {  // an empty expert: zeros, and none of its weight is read
    for (int i = threadIdx.x; i < M * kBlockRows; i += kThreads) {
      const int n = blockIdx.x * kBlockRows + i % kBlockRows;
      if (n < N) out[(size_t)(i / kBlockRows) * N + n] = from_float<O>(0.f);
    }
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = (blockIdx.x * (kThreads / 32) + warp) * R;

  float acc[R][MM];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MM; ++m) acc[r][m] = 0.f;

  for (int kc = 0; kc < K; kc += kNkChunk) {
    const int kn = min(kNkChunk, K - kc);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = threadIdx.x; i < MM * kNkChunk; i += kThreads) {
      const int m = i / kNkChunk, kk = i % kNkChunk;
      xs[m][kk] = (m < me && kk < kn) ? to_float(x[(size_t)m * K + kc + kk]) : 0.f;
    }
    __syncthreads();
    if (vec_ok) {  // K % V == 0 and 16-byte aligned rows, so kn % V == 0
      for (int kk = lane * V; kk < kn; kk += 32 * V) {
        float wv[R][V];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (n0 + r < N) {
            load_vec(w + (size_t)(n0 + r) * K + kc + kk, wv[r]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) wv[r][v] = 0.f;
          }
        }
#pragma unroll
        for (int m = 0; m < MM; ++m) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float xm = xs[m][kk + v];
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r][m] = fmaf(xm, wv[r][v], acc[r][m]);
          }
        }
      }
    } else {
      for (int kk = lane; kk < kn; kk += 32) {
        float wr[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          wr[r] = n0 + r < N ? to_float(w[(size_t)(n0 + r) * K + kc + kk]) : 0.f;
#pragma unroll
        for (int m = 0; m < MM; ++m)
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][m] = fmaf(xs[m][kk], wr[r], acc[r][m]);
      }
    }
  }

  // Sum each (row, m) over the warp's lanes by a butterfly (a fixed order:
  // every lane ends with the same bits), then lane r * MM + m stores it.
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MM; ++m)
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        acc[r][m] += __shfl_xor_sync(0xffffffffu, acc[r][m], off);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MM; ++m)
      if (lane == r * MM + m && m < M && n0 + r < N)
        out[(size_t)m * N + n0 + r] = from_float<O>(m < me ? acc[r][m] : 0.f);
}

constexpr int kTile = 64;
constexpr int kTileK = 16;

// grid = (ceil(N / 64), ceil(M / 64), E); block = 256 threads, 4x4 outputs
// each; expert blockIdx.z as in gemv_kernel. kNK: w is (N, K) row-major. kTA:
// x is (K, M) row-major (out = x^T @ w), and the expert's filled rows bound
// the sum over K instead of the output's rows.
template <typename T, typename O, bool kNK, bool kTA>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const T* __restrict__ x, const T* __restrict__ w, O* __restrict__ out,
             const int* __restrict__ rows, int M, int N, int K) {
  __shared__ float xs[kTileK][kTile + 4];  // x tile, transposed: xs[k][m]
  __shared__ float ws[kTileK][kTile + 4];  // w tile: ws[k][n]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int me = expert_rows(rows, blockIdx.z, kTA ? K : M);
  const int m_end = kTA ? M : me;  // rows of x that are read
  const int k_end = kTA ? me : K;  // terms of the sum
  x += (size_t)blockIdx.z * M * K;
  w += (size_t)blockIdx.z * K * N;
  out += (size_t)blockIdx.z * M * N;
  float acc[4][4] = {};

  // a tile at or past the expert's filled rows loads nothing and stores zeros
  for (int k0 = 0; m0 < m_end && k0 < k_end; k0 += kTileK) {
#pragma unroll
    for (int e = 0; e < (kTile * kTileK) / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      if constexpr (kTA) {  // neighbouring threads on neighbouring m of a row of x
        const int xk = idx / kTile, xm = idx % kTile;
        const int gm = m0 + xm, gk = k0 + xk;
        xs[xk][xm] = (gm < M && gk < k_end) ? to_float(x[(size_t)gk * M + gm]) : 0.f;
      } else {
        const int xm = idx / kTileK, xk = idx % kTileK;
        const int gm = m0 + xm, gk = k0 + xk;
        xs[xk][xm] = (gm < me && gk < K) ? to_float(x[(size_t)gm * K + gk]) : 0.f;
      }
      if constexpr (kNK) {  // neighbouring threads on neighbouring k of a row
        const int wn = idx / kTileK, wk = idx % kTileK;
        const int hk = k0 + wk, hn = n0 + wn;
        ws[wk][wn] = (hk < K && hn < N) ? to_float(w[(size_t)hn * K + hk]) : 0.f;
      } else {
        const int wk = idx / kTile, wn = idx % kTile;
        const int hk = k0 + wk, hn = n0 + wn;
        ws[wk][wn] = (hk < k_end && hn < N) ? to_float(w[(size_t)hk * N + hn]) : 0.f;
      }
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

// ---- wgmma route ---------------------------------------------------------------

constexpr int kWgmmaBM = 128;  // rows of a block: two consumer warpgroups of 64
constexpr int kWgmmaBN = 256;  // columns of a block
constexpr int kWgmmaBK = 64;   // K rows of a stage: one 128-byte swizzle row of x
constexpr int kWgmmaThreads = 384;  // producer warpgroup + two consumers
constexpr int kWgmmaStages = 4;
constexpr int kBoxBytes = 64 * 64 * 2;                   // one 64 x 64 bf16 box
constexpr int kABytes = kWgmmaBM * kWgmmaBK * 2;          // x tile
constexpr int kBBytes = kWgmmaBK * kWgmmaBN * 2;          // w tile: kWgmmaBN / 64 boxes, or one K-major box
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kWgmmaSmem = 1024 + kWgmmaStages * kStageBytes + 2 * kWgmmaStages * 8;

template <typename O>
__device__ __forceinline__ void store2(O* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = hopper::pack_bf16x2(a, b);
}

// Columns col and col + 1 of an output row: one paired store where the pair
// is inside the row and aligned (even N), else each column that is inside.
template <typename O>
__device__ __forceinline__ void store_cols(O* row, int col, int N, float a, float b) {
  if (col + 1 < N && (N & 1) == 0) {
    store2<O>(row + col, a, b);
  } else {
    if (col < N) row[col] = from_float<O>(a);
    if (col + 1 < N) row[col + 1] = from_float<O>(b);
  }
}

// grid = (ceil(M / 128), ceil(N / kWgmmaBN), E): consecutive blocks share a
// column of weight tiles; blockIdx.z is the expert. tx: x as (K, M, E)
// innermost first, boxes 64 x 128 x 1, or with kTA x as (M, K, E), boxes 64 x
// 64 x 1 (MN-major A, two boxes a stage); tw: w as (N, K, E) innermost first,
// boxes 64 x 64 x 1 (MN-major B), or with kNK w as (K, N, E), boxes 64 x
// kWgmmaBN x 1 (K-major B). With kTA the expert's filled rows bound the sum
// over K: its k-loop ends at ceil(rows[e] / 64) stages, and in the last one
// the rows of both tiles at or past rows[e] are zeroed before the products.
template <typename O, bool kNK, bool kTA>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
             O* __restrict__ out, const int* __restrict__ rows, int M, int N, int K) {
  static_assert(!(kNK && kTA), "an MN-major x takes (K, N) weights only");
  const int m0 = blockIdx.x * kWgmmaBM;
  const int n0 = blockIdx.y * kWgmmaBN;
  const int e = blockIdx.z;
  const int me = expert_rows(rows, e, kTA ? K : M);
  out += (size_t)e * M * N;
  if (kTA ? me == 0 : m0 >= me) {  // a tile past the expert's filled rows: zeros, no loads
    for (int i = threadIdx.x; i < kWgmmaBM * kWgmmaBN; i += kWgmmaThreads) {
      const int r = m0 + i / kWgmmaBN, c = n0 + i % kWgmmaBN;
      if (r < M && c < N) out[(size_t)r * N + c] = from_float<O>(0.f);
    }
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  uint8_t* a_s = smem_raw + pad;
  uint8_t* b_s = a_s + kWgmmaStages * kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + kWgmmaStages * kBBytes);
  uint64_t* empty = full + kWgmmaStages;

  const int ktiles = ((kTA ? me : K) + kWgmmaBK - 1) / kWgmmaBK;
  // rows of the last stage at or past the filled ones (TMA zero-fills past K)
  const int tail = kTA && me < K ? me % kWgmmaBK : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgmmaStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kWgmmaStages;
        if (kt >= kWgmmaStages) hopper::mbar_wait(&empty[s], ((kt / kWgmmaStages) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
        if constexpr (kTA) {
#pragma unroll
          for (int j = 0; j < kWgmmaBM / 64; ++j)
            hopper::tma_load_3d(a_s + s * kABytes + j * kBoxBytes, &tx, &full[s], m0 + 64 * j,
                                kt * kWgmmaBK, e);
        } else {
          hopper::tma_load_3d(a_s + s * kABytes, &tx, &full[s], kt * kWgmmaBK, m0, e);
        }
        if constexpr (kNK) {
          hopper::tma_load_3d(b_s + s * kBBytes, &tw, &full[s], kt * kWgmmaBK, n0, e);
        } else {
#pragma unroll
          for (int j = 0; j < kWgmmaBN / 64; ++j)
            hopper::tma_load_3d(b_s + s * kBBytes + j * kBoxBytes, &tw, &full[s], n0 + 64 * j,
                                kt * kWgmmaBK, e);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    float acc[kWgmmaBN / 2];
#pragma unroll
    for (int i = 0; i < kWgmmaBN / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kWgmmaStages;
      hopper::mbar_wait(&full[s], (kt / kWgmmaStages) & 1);
      if (tail != 0 && kt == ktiles - 1) {
        // Rows tail..63 of every box of both tiles (x's two, w's four) hold
        // slots past the filled ones: zero them (a whole 128-byte row each,
        // whatever the swizzle), then order the stores before the async
        // proxy's reads and wait for both consumer warpgroups.
        constexpr int kBoxes = (kABytes + kBBytes) / kBoxBytes;
        const int chunks = (kWgmmaBK - tail) * 8;  // 16-byte chunks a box
        for (int i = threadIdx.x - 128; i < kBoxes * chunks; i += 256) {
          const int box = i / chunks, r = tail + (i % chunks) / 8, q = i % 8;
          uint8_t* base = box < kABytes / kBoxBytes ? a_s + s * kABytes + box * kBoxBytes
                                                    : b_s + s * kBBytes + (box - kABytes / kBoxBytes) * kBoxBytes;
          *reinterpret_cast<uint4*>(base + r * 128 + q * 16) = make_uint4(0, 0, 0, 0);
        }
        hopper::fence_proxy_async();
        hopper::named_barrier(1, 256);
      }
      const uint32_t a_addr =
          hopper::smem_u32(a_s + s * kABytes) + c * (kTA ? kBoxBytes : 64 * 128);
      const uint32_t b_addr = hopper::smem_u32(b_s + s * kBBytes);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgmmaBK / 16; ++kk) {
        // x: K-major, 16 columns = 32 bytes on, or with kTA MN-major, 16 K
        // rows on in its own 64-row box; w: MN-major, 16 K rows on, its
        // 64-column boxes kBoxBytes apart, or K-major like x
        if constexpr (kTA) {
          hopper::wgmma_ss<kWgmmaBN, 1, 1>(acc,
                                           hopper::desc_sw128(a_addr + kk * 16 * 128, kBoxBytes, 1024),
                                           hopper::desc_sw128(b_addr + kk * 16 * 128, kBoxBytes, 1024),
                                           1);
        } else if constexpr (kNK) {
          hopper::wgmma_ss<kWgmmaBN, 0>(acc, hopper::desc_sw128(a_addr + kk * 32, 16, 1024),
                                        hopper::desc_sw128(b_addr + kk * 32, 16, 1024), 1);
        } else {
          hopper::wgmma_ss<kWgmmaBN, 1>(acc, hopper::desc_sw128(a_addr + kk * 32, 16, 1024),
                                        hopper::desc_sw128(b_addr + kk * 16 * 128, kBoxBytes, 1024),
                                        1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous k-tile's products are done
      hopper::fence_regs(acc);
      if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % kWgmmaStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    // rows at or past `me` (loaded, but they reach only their own output
    // rows) are stored as zeros; with kTA every output row is live
    const int row = m0 + c * 64 + warp * 16 + lane / 4;
    const bool live0 = kTA || row < me, live8 = kTA || row + 8 < me;
#pragma unroll
    for (int j = 0; j < kWgmmaBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col < N) {
        if (row < M)
          store_cols<O>(out + (size_t)row * N, col, N, live0 ? acc[4 * j] : 0.f,
                        live0 ? acc[4 * j + 1] : 0.f);
        if (row + 8 < M)
          store_cols<O>(out + (size_t)(row + 8) * N, col, N, live8 ? acc[4 * j + 2] : 0.f,
                        live8 ? acc[4 * j + 3] : 0.f);
      }
    }
  }
}

template <typename O, bool kNK, bool kTA>
int launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* w, O* out, const int* rows, int E,
                 int M, int N, int K, cudaStream_t stream) {
  CUtensorMap tx, tw;
  // each expert's matrix is one slice of the outermost dim, so boxes stay
  // inside it and zero-fill past its own M and K; (K, M) row-major with kTA
  const cuuint64_t x_dims[3] = {(cuuint64_t)(kTA ? M : K), (cuuint64_t)(kTA ? K : M), (cuuint64_t)E};
  const cuuint64_t x_strides[2] = {(cuuint64_t)(kTA ? M : K) * 2, (cuuint64_t)M * K * 2};
  const cuuint32_t x_box[3] = {64, (cuuint32_t)(kTA ? kWgmmaBK : kWgmmaBM), 1};
  // (N, K) row-major: K innermost, rows of K * 2 bytes; (K, N): N innermost
  const cuuint64_t w_dims[3] = {(cuuint64_t)(kNK ? K : N), (cuuint64_t)(kNK ? N : K), (cuuint64_t)E};
  const cuuint64_t w_strides[2] = {(cuuint64_t)(kNK ? K : N) * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t w_box[3] = {64, (cuuint32_t)(kNK ? kWgmmaBN : kWgmmaBK), 1};
  int err = hopper::encode_bf16_sw128(&tx, x, 3, x_dims, x_strides, x_box);
  if (err == 0) err = hopper::encode_bf16_sw128(&tw, w, 3, w_dims, w_strides, w_box);
  static std::atomic<uint32_t> smem_set{0};
  if (err == 0) err = hopper::allow_smem(wgmma_kernel<O, kNK, kTA>, kWgmmaSmem, smem_set);
  if (err != 0) return err;
  dim3 grid((M + kWgmmaBM - 1) / kWgmmaBM, (N + kWgmmaBN - 1) / kWgmmaBN, E);
  wgmma_kernel<O, kNK, kTA><<<grid, kWgmmaThreads, kWgmmaSmem, stream>>>(tx, tw, out, rows, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O, int MM>
void launch_gemv_nk(const T* x, const T* w, O* out, const int* rows, int E, int M, int N, int K,
                    cudaStream_t stream) {
  // an expert's (N, K) slice starts N * K elements on: 16-byte aligned with w when K is
  const int vec_ok = (K % (16 / sizeof(T)) == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const int block_rows = (kThreads / 32) * kNkRowsPerWarp;
  dim3 grid((N + block_rows - 1) / block_rows, E);
  gemv_nk_kernel<T, O, MM><<<grid, kThreads, 0, stream>>>(x, w, out, rows, M, N, K, vec_ok);
}

template <typename T, typename O, int MM>
void launch_gemv(const T* x, const T* w, O* out, float* work, const int* rows, int E, int M,
                 int N, int K, int splits, cudaStream_t stream) {
  const int k_chunk = (K + splits - 1) / splits;
  // an expert's (K, N) slice starts K * N elements on: 16-byte aligned with w when N is
  const int vec_ok = (N % (16 / sizeof(T)) == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  dim3 grid((N + kGemvCols - 1) / kGemvCols, splits, E);
  gemv_kernel<T, O, MM><<<grid, kThreads, 0, stream>>>(
      x, w, out, splits > 1 ? work : nullptr, rows, M, N, K, k_chunk, vec_ok);
  if (splits > 1) {
    const int mn = E * M * N;
    split_reduce_kernel<O><<<(mn + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        work, out, mn, splits);
  }
}

enum Route { kRouteGemv = 0, kRouteSimt = 1, kRouteWgmma = 2 };

template <typename T, typename O>
int run(const void* x_, const void* w_, void* out_, void* work, const int* rows, int E, int M,
        int N, int K, int route, int splits, int nk, int ta, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  O* out = static_cast<O*>(out_);
  float* ws = static_cast<float*>(work);
  if (route == kRouteWgmma) {
    if constexpr (sizeof(T) == 2) {
      if (ta) return launch_wgmma<O, false, true>(x, w, out, rows, E, M, N, K, stream);
      return nk ? launch_wgmma<O, true, false>(x, w, out, rows, E, M, N, K, stream)
                : launch_wgmma<O, false, false>(x, w, out, rows, E, M, N, K, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == kRouteSimt) {
    dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, E);
    if (ta)
      tiled_kernel<T, O, false, true><<<grid, kThreads, 0, stream>>>(x, w, out, rows, M, N, K);
    else if (nk)
      tiled_kernel<T, O, true, false><<<grid, kThreads, 0, stream>>>(x, w, out, rows, M, N, K);
    else
      tiled_kernel<T, O, false, false><<<grid, kThreads, 0, stream>>>(x, w, out, rows, M, N, K);
  } else if (nk) {
    if (M == 1)
      launch_gemv_nk<T, O, 1>(x, w, out, rows, E, M, N, K, stream);
    else if (M <= 2)
      launch_gemv_nk<T, O, 2>(x, w, out, rows, E, M, N, K, stream);
    else if (M <= 4)
      launch_gemv_nk<T, O, 4>(x, w, out, rows, E, M, N, K, stream);
    else
      launch_gemv_nk<T, O, kGemvMaxM>(x, w, out, rows, E, M, N, K, stream);
  } else if (M == 1) {
    launch_gemv<T, O, 1>(x, w, out, ws, rows, E, M, N, K, splits, stream);
  } else if (M <= 2) {
    launch_gemv<T, O, 2>(x, w, out, ws, rows, E, M, N, K, splits, stream);
  } else if (M <= 4) {
    launch_gemv<T, O, 4>(x, w, out, ws, rows, E, M, N, K, splits, stream);
  } else {
    launch_gemv<T, O, kGemvMaxM>(x, w, out, ws, rows, E, M, N, K, splits, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. w_layout: 0 = w (K, N), 1 = w (N, K)
// (out = x @ w^T). x_layout: 0 = x (M, K), 1 = x (K, M) (out = x^T @ w, with
// w_layout 0 only). E >= 1 experts: each operand and out (M, N) stacked on a
// leading E, contiguous; `rows` (int32 (E,) on the device, or null) bounds
// each expert's rows of x and out with x_layout 0 (rows past it are 0) and
// its terms of the sum over K with x_layout 1. route: 0 = gemv (M <= 8,
// x_layout 0; for (K, N) weights K cut into `splits` >= 1 chunks, which
// needs a float32 workspace of splits * E * M * N when splits > 1; for
// (N, K) weights splits = 1), 1 = simt tiles, 2 = wgmma (bfloat16 in, M >
// 8, K a multiple of 8 and, for (K, N) weights, N too, and M with x_layout
// 1; x and w 16-byte aligned); anything else is refused. Returns
// cudaGetLastError() after the launches.
extern "C" int stream_matmul(const void* x, const void* w, void* out, void* work,
                             const int* rows, int E, int M, int N, int K, int route, int splits,
                             int in_dtype, int out_dtype, int w_layout, int x_layout, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || E <= 0 || E > 65535 || w_layout < 0 || w_layout > 1 ||
      x_layout < 0 || x_layout > 1 || (x_layout == 1 && (w_layout != 0 || route == kRouteGemv)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteGemv && (splits < 1 || M > kGemvMaxM || (w_layout == 1 && splits != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWgmma &&
      (in_dtype != 1 || M <= kGemvMaxM || K % 8 || (w_layout == 0 && N % 8) ||
       (x_layout == 1 && M % 8) || reinterpret_cast<uintptr_t>(x) % 16 ||
       reinterpret_cast<uintptr_t>(w) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route < kRouteGemv || route > kRouteWgmma) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nk = w_layout, ta = x_layout;
  if (in_dtype == 1 && out_dtype == 1)
    return run<__nv_bfloat16, __nv_bfloat16>(x, w, out, work, rows, E, M, N, K, route, splits, nk, ta, s);
  if (in_dtype == 1 && out_dtype == 0)
    return run<__nv_bfloat16, float>(x, w, out, work, rows, E, M, N, K, route, splits, nk, ta, s);
  if (in_dtype == 0 && out_dtype == 1)
    return run<float, __nv_bfloat16>(x, w, out, work, rows, E, M, N, K, route, splits, nk, ta, s);
  if (in_dtype == 0 && out_dtype == 0)
    return run<float, float>(x, w, out, work, rows, E, M, N, K, route, splits, nk, ta, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
