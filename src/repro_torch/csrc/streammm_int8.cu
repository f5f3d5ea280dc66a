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
// half the bytes of the bf16 stream_matmul at the same (K, N). At M = 4096
// (prefill-sized x) the product does 2 * 4096 flops a weight and is bound by
// the bf16 tensor-core rate.
//
// Three routes, chosen by the wrapper (ops.py, int8_route) from dtype, shape
// and alignment:
//  * gemv (M <= 8): a block owns a slab of 256 output columns and a run
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
//  * wgmma (bf16 x, M > 8, N % 16 == 0, block_k a multiple of 64, 16-byte
//    aligned operands): tensor cores with exact products. An int8 weight
//    (|q| <= 127) is exact in bf16 and a bf16 x times it is exact in the
//    tensor core's f32 product, so the scale is taken out of the product: a
//    scale group's (block_k rows') products go to an f32 partial, and at the
//    group's end partial * scale[n] is added to the f32 accumulator. The
//    result differs from the reference (dequantise, then an f32 product) only
//    in the order of f32 sums. Neither shortcut is taken: folding the scale
//    into a bf16 weight would round every weight, and an int8 x int8 product
//    would quantise x. The product is computed transposed, out^T = w^T x^T,
//    so that the weights are wgmma's A operand, which may come from
//    registers: an output tile is 128 weight columns x 192 rows of x (the
//    widest whose f32 accumulator and group partial, 96 floats each, fit a
//    consumer's registers); one producer thread streams, through a ring of
//    stages, the 192 x 64 x tile (K-major, 128-byte swizzle: the B operand),
//    the 64 x 128 int8 weight
//    tile (128-byte swizzle) and the tile's 128-column scale row by TMA; two
//    consumer warpgroups each gather the A fragments of their 64 weight
//    columns with ldmatrix.trans and convert them to bf16, unscaled and
//    exactly (two bit masks and one packed bf16 add a pair, off the slow
//    conversion pipe), for the next k-tile while this one's m64n192k16 run.
//    Blocks are persistent (one an SM, walking output tiles), so the next
//    tile's loads run under the last one's stores. K can be cut into runs of
//    whole scale groups (the wrapper's rule, for small outputs), added in
//    split order as on the gemv route.
//  * simt (f32 x, or shapes TMA cannot describe): 64x64 shared-memory tiles
//    with a 4x4 register micro-tile a thread, f32 throughout; each weight is
//    dequantised with its scale as the tile is loaded into shared memory.
// Any M and N on the gemv and simt routes: ragged edges are masked; 16-byte
// loads are used only when N is a multiple of 16 and the weights and scales
// are 16-byte aligned, else the kernel loads element by element. K must be a
// multiple of block_k (the scales' contract).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ---- wgmma route ---------------------------------------------------------------
//
// The product is taken transposed, out^T = w^T x^T, so that the weights are
// wgmma's A operand, which may come from registers: each consumer thread
// gathers its fragment of an int8 tile from shared memory and converts it to
// bf16 in registers, where a B operand would have to be written back to shared
// memory as bf16 first. x is the B operand, read by the descriptor from its
// TMA tile (K-major, 128-byte swizzle).

constexpr int kI8BM = 192;        // x rows of a block (the wgmma's N)
constexpr int kI8BN = 128;        // weight columns of a block: 64 a consumer warpgroup (the wgmma's M)
constexpr int kI8BK = 64;         // K rows of a stage
constexpr int kI8Threads = 384;   // producer warpgroup + two consumers
constexpr int kI8Stages = 6;
constexpr int kI8XBytes = kI8BM * kI8BK * 2;   // x tile, bf16
constexpr int kI8WBytes = kI8BK * kI8BN;       // int8 weight tile, 128-byte swizzled rows
constexpr int kI8ScaleBytes = kI8BN * 4;       // the tile's scale row
constexpr int kI8TmaBytes = kI8XBytes + kI8WBytes + kI8ScaleBytes;
constexpr int kI8Smem = 1024 + kI8Stages * kI8TmaBytes + 2 * kI8Stages * 8;

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

// Two int8 weights, the low bytes of the 16-bit halves of `w`, -> a bf16 pair,
// exactly, in three integer operations and one packed bf16 add: a byte t of
// value q = low7 - 128 * sign, with low7 = t & 0x7f, gives the bf16 128 + low7
// (0x4300 | low7: 7 mantissa bits, exact) and the bf16 -128 - 128 * sign
// (0xc300 | (t & 0x80)); their sum q is exact in bf16 (|q| <= 128).
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w) {
  const uint32_t hi = (w & 0x007f007fu) | 0x43004300u;
  const uint32_t lo = (w & 0x00800080u) | 0xc300c300u;
  const __nv_bfloat162 sum = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&hi),
                                     *reinterpret_cast<const __nv_bfloat162*>(&lo));
  return *reinterpret_cast<const uint32_t*>(&sum);
}

// A thread's A fragment rows R and R + 8 are the block's weight columns n and
// n + 1 (n = 16 * chunk + 2 * r, r = lane / 4); its fragment columns of each
// k-step are the K rows 2q, 2q + 1, 2q + 8, 2q + 9 of the step (q = lane % 4).
// Read as 16-bit elements (column pairs), the warp's 16 columns of 8 K rows
// are an 8 x 8 matrix, and ldmatrix.trans hands thread (r, q) exactly its
// pairs of rows 2q and 2q + 1. A call loads four such matrices, (kk, h) for
// kk of the call's two k-steps and h = 0, 1 (rows 16 kk + 8 h ..): the
// shared-memory offset of this thread's row, in the first call, of the tile
// whose row k holds 128 columns with 16-byte chunk c at c ^ (k % 8).
__device__ __forceinline__ uint32_t gather_offset(int lane, int chunk) {
  const int m = lane / 8, row = lane % 8;
  return (16 * (m / 2) + 8 * (m % 2) + row) * kI8BN + ((chunk ^ row) << 4);
}

// The A fragments (64 weight columns x 16 K rows, bf16, unscaled) of a whole
// k-tile: a[kk][0] = (w[k0][n], w[k0 + 1][n]) with k0 = 16 kk + 2q, a[kk][1]
// the same rows of column n + 1, a[kk][2], a[kk][3] the same 8 rows on.
__device__ __forceinline__ void load_tile(uint32_t w, uint32_t off, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int call = 0; call < 2; ++call) {
    uint32_t d[4];
    hopper::ldmatrix_x4_trans(w + off + call * 32 * kI8BN, d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // d[j] = (w[k0][n], w[k0][n + 1], w[k0 + 1][n], w[k0 + 1][n + 1]):
      // column n's pair of rows is bytes 0 and 2, column n + 1's bytes 1 and 3
      const int kk = 2 * call + j / 2, h = j % 2;
      a[kk][2 * h] = i8x2_to_bf16x2(__byte_perm(d[j], 0, 0x4240));
      a[kk][2 * h + 1] = i8x2_to_bf16x2(__byte_perm(d[j], 0, 0x4341));
    }
  }
}

// One k-tile's 4 wgmma m64n192k16 into `part` (zeroed first where `fresh`):
// A, the weights, from registers; B, the x tile, K-major.
__device__ __forceinline__ void mma_tile(float (&part)[kI8BM / 2], const uint32_t (&a)[4][4],
                                         uint32_t x_addr, bool fresh) {
  hopper::fence_regs(part);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kI8BK / 16; ++kk)
    hopper::wgmma_rs<kI8BM, 0>(part, a[kk], hopper::desc_sw128(x_addr + kk * 32, 16, 1024),
                               !fresh || kk > 0);
  hopper::wgmma_commit();
}

// A block's output tile t of ceil(M / 128) x ceil(N / 128) x splits, rows
// fastest (the blocks at work together share weight columns): its first x
// row and weight column, and its k-tiles [kt0, kt0 + nk), the scale groups
// [z * gps, (z + 1) * gps) of split z.
struct Tile {
  int m0, n0, z, kt0, nk;
};
__device__ __forceinline__ Tile tile_at(int t, int m_tiles, int n_tiles, int K, int tpg, int gps) {
  Tile tl;
  tl.m0 = (t % m_tiles) * kI8BM;
  tl.n0 = (t / m_tiles % n_tiles) * kI8BN;
  tl.z = t / (m_tiles * n_tiles);
  tl.kt0 = tl.z * gps * tpg;
  tl.nk = max(0, min(K / kI8BK, tl.kt0 + gps * tpg) - tl.kt0);
  return tl;
}

// Persistent: grid = min(tiles, SMs), block b takes tiles b, b + gridDim.x,
// ..., so that the producer streams the next tile's stages while the
// consumers store the last one. The stage ring and its phases run on across
// tiles (g counts the k-tiles a block has taken). tx: x as (K, M) innermost
// first, boxes 64 x 128, 128B swizzle; tw: w_q as (N, K) uint8, boxes
// 128 x 64, 128B swizzle; ts: scales as (N, K / block_k) f32, boxes 128 x 1.
// With splits > 1 a tile of split z writes f32 sums to work[z] instead of out.
template <typename O>
__global__ void __launch_bounds__(kI8Threads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
             const __grid_constant__ CUtensorMap ts, O* __restrict__ out,
             float* __restrict__ work, int M, int N, int K, int block_k, int gps, int splits) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  uint8_t* x_s = smem_raw + pad;
  uint8_t* w_s = x_s + kI8Stages * kI8XBytes;
  float* sc_s = reinterpret_cast<float*>(w_s + kI8Stages * kI8WBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(sc_s + kI8Stages * kI8BN);
  uint64_t* empty = full + kI8Stages;

  const int m_tiles = (M + kI8BM - 1) / kI8BM, n_tiles = (N + kI8BN - 1) / kI8BN;
  const int tiles = m_tiles * n_tiles * splits;
  const int tpg = block_k / kI8BK;  // k-tiles of a scale group
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kI8Stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<24>();  // the producer needs few; the consumers take 240
    if (threadIdx.x == 0) {
      int g = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_at(t, m_tiles, n_tiles, K, tpg, gps);
        for (int i = 0; i < tl.nk; ++i, ++g) {
          const int s = g % kI8Stages, kt = tl.kt0 + i;
          if (g >= kI8Stages) hopper::mbar_wait(&empty[s], ((g / kI8Stages) - 1) & 1);
          hopper::mbar_arrive_expect_tx(&full[s], kI8TmaBytes);
          hopper::tma_load_2d(x_s + s * kI8XBytes, &tx, &full[s], kt * kI8BK, tl.m0);
          hopper::tma_load_2d(w_s + s * kI8WBytes, &tw, &full[s], tl.n0, kt * kI8BK);
          hopper::tma_load_2d(sc_s + s * kI8BN, &ts, &full[s], tl.n0, kt * kI8BK / block_k);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();  // a 96-float accumulator and partial, two fragment sets
    const int c = wg - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int r = lane / 4, q = lane % 4;
    const int chunk = 4 * c + warp;       // 16-column chunk of this warp's weight columns
    const int nl = 16 * chunk + 2 * r;    // this thread's columns nl, nl + 1 of the block
    float acc[kI8BM / 2], part[kI8BM / 2];
    uint32_t a0[4][4], a1[4][4];  // A fragments of even and odd k-tiles
    const uint32_t go = gather_offset(lane, chunk);
    const uint32_t w_base = hopper::smem_u32(w_s);

    int g = 0;  // k-tiles of this block's earlier tiles
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_at(t, m_tiles, n_tiles, K, tpg, gps);
      const int nk = tl.nk;
#pragma unroll
      for (int i = 0; i < kI8BM / 2; ++i) acc[i] = 0.f;
      // One scale group (tpg k-tiles) at a time. k-tile i (stage (g + i) % S):
      // its wgmma issued, the previous k-tile's waited for (its fragments and
      // stage free again), the next k-tile's fragments gathered while this
      // one's products run (each parity in a branch of its own, so that ptxas
      // sees which fragments are in flight); at the group's end every product
      // waited for and part * scale added to acc.
      if (nk > 0) {
        hopper::mbar_wait(&full[g % kI8Stages], (g / kI8Stages) & 1);
        load_tile(w_base + (g % kI8Stages) * kI8WBytes, go, a0);
      }
      for (int i0 = 0; i0 < nk; i0 += tpg) {
        for (int i = i0; i < i0 + tpg; ++i) {
          const uint32_t x_addr = hopper::smem_u32(x_s + ((g + i) % kI8Stages) * kI8XBytes);
          const int i1 = g + (i + 1 < nk ? i + 1 : i);  // the next k-tile (none: this one again)
          const int s1 = i1 % kI8Stages;
          if (i & 1) {
            mma_tile(part, a1, x_addr, i == i0);
            hopper::wgmma_wait<1>();  // the previous k-tile's products are done
            hopper::fence_regs(part);
            hopper::mbar_wait(&full[s1], (i1 / kI8Stages) & 1);
            load_tile(w_base + s1 * kI8WBytes, go, a0);
          } else {
            mma_tile(part, a0, x_addr, i == i0);
            hopper::wgmma_wait<1>();
            hopper::fence_regs(part);
            hopper::mbar_wait(&full[s1], (i1 / kI8Stages) & 1);
            load_tile(w_base + s1 * kI8WBytes, go, a1);
          }
          if (i > i0 && lane == 0) hopper::mbar_arrive(&empty[(g + i - 1) % kI8Stages]);
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(part);
        const int s = (g + i0 + tpg - 1) % kI8Stages;
        // part[4j + e] is weight column nl + e / 2, x row 8j + 2q + e % 2
        const float2 sv = *reinterpret_cast<const float2*>(sc_s + s * kI8BN + nl);
#pragma unroll
        for (int j = 0; j < kI8BM / 8; ++j) {
          acc[4 * j] = fmaf(part[4 * j], sv.x, acc[4 * j]);
          acc[4 * j + 1] = fmaf(part[4 * j + 1], sv.x, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(part[4 * j + 2], sv.y, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(part[4 * j + 3], sv.y, acc[4 * j + 3]);
        }
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      }
      g += nk;

      // out[m][n], out[m][n + 1] side by side: one 4- or 8-byte store each
      const int n = tl.n0 + nl;
      if (n < N) {
        float* wz = work != nullptr ? work + (size_t)tl.z * M * N : nullptr;
#pragma unroll
        for (int j = 0; j < kI8BM / 8; ++j) {
          const int m = tl.m0 + 8 * j + 2 * q;
          if (wz != nullptr) {
            if (m < M) store2<float>(wz + (size_t)m * N + n, acc[4 * j], acc[4 * j + 2]);
            if (m + 1 < M) store2<float>(wz + (size_t)(m + 1) * N + n, acc[4 * j + 1], acc[4 * j + 3]);
          } else {
            if (m < M) store2<O>(out + (size_t)m * N + n, acc[4 * j], acc[4 * j + 2]);
            if (m + 1 < M) store2<O>(out + (size_t)(m + 1) * N + n, acc[4 * j + 1], acc[4 * j + 3]);
          }
        }
      }
    }
  }
}

template <typename O>
int launch_wgmma(const __nv_bfloat16* x, const int8_t* w, const float* scales, O* out,
                 float* work, int M, int N, int K, int block_k, int splits, cudaStream_t stream) {
  CUtensorMap tx, tw, ts;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t x_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t x_box[2] = {64, kI8BM};
  const cuuint64_t w_dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t w_strides[1] = {(cuuint64_t)N};
  const cuuint32_t w_box[2] = {kI8BN, kI8BK};
  const cuuint64_t s_dims[2] = {(cuuint64_t)N, (cuuint64_t)(K / block_k)};
  const cuuint64_t s_strides[1] = {(cuuint64_t)N * 4};
  const cuuint32_t s_box[2] = {kI8BN, 1};
  int err = hopper::encode_bf16_sw128(&tx, x, 2, x_dims, x_strides, x_box);
  if (err == 0)
    err = hopper::encode_tiled(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, 2, w_dims, w_strides, w_box,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = hopper::encode_tiled(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, 2, s_dims, s_strides,
                               s_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  static std::atomic<uint32_t> smem_set{0};
  if (err == 0) err = hopper::allow_smem(wgmma_kernel<O>, kI8Smem, smem_set);
  if (err != 0) return err;
  static int sm_counts[32] = {};  // the SM count of each device, read once
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  if (sm_counts[dev] == 0) {
    err = static_cast<int>(cudaDeviceGetAttribute(&sm_counts[dev], cudaDevAttrMultiProcessorCount, dev));
    if (err != 0) return err;
  }
  const int groups = K / block_k;
  const int gps = (groups + splits - 1) / splits;
  const long tiles = (long)((M + kI8BM - 1) / kI8BM) * ((N + kI8BN - 1) / kI8BN) * splits;
  const int blocks = static_cast<int>(tiles < sm_counts[dev] ? tiles : sm_counts[dev]);
  wgmma_kernel<O><<<blocks, kI8Threads, kI8Smem, stream>>>(tx, tw, ts, out,
                                                           splits > 1 ? work : nullptr, M, N, K,
                                                           block_k, gps, splits);
  if (splits > 1) {
    const int mn = M * N;
    split_reduce_kernel<O><<<(mn + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        work, out, mn, splits);
  }
  return static_cast<int>(cudaGetLastError());
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

enum Route { kRouteGemv = 0, kRouteSimt = 1, kRouteWgmma = 2 };

template <typename T, typename O>
int run(const void* x_, const void* w_, const void* s_, void* out_, void* work, int M, int N,
        int K, int block_k, int route, int splits, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const int8_t* w = static_cast<const int8_t*>(w_);
  const float* s = static_cast<const float*>(s_);
  O* out = static_cast<O*>(out_);
  float* ws = static_cast<float*>(work);
  if (route == kRouteWgmma) {
    if constexpr (sizeof(T) == 2)
      return launch_wgmma<O>(x, w, s, out, ws, M, N, K, block_k, splits, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == kRouteSimt) {
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
// dtype codes: 0 = float32, 1 = bfloat16. route: 0 = gemv (M <= 8), 1 = simt
// tiles, 2 = wgmma (bfloat16 x, M > 8, N % 16 == 0, block_k % 64 == 0, x, w
// and scales 16-byte aligned); anything else is refused. On the gemv and
// wgmma routes the K / block_k groups are cut into `splits` >= 1 runs, which
// needs a float32 workspace of splits * M * N when splits > 1; the simt route
// takes splits = 1. Returns cudaGetLastError() after the launches.
extern "C" int stream_matmul_int8(const void* x, const void* w, const void* scales, void* out,
                                  void* work, int M, int N, int K, int block_k, int route,
                                  int splits, int in_dtype, int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block_k <= 0 || K % block_k != 0 || splits < 1 ||
      splits > K / block_k || (splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteGemv && M > kGemvMaxM) return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteSimt && splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWgmma &&
      (in_dtype != 1 || M <= kGemvMaxM || N % 16 || block_k % kI8BK ||
       reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
       reinterpret_cast<uintptr_t>(scales) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route < kRouteGemv || route > kRouteWgmma) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && out_dtype == 1)
    return run<__nv_bfloat16, __nv_bfloat16>(x, w, scales, out, work, M, N, K, block_k, route,
                                             splits, s);
  if (in_dtype == 1 && out_dtype == 0)
    return run<__nv_bfloat16, float>(x, w, scales, out, work, M, N, K, block_k, route, splits, s);
  if (in_dtype == 0 && out_dtype == 1)
    return run<float, __nv_bfloat16>(x, w, scales, out, work, M, N, K, block_k, route, splits, s);
  if (in_dtype == 0 && out_dtype == 0)
    return run<float, float>(x, w, scales, out, work, M, N, K, block_k, route, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
