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
// Four routes, chosen by the wrapper (ops.py, mm_route) from dtype and shape:
//  * gemv (M <= 8): one launch, gemv_stream_kernel below. A block owns a
//    slab of 256 bytes of every weight row (128 bf16 or 64 f32 columns) and a
//    chunk of K; its threads stream the slab with 16-byte evict-first loads,
//    the next eight rows a thread in flight while the FMAs of the last eight
//    run, against x staged once in shared memory as f32. The K splits of a
//    slab (1, 2, 4 or 8, the wrapper's k_splits, the fewest that give
//    nearly every SM a block) are one thread-block cluster, whose ranks add their partial sums
//    in rank order through distributed shared memory: no workspace, no
//    second kernel, no atomics, the same bits on every run, which the live
//    runtime's transparency check relies on. Weights whose rows 16-byte
//    loads cannot walk (N not a multiple of 16 bytes, an unaligned base)
//    take the scalar kernel, gemv_kernel, K whole: a rule of shape.
//  * wgmma (bf16, M > 8, K and N multiples of 8, or with x given as (K, M)
//    M and N and any K, 16-byte aligned operands):
//    tensor cores fed by TMA. A block owns a 128 x kWgmmaBN output tile. One
//    producer thread streams 128 x 64 tiles of x (K-major) and 64 x kWgmmaBN
//    tiles of w, as 64-column boxes of its (K, N) row-major layout (MN-major,
//    the wgmma transpose bit; the weights are used in place, never copied),
//    through a ring of stages in shared memory with 128-byte swizzle; full and
//    empty mbarriers hand the stages over. Two consumer warpgroups (setmaxnreg
//    moves registers to them) each run wgmma m64nNk16 over 64 rows into f32
//    registers, keeping one k-tile's wgmma group in flight, and store their
//    rows with masks. TMA zero-fills past M, N and K, so a K tail adds 0 and
//    ragged M and N are masked at the store. No split-K, no atomics. With x
//    given as (K, M) (every dW) a persistent kernel of its own,
//    wgmma_km_kernel, below.
//  * narrow (f32, M > 8, a narrow side: N <= 128 of a (K, N) weight, or K <=
//    128 of an (N, K) one; rows of 16-byte multiples, aligned bases): the MoE
//    router x @ w_router (N = E of 8 or 128, K = d), its dW x^T @ dY (x read
//    in place as (K, M), N = E) and its dX dY @ w_router^T (K = E). Output
//    tiles shaped to the narrow side: 256 x 8 where N <= 8, else 128 x 128
//    with an 8 x 8 register micro-tile a thread; K tiles staged in two
//    shared-memory buffers behind 16-byte loads along each operand's
//    contiguous axis; 16-byte stores. Where the output's tiles are too few to
//    fill the SMs (the router at M = 4096 makes 16 or 32 of them, its dW 24
//    or 56), the wrapper cuts K across blocks, and each writes its partial
//    sums to a workspace that split_reduce_kernel adds in split order.
//    Exact f32 FFMA, no atomics: the same bits on every run.
//    Bound: the bytes of x at E = 8 (8 products a 4-byte element), the f32
//    operations at E = 128; the dX at E = 8 by the bytes of its output.
//  * simt (other f32 shapes, or shapes TMA cannot describe): plain 64x64
//    shared-memory tiles with a 4x4 register micro-tile per thread, f32
//    throughout: f32 products stay exact f32 (never TF32).
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
//  * gemv: grid (column slabs, K splits, slots), slots <= E the wrapper's
//    bound on the experts a call hits (min(E, top_k x tokens) from the MoE
//    layer): each slot walks the experts that hold a row, found by a prefix
//    count over `rows` on the device, and the empty ones' zeros are written
//    by the same launch; the K splits, counted over the slots' slabs, are
//    summed in the cluster as in the 2-D form;
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
//    (K, N)), the sum over the filled slots only. On the wgmma route
//    (wgmma_km_kernel, persistent, its epilogue through shared memory and TMA
//    stores) x is an MN-major A (the transpose bit of wgmma's A; two 64 x 64
//    TMA boxes of x as (K, M, E) a stage), dY an MN-major B as the forward's
//    (K, N) weight; the k-loop of expert e ends at ceil(rows[e] / 64) stages,
//    and in the last one the consumers zero the rows at or past rows[e] of
//    both tiles in shared memory before the products, so slots past the count
//    add nothing whatever they hold; an expert with rows[e] = 0 reads nothing
//    and writes zeros. The narrow and simt routes load those terms as 0.
//    Bound: the filled rows' operations, or the bytes of dW written plus x
//    and dY read (arctic-480b's 8.9 GB of bf16 dW at 80 slots an expert).
// The 2-D form's dW uses the same x_layout = 1 (E = 1, no rows), so x is
// read in place there too.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

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

// The scalar gemv, kept for weights whose rows 16-byte loads cannot walk (N
// not a multiple of 16 bytes, or an unaligned base): grid = (ceil(N / 256),
// 1, E); block = 256 threads, each walking one column of its slab for every
// RPI-th row of K with scalar loads. Expert e = blockIdx.z reads x[e] (M, K)
// and w[e] (K, N) and writes out[e] (M, N). MM is M rounded up to 1, 2, 4 or
// 8 (register arrays need a fixed size).
template <typename T, typename O, int MM>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const T* __restrict__ x, const T* __restrict__ w, O* __restrict__ out,
            const int* __restrict__ rows, int M, int N, int K) {
  constexpr int V = 16 / sizeof(T);         // columns a thread owns
  constexpr int TPR = kGemvCols / V;        // threads across one row of the slab
  constexpr int RPI = kThreads / TPR;       // rows read per iteration
  __shared__ float red[RPI][kGemvCols];

  const int e = blockIdx.z;
  const int me = expert_rows(rows, e, M);
  x += (size_t)e * M * K;
  w += (size_t)e * K * N;
  out += (size_t)e * M * N;
  const int col = blockIdx.x * kGemvCols + threadIdx.x;
  if (me == 0) {  // an empty expert: zeros, and none of its weight is read
    if (col < N)
      for (int m = 0; m < M; ++m) out[(size_t)m * N + col] = from_float<O>(0.f);
    return;
  }

  const int c = threadIdx.x % TPR;
  const int r = threadIdx.x / TPR;
  const int col0 = blockIdx.x * kGemvCols + c * V;

  float acc[MM][V];
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[m][v] = 0.f;

#pragma unroll 4
  for (int k = r; k < K; k += RPI) {
    float wv[V];
    const T* row = w + (size_t)k * N;
#pragma unroll
    for (int v = 0; v < V; ++v) wv[v] = (col0 + v < N) ? to_float(row[col0 + v]) : 0.f;
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
    if (col < N) out[(size_t)m * N + col] = from_float<O>(s);
    __syncthreads();
  }
}

// out[i] = sum over splits s, in order, of work[s, i], i over the E * M * N
// outputs (the narrow route's K splits).
template <typename O>
__global__ void split_reduce_kernel(const float* __restrict__ work, O* __restrict__ out,
                                    int MN, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int j = 0; j < splits; ++j) s += work[(size_t)j * MN + i];
  out[i] = from_float<O>(s);
}

// -- the streaming gemv (M <= 8, (K, N) weights whose rows 16-byte loads walk) --
//
// A block owns a slab of kGemvRowBytes (256) bytes of every weight row, 128
// bf16 or 64 f32 columns: 16 threads across a row, 16 rows at a time, each
// thread's 16-byte loads streamed past L1 with the evict-first hint (every
// weight byte is read once). A thread keeps kGemvUnroll loads of the next
// rows in flight while it does the FMAs of the rows that have arrived, 32 KB
// to 64 KB of weights in flight a block, the first of them issued before x
// is staged. x is staged once in shared memory as f32, 16 KB at a time (4096
// / M rows of K), laid out (k, m) so that a row's M values are one or two
// vector reads that the 16 threads of a row share.
// The K splits of a slab are the blocks of one thread-block cluster along
// grid y (1, 2, 4 or 8 blocks, the wrapper's k_splits): each block reduces
// its row groups (a shuffle between the two groups of a warp, then the eight
// warps in order through shared memory), and the cluster's ranks add the
// splits' sums in rank order through distributed shared memory, each rank a
// share of the slab's outputs. One launch, no workspace, no atomics: the
// same bits on every run.
//
// Experts: grid z is `slots` <= E (the wrapper's bound on the experts a
// call hits). Slot s computes the experts whose index among those with
// rows[e] > 0 is s, s + slots, ...: a prefix count over `rows` that every
// block of a cluster takes alike, read on the device. An expert with no rows
// reads none of its weight; the blocks of split 0 write its zeros, slot e %
// slots taking expert e. Any number of non-empty experts is walked in turn,
// so the result does not depend on `slots`, only the speed does.
constexpr int kGemvRowBytes = 256;                    // bytes of a weight row a block owns
constexpr int kGemvTpr = kGemvRowBytes / 16;          // threads across a row
constexpr int kGemvRpi = kThreads / kGemvTpr;         // rows a block reads at a time
constexpr int kGemvUnroll = 8;                        // rows a thread loads ahead
constexpr int kGemvXFloats = 4096;                    // x staged at a time: 16 KB of f32
constexpr int kGemvMaxSplits = 8;                     // the portable cluster size

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack(uint4 u, float (&f)[8]) {  // 8 bf16
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {  // 4 f32
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// The M values of x at staged row kk: MM floats, 16-byte aligned for MM >= 4.
template <int MM>
__device__ __forceinline__ void x_row(const float* xs, int kk, float (&xv)[MM]) {
  if constexpr (MM >= 4) {
#pragma unroll
    for (int q = 0; q < MM / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(xs + kk * MM)[q];
      xv[4 * q] = v.x; xv[4 * q + 1] = v.y; xv[4 * q + 2] = v.z; xv[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < MM; ++m) xv[m] = xs[kk * MM + m];
  }
}

// grid = (ceil(N / cols), splits, slots), clusters of (1, splits, 1); block =
// kThreads. k_chunk = ceil(K / splits) rows a split.
template <typename T, typename O, int MM>
__global__ void __launch_bounds__(kThreads, MM <= 4 ? 2 : 1)
gemv_stream_kernel(const T* __restrict__ x, const T* __restrict__ w, O* __restrict__ out,
                   const int* __restrict__ rows, int E, int M, int N, int K, int k_chunk) {
  constexpr int V = 16 / sizeof(T);
  constexpr int COLS = kGemvTpr * V;
  constexpr int WARPS = kThreads / 32;
  constexpr int RED = WARPS * MM * COLS;
  constexpr int XR = kGemvXFloats / MM;  // rows of x staged at a time
  constexpr int XS = kGemvXFloats;
  constexpr int U = kGemvUnroll;
  __shared__ __align__(16) float buf[RED > XS ? RED : XS];  // staged x, then the warps' sums
  __shared__ __align__(16) float part[MM * COLS];           // this split's sums, read by the cluster
  __shared__ int list[kThreads], list_rows[kThreads], zlist[kThreads];
  __shared__ int warp_counts[WARPS], n_zero;

  const int split = blockIdx.y, splits = gridDim.y;
  const int slot = blockIdx.z, slots = gridDim.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = threadIdx.x % kGemvTpr, r = threadIdx.x / kGemvTpr;
  const int col0 = blockIdx.x * COLS + c * V;
  const bool col_ok = col0 < N;
  const int k_begin = split * k_chunk, k_end = min(K, k_begin + k_chunk);

  int nz_before = 0;  // experts with rows in earlier chunks of kThreads experts
  for (int base = 0; base < E; base += kThreads) {
    const int e = base + threadIdx.x;
    const int me = e < E ? expert_rows(rows, e, M) : 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, me > 0);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    if (threadIdx.x == 0) n_zero = 0;
    __syncthreads();
    int idx = nz_before + __popc(ballot & ((1u << lane) - 1)), total = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      idx += i < warp ? warp_counts[i] : 0;
      total += warp_counts[i];
    }
    // this slot's experts among idx in [nz_before, nz_before + total): slot + j * slots
    const int j0 = nz_before <= slot ? 0 : (nz_before - slot + slots - 1) / slots;
    const int j1 = nz_before + total <= slot ? 0 : (nz_before + total - slot + slots - 1) / slots;
    if (me > 0 && idx >= slot && (idx - slot) % slots == 0) {
      list[(idx - slot) / slots - j0] = e;
      list_rows[(idx - slot) / slots - j0] = me;
    }
    if (e < E && me == 0 && split == 0 && e % slots == slot) zlist[atomicAdd(&n_zero, 1)] = e;
    __syncthreads();
    nz_before += total;

    // empty experts: zeros over this slab (the order of the writes is immaterial)
    for (int z = 0; z < n_zero; ++z) {
      O* oz = out + (size_t)zlist[z] * M * N;
      for (int i = threadIdx.x; i < M * COLS; i += kThreads) {
        const int col = blockIdx.x * COLS + i % COLS;
        if (col < N) oz[(size_t)(i / COLS) * N + col] = from_float<O>(0.f);
      }
    }

    for (int j = 0; j < j1 - j0; ++j) {
      const int ex = list[j], mex = list_rows[j];
      const T* xe = x + (size_t)ex * M * K;
      const T* we = w + (size_t)ex * K * N + col0;
      O* oe = out + (size_t)ex * M * N;

      float acc[MM][V];
#pragma unroll
      for (int m = 0; m < MM; ++m)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] = 0.f;

      for (int kc = k_begin; kc < k_end; kc += XR) {
        const int kn = min(XR, k_end - kc);
        // this thread's rows r, r + RPI, ... of the next kn, U at a time: the
        // first U loads fly while x is staged, and each next U before the
        // FMAs of these
        const int nrows = kn > r ? (kn - r + kGemvRpi - 1) / kGemvRpi : 0;
        const T* wr = we + (size_t)(kc + r) * N;
        uint4 cur[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          cur[u] = col_ok && u < nrows ? ld_stream(wr + (size_t)u * kGemvRpi * N) : make_uint4(0, 0, 0, 0);
        __syncthreads();  // the previous rows' reads of buf are done
        for (int i = threadIdx.x; i < MM * kn; i += kThreads) {
          const int m = i / kn, kk = i % kn;  // coalesced reads of x's rows
          buf[kk * MM + m] = m < mex ? to_float(xe[(size_t)m * K + kc + kk]) : 0.f;
        }
        __syncthreads();
        for (int j0r = 0; j0r < nrows; j0r += U) {
          uint4 nxt[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int jr = j0r + U + u;
            nxt[u] = col_ok && jr < nrows ? ld_stream(wr + (size_t)jr * kGemvRpi * N) : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (j0r + u < nrows) {
              float wf[V], xv[MM];
              unpack(cur[u], wf);
              x_row<MM>(buf, r + (j0r + u) * kGemvRpi, xv);
#pragma unroll
              for (int m = 0; m < MM; ++m)
#pragma unroll
                for (int v = 0; v < V; ++v) acc[m][v] = fmaf(xv[m], wf[v], acc[m][v]);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) cur[u] = nxt[u];
        }
      }

      // the two row groups of a warp (lanes l and l ^ 16), then the warps in order
#pragma unroll
      for (int m = 0; m < MM; ++m)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] += __shfl_xor_sync(0xffffffffu, acc[m][v], 16);
      __syncthreads();  // every read of the staged x is done
      if (lane < kGemvTpr) {
#pragma unroll
        for (int m = 0; m < MM; ++m)
#pragma unroll
          for (int v = 0; v < V; v += 4)
            *reinterpret_cast<float4*>(buf + (warp * MM + m) * COLS + c * V + v) =
                make_float4(acc[m][v], acc[m][v + 1], acc[m][v + 2], acc[m][v + 3]);
      }
      __syncthreads();
      const int first = min(M, MM) * COLS;  // outputs of the rows of x that exist
      for (int i = threadIdx.x; i < first; i += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < WARPS; ++q) s += buf[q * MM * COLS + i];
        if (splits > 1) {
          part[i] = s;
        } else {
          const int m = i / COLS, col = blockIdx.x * COLS + i % COLS;
          if (col < N) oe[(size_t)m * N + col] = from_float<O>(m < mex ? s : 0.f);
        }
      }
      if (splits > 1) {  // the splits' sums in rank order, each rank a share of the outputs
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        const int per = (first + splits - 1) / splits;
        const int end = min(first, (split + 1) * per);
        for (int i = split * per + threadIdx.x; i < end; i += kThreads) {
          float p[kGemvMaxSplits];  // every rank's load in flight at once
#pragma unroll
          for (int q = 0; q < kGemvMaxSplits; ++q) p[q] = q < splits ? cluster.map_shared_rank(part, q)[i] : 0.f;
          float s = 0.f;
#pragma unroll
          for (int q = 0; q < kGemvMaxSplits; ++q)
            if (q < splits) s += p[q];
          const int m = i / COLS, col = blockIdx.x * COLS + i % COLS;
          if (col < N) oe[(size_t)m * N + col] = from_float<O>(m < mex ? s : 0.f);
        }
        cluster.sync();  // no block leaves, or refills part, while another reads it
      }
    }
    __syncthreads();  // list and zlist are read before the next chunk writes them
  }
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

// ---- narrow route (f32 with a narrow side: the MoE routers) ----------------------

constexpr int kNarrowPad = 4;  // floats of padding on each shared-memory row

template <typename O>
__device__ __forceinline__ void store4(O* p, const float (&v)[4]);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(hopper::pack_bf16x2(v[0], v[1]), hopper::pack_bf16x2(v[2], v[3]));
}

// f32 in, exact f32 FFMA (never TF32). grid = (ceil(N / BN), ceil(M / BM), E
// * splits); block = (BM / TM) * (BN / TN) threads, each a TM x TN
// micro-tile: rows ty * 4 + i (and BM / 2 on where TM = 8), columns tx * 4 +
// j (and BN / 2 on where TN = 8), so that each thread's shared-memory reads
// are 16-byte vectors that neighbouring threads take from neighbouring banks.
// Block z = e * splits + split sums K rows [split * k_chunk, + k_chunk) of
// expert e (with kTA also bounded by rows[e]); with splits > 1 it writes its
// partial sums to work[split, e] of the (splits, E, M, N) workspace, which
// split_reduce_kernel adds in split order. K tiles of BK are staged in two
// shared-memory buffers, transposed to [k][m] and [k][n]: a thread loads the
// next tile into registers (16-byte loads along each operand's contiguous
// axis) while the block computes on the current one. The wrapper takes the
// route only where every contiguous row is a multiple of 16 bytes and the
// bases are aligned, so a 4-float vector is wholly inside or outside a bound.
// kNK: w is (N, K); kTA: x is (K, M) (out = x^T @ w), as in tiled_kernel.
template <int BM, int BN, int BK, int TM, int TN, bool kNK, bool kTA, typename O>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), 2)
narrow_kernel(const float* __restrict__ x, const float* __restrict__ w, O* __restrict__ out,
              float* __restrict__ work, const int* __restrict__ rows, int E, int M, int N, int K,
              int splits, int k_chunk) {
  static_assert(TM == 4 || TM == 8, "TM is 4 or 8");
  static_assert(TN == 4 || TN == 8, "TN is 4 or 8");
  constexpr int kThr = (BM / TM) * (BN / TN);
  constexpr int TX = BN / TN;                          // threads across the columns
  constexpr int XF4 = BM * BK / 4, WF4 = BK * BN / 4;  // 16-byte vectors of a k-tile
  constexpr int XL = (XF4 + kThr - 1) / kThr, WL = (WF4 + kThr - 1) / kThr;
  __shared__ __align__(16) float xs[2][BK][BM + kNarrowPad];
  __shared__ __align__(16) float ws[2][BK][BN + kNarrowPad];

  const int e = blockIdx.z / splits, split = blockIdx.z % splits;
  const int me = expert_rows(rows, e, kTA ? K : M);
  const int m_end = kTA ? M : me;  // rows of x that are read
  const int k_begin = split * k_chunk;
  const int k_stop = min(kTA ? me : K, k_begin + k_chunk);  // terms of the sum
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  x += (size_t)e * M * K;
  w += (size_t)e * K * N;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  // a tile at or past the expert's filled rows, or an empty K range, loads
  // nothing and stores zeros
  const int ktiles = (m0 < m_end && k_begin < k_stop) ? (k_stop - k_begin + BK - 1) / BK : 0;

  float4 xr[XL], wr[WL];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int f = threadIdx.x + i * kThr;
      if (f >= XF4) break;
      if constexpr (kTA) {  // x[k][m..m+3]
        const int gk = k0 + f / (BM / 4), gm = m0 + (f % (BM / 4)) * 4;
        xr[i] = (gk < k_stop && gm < M) ? __ldg(reinterpret_cast<const float4*>(x + (size_t)gk * M + gm)) : zero;
      } else {  // x[m][k..k+3]
        const int gm = m0 + f / (BK / 4), gk = k0 + (f % (BK / 4)) * 4;
        xr[i] = (gm < m_end && gk < k_stop) ? __ldg(reinterpret_cast<const float4*>(x + (size_t)gm * K + gk)) : zero;
      }
    }
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int f = threadIdx.x + i * kThr;
      if (f >= WF4) break;
      if constexpr (kNK) {  // w[n][k..k+3]
        const int gn = n0 + f / (BK / 4), gk = k0 + (f % (BK / 4)) * 4;
        wr[i] = (gn < N && gk < k_stop) ? __ldg(reinterpret_cast<const float4*>(w + (size_t)gn * K + gk)) : zero;
      } else {  // w[k][n..n+3]
        const int gk = k0 + f / (BN / 4), gn = n0 + (f % (BN / 4)) * 4;
        wr[i] = (gk < k_stop && gn < N) ? __ldg(reinterpret_cast<const float4*>(w + (size_t)gk * N + gn)) : zero;
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int f = threadIdx.x + i * kThr;
      if (f >= XF4) break;
      if constexpr (kTA) {
        *reinterpret_cast<float4*>(&xs[buf][f / (BM / 4)][(f % (BM / 4)) * 4]) = xr[i];
      } else {
        const int m = f / (BK / 4), k = (f % (BK / 4)) * 4;
        xs[buf][k][m] = xr[i].x; xs[buf][k + 1][m] = xr[i].y;
        xs[buf][k + 2][m] = xr[i].z; xs[buf][k + 3][m] = xr[i].w;
      }
    }
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int f = threadIdx.x + i * kThr;
      if (f >= WF4) break;
      if constexpr (kNK) {
        const int n = f / (BK / 4), k = (f % (BK / 4)) * 4;
        ws[buf][k][n] = wr[i].x; ws[buf][k + 1][n] = wr[i].y;
        ws[buf][k + 2][n] = wr[i].z; ws[buf][k + 3][n] = wr[i].w;
      } else {
        *reinterpret_cast<float4*>(&ws[buf][f / (BN / 4)][(f % (BN / 4)) * 4]) = wr[i];
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (ktiles > 0) {
    load(k_begin);
    stash(0);
    __syncthreads();
  }
  for (int t = 0; t < ktiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ktiles) load(k_begin + (t + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(&xs[buf][kk][ty * 4 + h * (BM / 2)]);
        a[4 * h] = v.x; a[4 * h + 1] = v.y; a[4 * h + 2] = v.z; a[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(&ws[buf][kk][tx * 4 + h * (BN / 2)]);
        b[4 * h] = v.x; b[4 * h + 1] = v.y; b[4 * h + 2] = v.z; b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (t + 1 < ktiles) stash(buf ^ 1);
    __syncthreads();
  }

  // 16-byte stores along the output's rows where N allows (a row of 4 floats
  // inside the row and aligned), else one element at a time
  O* o = out + (size_t)e * M * N;
  float* wk = work != nullptr ? work + ((size_t)split * E + e) * M * N : nullptr;
  const bool vec = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * 4 + (i / 4) * (BM / 2) + i % 4;
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int gn = n0 + tx * 4 + h * (BN / 2);
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
      if (wk != nullptr) {
        if (vec && gn + 3 < N) {
          store4<float>(wk + (size_t)gm * N + gn, v);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (gn + c < N) wk[(size_t)gm * N + gn + c] = v[c];
        }
      } else if (vec && gn + 3 < N) {
        store4<O>(o + (size_t)gm * N + gn, v);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (gn + c < N) o[(size_t)gm * N + gn + c] = from_float<O>(v[c]);
      }
    }
  }
}

// The two shapes of the narrow route's tiles: "thin" for a (K, N) weight of
// N <= 8 columns (a 256 x 8 output tile, 128 threads, K tiles of 16), "wide"
// otherwise (128 x 128, 256 threads of 8 x 8, K tiles of 8). The wrapper's
// narrow_tile and narrow_splits mirror them.
constexpr int kThinMaxN = 8;

template <int BM, int BN, int BK, int TM, int TN, bool kNK, bool kTA, typename O>
int launch_narrow_tiles(const float* x, const float* w, O* out, float* work, const int* rows, int E,
                        int M, int N, int K, int splits, cudaStream_t stream) {
  const int k_chunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E * splits);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  narrow_kernel<BM, BN, BK, TM, TN, kNK, kTA, O><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      x, w, out, splits > 1 ? work : nullptr, rows, E, M, N, K, splits, k_chunk);
  if (splits > 1) {
    const int mn = E * M * N;
    split_reduce_kernel<O><<<(mn + kThreads - 1) / kThreads, kThreads, 0, stream>>>(work, out, mn, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename O>
int launch_narrow(const float* x, const float* w, O* out, float* work, const int* rows, int E, int M,
                  int N, int K, int splits, int nk, int ta, cudaStream_t stream) {
  if (nk) return launch_narrow_tiles<128, 128, 8, 8, 8, true, false, O>(x, w, out, work, rows, E, M, N, K, splits, stream);
  if (N <= kThinMaxN)
    return ta ? launch_narrow_tiles<256, 8, 16, 4, 4, false, true, O>(x, w, out, work, rows, E, M, N, K, splits, stream)
              : launch_narrow_tiles<256, 8, 16, 4, 4, false, false, O>(x, w, out, work, rows, E, M, N, K, splits, stream);
  return ta ? launch_narrow_tiles<128, 128, 8, 8, 8, false, true, O>(x, w, out, work, rows, E, M, N, K, splits, stream)
            : launch_narrow_tiles<128, 128, 8, 8, 8, false, false, O>(x, w, out, work, rows, E, M, N, K, splits, stream);
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
// innermost first, boxes 64 x 128 x 1; tw: w as (N, K, E) innermost first,
// boxes 64 x 64 x 1 (MN-major B), or with kNK w as (K, N, E), boxes 64 x
// kWgmmaBN x 1 (K-major B). The forward's products (x as (K', M') is
// wgmma_km_kernel's).
template <typename O, bool kNK>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
             O* __restrict__ out, const int* __restrict__ rows, int M, int N, int K) {
  const int m0 = blockIdx.x * kWgmmaBM;
  const int n0 = blockIdx.y * kWgmmaBN;
  const int e = blockIdx.z;
  const int me = expert_rows(rows, e, M);
  out += (size_t)e * M * N;
  if (m0 >= me) {  // a tile past the expert's filled rows: zeros, no loads
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

  const int ktiles = (K + kWgmmaBK - 1) / kWgmmaBK;
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
        hopper::tma_load_3d(a_s + s * kABytes, &tx, &full[s], kt * kWgmmaBK, m0, e);
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
      const uint32_t a_addr = hopper::smem_u32(a_s + s * kABytes) + c * 64 * 128;
      const uint32_t b_addr = hopper::smem_u32(b_s + s * kBBytes);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgmmaBK / 16; ++kk) {
        // x: K-major, 16 columns = 32 bytes on; w: MN-major, 16 K rows on,
        // its 64-column boxes kBoxBytes apart, or K-major like x
        if constexpr (kNK) {
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
    // rows) are stored as zeros
    const int row = m0 + c * 64 + warp * 16 + lane / 4;
    const bool live0 = row < me, live8 = row + 8 < me;
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

// x given as (K, M) (x_layout = 1, every dW): out[e] = x[e]^T @ w[e], x
// (E, K, M), w (E, K, N), out (E, M, N), the sum over the K = C slots of
// each expert, bounded by rows[e]. Designed for short sums (arctic-480b's
// capacity of 80 slots: two k-tiles against a 128 x 256 output tile of 64
// KB), where a block that loads, multiplies and stores one tile in turn
// leaves the card idle between the phases. Persistent: one block an SM
// walks the tiles (expert, column tile, row tile), row tiles fastest, block
// b taking tiles b, b + grid, ...: the blocks in flight share one expert's
// x and a few of its dY column tiles, which L2 holds. Where the sum is two
// k-tiles or fewer (cols_fastest: a tile's time is its store), column tiles
// go fastest instead, so that the blocks in flight write a few whole rows
// of dW (on an H100 faster for arctic-480b's 80-slot dW, slower for
// grok-1-314b's 1280-slot sums). The producer thread
// runs through the k-tiles of its block's tiles without stopping at a
// tile's end, so a ring of kKmStages stages (two tiles ahead at arctic's
// shape) keeps the next tiles' loads in flight during a tile's epilogue.
// The epilogue goes through shared memory and TMA stores: each consumer
// warpgroup writes its 64 rows as 64 x 128-byte chunks (swizzled like the
// operands: no bank conflicts), two buffers a warpgroup, and one thread
// issues cp.async.bulk.tensor for each chunk and waits only for the chunk
// before last to have left the buffer, so stores stream out while the next
// tile's products run. TMA clips what falls past M and N. The k-loop of
// expert e ends at ceil(rows[e] / 64) k-tiles, and in the last one the
// consumers zero the rows at or past rows[e] of both tiles in shared memory
// (fence.proxy.async, then a barrier of the two consumer warpgroups) before
// the products, so slots past the count add nothing whatever they hold; an
// expert with rows[e] = 0 loads nothing and its zeros leave by the same TMA
// stores. One block sums each output in a fixed order: no split-K, no
// atomics, the same bits on every run.
constexpr int kKmStages = kWgmmaStages;
constexpr int kKmBufs = 2;           // epilogue buffers of a consumer warpgroup
constexpr int kEpiBytes = 64 * 128;  // one 64-row chunk of the output, 128 bytes a row
constexpr int kKmSmem = 1024 + kKmStages * kStageBytes + 2 * kKmBufs * kEpiBytes + 2 * kKmStages * 8;

// Tile t of the persistent walk: expert, then row tiles within column tiles,
// or with cols_fastest column tiles within row tiles.
__device__ __forceinline__ void km_tile(int t, int tiles_m, int tiles_n, bool cols_fastest, int& e,
                                        int& m0, int& n0) {
  e = t / (tiles_n * tiles_m);
  const int r = t % (tiles_n * tiles_m);
  n0 = (cols_fastest ? r % tiles_n : r / tiles_m) * kWgmmaBN;
  m0 = (cols_fastest ? r / tiles_n : r % tiles_m) * kWgmmaBM;
}

template <typename O>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
wgmma_km_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap to, const int* __restrict__ rows, int E, int M,
                int N, int K, int cols_fastest) {
  constexpr int kChunkCols = 128 / sizeof(O);      // output columns of one epilogue chunk
  constexpr int kChunks = kWgmmaBN / kChunkCols;   // 4 (bf16) or 8 (f32) a warpgroup's tile
  const int tiles_m = (M + kWgmmaBM - 1) / kWgmmaBM, tiles_n = (N + kWgmmaBN - 1) / kWgmmaBN;
  const int tiles = E * tiles_n * tiles_m;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  uint8_t* a_s = smem_raw + pad;
  uint8_t* b_s = a_s + kKmStages * kABytes;
  uint8_t* epi = b_s + kKmStages * kBBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * kKmBufs * kEpiBytes);
  uint64_t* empty = full + kKmStages;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kKmStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;  // k-tiles issued by this block, over all its tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int e, m0, n0;
        km_tile(t, tiles_m, tiles_n, cols_fastest, e, m0, n0);
        const int ktiles = (expert_rows(rows, e, K) + kWgmmaBK - 1) / kWgmmaBK;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % kKmStages;
          if (it >= kKmStages) hopper::mbar_wait(&empty[s], ((it / kKmStages) - 1) & 1);
          hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
#pragma unroll
          for (int j = 0; j < kWgmmaBM / 64; ++j)
            hopper::tma_load_3d(a_s + s * kABytes + j * kBoxBytes, &tx, &full[s], m0 + 64 * j,
                                kt * kWgmmaBK, e);
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
    const bool leader = threadIdx.x % 128 == 0;  // issues and waits for this warpgroup's stores
    const int row = warp * 16 + lane / 4;         // and row + 8, of the warpgroup's 64
    int it = 0, chunk_no = 0;
    float acc[kWgmmaBN / 2];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int e, m0, n0;
      km_tile(t, tiles_m, tiles_n, cols_fastest, e, m0, n0);
      const int me = expert_rows(rows, e, K);
      const int ktiles = (me + kWgmmaBK - 1) / kWgmmaBK;
      // rows of the last stage at or past the filled ones (TMA zero-fills past K)
      const int tail = me < K ? me % kWgmmaBK : 0;
#pragma unroll
      for (int i = 0; i < kWgmmaBN / 2; ++i) acc[i] = 0.f;

      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % kKmStages;
        hopper::mbar_wait(&full[s], (it / kKmStages) & 1);
        if (tail != 0 && kt == ktiles - 1) {
          // Rows tail..63 of every box of both tiles (x's two, w's four) hold
          // slots past the filled ones: zero them (a whole 128-byte row each,
          // whatever the swizzle), then order the stores before the async
          // proxy's reads and wait for both consumer warpgroups.
          constexpr int kBoxes = (kABytes + kBBytes) / kBoxBytes;
          const int chunks = (kWgmmaBK - tail) * 8;  // 16-byte chunks a box
          for (int i = threadIdx.x - 128; i < kBoxes * chunks; i += 256) {
            const int box = i / chunks, rr = tail + (i % chunks) / 8, q = i % 8;
            uint8_t* base = box < kABytes / kBoxBytes ? a_s + s * kABytes + box * kBoxBytes
                                                      : b_s + s * kBBytes + (box - kABytes / kBoxBytes) * kBoxBytes;
            *reinterpret_cast<uint4*>(base + rr * 128 + q * 16) = make_uint4(0, 0, 0, 0);
          }
          hopper::fence_proxy_async();
          hopper::named_barrier(1, 256);
        }
        // x: MN-major, 16 K rows on in its own 64-row box; w: MN-major, 16 K
        // rows on, its 64-column boxes kBoxBytes apart
        const uint32_t a_addr = hopper::smem_u32(a_s + s * kABytes) + c * kBoxBytes;
        const uint32_t b_addr = hopper::smem_u32(b_s + s * kBBytes);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgmmaBK / 16; ++kk)
          hopper::wgmma_ss<kWgmmaBN, 1, 1>(acc, hopper::desc_sw128(a_addr + kk * 16 * 128, kBoxBytes, 1024),
                                           hopper::desc_sw128(b_addr + kk * 16 * 128, kBoxBytes, 1024), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous k-tile's products are done
        hopper::fence_regs(acc);
        if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % kKmStages]);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (ktiles > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % kKmStages]);

      // Epilogue: kChunks chunks of kChunkCols columns, in turn through the
      // warpgroup's kKmBufs buffers. Byte b of a row sits in 16-byte chunk
      // (b / 16) ^ (row % 8), the 128-byte swizzle the output's map names.
#pragma unroll
      for (int q = 0; q < kChunks; ++q, ++chunk_no) {
        uint8_t* buf = epi + (kKmBufs * c + chunk_no % kKmBufs) * kEpiBytes;
        if (leader) hopper::bulk_wait_group_read<kKmBufs - 1>();  // the buffer's last store has left it
        hopper::named_barrier(2 + c, 128);
#pragma unroll
        for (int jj = 0; jj < kChunkCols / 8; ++jj) {
          const int j = q * (kChunkCols / 8) + jj;
          const int byte = (8 * jj + 2 * (lane % 4)) * (int)sizeof(O);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rr = row + 8 * h;
            store2<O>(reinterpret_cast<O*>(buf + rr * 128 + (((byte / 16) ^ (rr % 8)) * 16) + byte % 16),
                      acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
        hopper::fence_proxy_async();
        hopper::named_barrier(2 + c, 128);
        if (leader) {
          hopper::tma_store_3d(&to, buf, n0 + q * kChunkCols, m0 + c * 64, e);
          hopper::bulk_commit_group();
        }
      }
    }
    if (leader) hopper::bulk_wait_group<0>();
  }
}

template <typename O, bool kNK>
int launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* w, O* out, const int* rows, int E,
                 int M, int N, int K, cudaStream_t stream) {
  CUtensorMap tx, tw;
  // each expert's matrix is one slice of the outermost dim, so boxes stay
  // inside it and zero-fill past its own M and K
  const cuuint64_t x_dims[3] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)E};
  const cuuint64_t x_strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)M * K * 2};
  const cuuint32_t x_box[3] = {64, (cuuint32_t)kWgmmaBM, 1};
  // (N, K) row-major: K innermost, rows of K * 2 bytes; (K, N): N innermost
  const cuuint64_t w_dims[3] = {(cuuint64_t)(kNK ? K : N), (cuuint64_t)(kNK ? N : K), (cuuint64_t)E};
  const cuuint64_t w_strides[2] = {(cuuint64_t)(kNK ? K : N) * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t w_box[3] = {64, (cuuint32_t)(kNK ? kWgmmaBN : kWgmmaBK), 1};
  int err = hopper::encode_bf16_sw128(&tx, x, 3, x_dims, x_strides, x_box);
  if (err == 0) err = hopper::encode_bf16_sw128(&tw, w, 3, w_dims, w_strides, w_box);
  static std::atomic<uint32_t> smem_set{0};
  if (err == 0) err = hopper::allow_smem(wgmma_kernel<O, kNK>, kWgmmaSmem, smem_set);
  if (err != 0) return err;
  dim3 grid((M + kWgmmaBM - 1) / kWgmmaBM, (N + kWgmmaBN - 1) / kWgmmaBN, E);
  wgmma_kernel<O, kNK><<<grid, kWgmmaThreads, kWgmmaSmem, stream>>>(tx, tw, out, rows, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename O>
int launch_wgmma_km(const __nv_bfloat16* x, const __nv_bfloat16* w, O* out, const int* rows, int E,
                    int M, int N, int K, cudaStream_t stream) {
  CUtensorMap tx, tw, to;
  // x (E, K, M), w (E, K, N), out (E, M, N), innermost first; each expert one
  // slice of the outermost dim, so boxes zero-fill (loads) or clip (stores)
  // at its own bounds
  const cuuint64_t x_dims[3] = {(cuuint64_t)M, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t x_strides[2] = {(cuuint64_t)M * 2, (cuuint64_t)M * K * 2};
  const cuuint64_t w_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t w_strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kWgmmaBK, 1};
  const cuuint64_t o_dims[3] = {(cuuint64_t)N, (cuuint64_t)M, (cuuint64_t)E};
  const cuuint64_t o_strides[2] = {(cuuint64_t)N * sizeof(O), (cuuint64_t)M * N * sizeof(O)};
  const cuuint32_t o_box[3] = {128 / sizeof(O), 64, 1};
  int err = hopper::encode_bf16_sw128(&tx, x, 3, x_dims, x_strides, box);
  if (err == 0) err = hopper::encode_bf16_sw128(&tw, w, 3, w_dims, w_strides, box);
  if (err == 0)
    err = sizeof(O) == 2 ? hopper::encode_bf16_sw128(&to, out, 3, o_dims, o_strides, o_box)
                         : hopper::encode_f32_sw128(&to, out, 3, o_dims, o_strides, o_box);
  static std::atomic<uint32_t> smem_set{0};
  if (err == 0) err = hopper::allow_smem(wgmma_km_kernel<O>, kKmSmem, smem_set);
  int dev = 0, sms = 0;
  if (err == 0) err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err != 0) return err;
  const long long tiles = (long long)E * ((M + kWgmmaBM - 1) / kWgmmaBM) * ((N + kWgmmaBN - 1) / kWgmmaBN);
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (int)(tiles < sms ? tiles : sms);
  wgmma_km_kernel<O><<<grid, kWgmmaThreads, kKmSmem, stream>>>(tx, tw, to, rows, E, M, N, K,
                                                                 K <= 2 * kWgmmaBK);
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

// The gemv of (K, N) weights: the streaming kernel where 16-byte loads walk
// w's rows (N a multiple of 16 bytes, w 16-byte aligned: every expert's
// slice then is too), as one launch whose K splits form a cluster; the
// scalar kernel otherwise, one block a 256-column slab, K whole, every
// expert on grid z.
template <typename T, typename O, int MM>
int launch_gemv(const T* x, const T* w, O* out, const int* rows, int E, int M, int N, int K,
                int splits, int slots, cudaStream_t stream) {
  const bool vec_ok = (N % (16 / sizeof(T)) == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  if (!vec_ok) {
    gemv_kernel<T, O, MM><<<dim3((N + kGemvCols - 1) / kGemvCols, 1, E), kThreads, 0, stream>>>(
        x, w, out, rows, M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  const int cols = kGemvRowBytes / static_cast<int>(sizeof(T));
  const int k_chunk = (K + splits - 1) / splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + cols - 1) / cols, splits, slots);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = splits;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, gemv_stream_kernel<T, O, MM>, x, w, out, rows, E, M, N, K, k_chunk));
}

enum Route { kRouteGemv = 0, kRouteSimt = 1, kRouteWgmma = 2, kRouteNarrow = 3 };

template <typename T, typename O>
int run(const void* x_, const void* w_, void* out_, void* work, const int* rows, int E, int M,
        int N, int K, int route, int splits, int slots, int nk, int ta, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  O* out = static_cast<O*>(out_);
  float* ws = static_cast<float*>(work);
  if (route == kRouteWgmma) {
    if constexpr (sizeof(T) == 2) {
      if (ta) return launch_wgmma_km<O>(x, w, out, rows, E, M, N, K, stream);
      return nk ? launch_wgmma<O, true>(x, w, out, rows, E, M, N, K, stream)
                : launch_wgmma<O, false>(x, w, out, rows, E, M, N, K, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == kRouteNarrow) {
    if constexpr (sizeof(T) == 4) return launch_narrow<O>(x, w, out, ws, rows, E, M, N, K, splits, nk, ta, stream);
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
    return launch_gemv<T, O, 1>(x, w, out, rows, E, M, N, K, splits, slots, stream);
  } else if (M <= 2) {
    return launch_gemv<T, O, 2>(x, w, out, rows, E, M, N, K, splits, slots, stream);
  } else if (M <= 4) {
    return launch_gemv<T, O, 4>(x, w, out, rows, E, M, N, K, splits, slots, stream);
  } else {
    return launch_gemv<T, O, kGemvMaxM>(x, w, out, rows, E, M, N, K, splits, slots, stream);
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
// x_layout 0; for (K, N) weights K cut into `splits` of 1, 2, 4 or 8 chunks,
// the blocks of a cluster, and the experts walked by `slots` in [1, E]
// blocks along grid z, no workspace; for (N, K) weights splits = 1), 1 =
// simt tiles, 2 = wgmma (bfloat16 in, M >
// 8, K a multiple of 8 with x_layout 0, N with (K, N) weights, M with
// x_layout 1; x and w 16-byte aligned, and out too with x_layout 1), 3 = narrow
// (float32 in, M > 8, every operand's contiguous rows a multiple of 16
// bytes: K with x_layout 0 or w_layout 1, N with w_layout 0, M with
// x_layout 1; x and w 16-byte aligned; K cut into `splits` >= 1 chunks, E *
// splits <= 65535, with a float32 workspace of splits * E * M * N when
// splits > 1); `slots` is read by the gemv route of (K, N) weights only.
// Anything else is refused. Returns cudaGetLastError() after the launches.
extern "C" int stream_matmul(const void* x, const void* w, void* out, void* work,
                             const int* rows, int E, int M, int N, int K, int route, int splits,
                             int slots, int in_dtype, int out_dtype, int w_layout, int x_layout,
                             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || E <= 0 || E > 65535 || w_layout < 0 || w_layout > 1 ||
      x_layout < 0 || x_layout > 1 || (x_layout == 1 && (w_layout != 0 || route == kRouteGemv)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteGemv && (splits < 1 || M > kGemvMaxM || (w_layout == 1 && splits != 1) ||
                              (w_layout == 0 && (splits > kGemvMaxSplits || (splits & (splits - 1)) ||
                                                 slots < 1 || slots > E))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWgmma &&
      (in_dtype != 1 || M <= kGemvMaxM || (x_layout == 0 && K % 8) || (w_layout == 0 && N % 8) ||
       (x_layout == 1 && M % 8) || reinterpret_cast<uintptr_t>(x) % 16 ||
       reinterpret_cast<uintptr_t>(w) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWgmma && x_layout == 1 && reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteNarrow &&
      (in_dtype != 0 || M <= kGemvMaxM || splits < 1 || (splits > 1 && work == nullptr) ||
       ((x_layout == 0 || w_layout == 1) && K % 4) || (w_layout == 0 && N % 4) ||
       (x_layout == 1 && M % 4) || reinterpret_cast<uintptr_t>(x) % 16 ||
       reinterpret_cast<uintptr_t>(w) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route < kRouteGemv || route > kRouteNarrow) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nk = w_layout, ta = x_layout;
  if (in_dtype == 1 && out_dtype == 1)
    return run<__nv_bfloat16, __nv_bfloat16>(x, w, out, work, rows, E, M, N, K, route, splits, slots, nk, ta, s);
  if (in_dtype == 1 && out_dtype == 0)
    return run<__nv_bfloat16, float>(x, w, out, work, rows, E, M, N, K, route, splits, slots, nk, ta, s);
  if (in_dtype == 0 && out_dtype == 1)
    return run<float, __nv_bfloat16>(x, w, out, work, rows, E, M, N, K, route, splits, slots, nk, ta, s);
  if (in_dtype == 0 && out_dtype == 0)
    return run<float, float>(x, w, out, work, rows, E, M, N, K, route, splits, slots, nk, ta, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
