// The wgmma route of flash attention, shared by the forward
// (flash_attention.cu) and the backward (flash_attention_bwd.cu, which runs
// the forward to rebuild the row statistics when the caller has none, and
// walks the same work items and K/V ring in its dQ kernel).
//
// Rows: row r of a (batch, kv head) is query position r / g and query head
// kvh * g + r % g, g = H / Hkv. A work item is 128 rows of one (batch, kv
// head), two consumer warpgroups of 64; one producer thread streams the K
// and V tiles (64 positions) the item must visit through a ring with TMA: a
// 4-D tensor map over (D, Hkv, Skv, B), 64-element boxes, 128-byte swizzle,
// zero fill past Skv and past D. Blocks are persistent and walk the items
// heaviest first.
//
// Head dims 64, 80, 128 and 256 (FaLayout). D = 80 takes two 64-wide boxes,
// of which TMA fills head dims 80..127 with zeros; the products read only
// the first 80 (QK^T runs 5 k16 steps, PV is an N = 80 wgmma), so those
// columns, and the same columns of Q's second box, are never read. D = 256
// takes four boxes: a K/V stage is 64 KiB, so the ring has 2 stages (Q 64
// KiB + 2 x 64 KiB fits the 227 KB a block may have; 3 would not).
//
// Row statistics (the one convention of both routes' kernels that exchange
// them): lse2 = m2 + log2(l) of each row, in log2 units of the scaled
// scores: m2 is the row's largest score * scale * log2(e) over the keys it
// sees, l = sum_t 2^(s_t * scale * log2(e) - m2), so that
// softmax = 2^(s * scale * log2(e) - lse2) and lse2 = log2(e) * logsumexp(s *
// scale). f32, laid out (B, H, Sq) (batch, query head, query position).
//
// Positions (both kernels' routes, forward and backward): with int32
// q_positions (B, Sq) and kv_positions (B, Skv) the mask is the reference
// attend's (src/repro/models/common.py): key t is visible to query s when
// kv_positions[t] >= 0, causal q_positions[s] >= kv_positions[t] and, with a
// window, q_positions[s] - kv_positions[t] < window. Each kernel has an
// instance by positions and one by index (a template parameter, kPos), whose
// code and bits are the index route's as they were. Tile skipping
// by index assumes position = index; by positions a pre-pass (fa_pos_ranges)
// gives each block of rows the hull of the tiles that hold a visible pair,
// judged on the blocks' least and greatest positions (any positions: the
// hull may hold tiles that add nothing, never leaves one out; positions that
// do not decrease along a row, as Qwen2-VL's M-RoPE layout, give the index's
// tiles). A second pre-pass (fa_pos_tiles) gives each 64-key tile its least
// and greatest position; a tile every key of which is visible to every row
// of a warp (the same test the index makes from indices) skips the
// per-element mask there (the forward and dQ kernels), the rest take it. A
// row that sees no key (possible only by positions) writes 0 and the statistic -inf, the
// reference's masked_softmax convention; the backward reads that as "no key"
// (its mask zeroes P wherever a key is hidden, so such a row adds nothing).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <climits>

#include "hopper.cuh"

// Internal linkage: both libraries compile this header, and a function-local
// static of an inline function with external linkage (launch_wgmma's mask of
// the devices whose shared-memory limit is set) would be one object across
// them, so the second library would skip setting its own kernel's limit.
namespace {
namespace fa {

constexpr float kNegInf = -1e30f;  // the reference's masked-score sentinel
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kFaRows = 128;    // folded rows a block: two consumer warpgroups of 64
constexpr int kFaCols = 64;     // KV positions a tile
constexpr int kFaThreads = 384;  // producer warpgroup + two consumers
constexpr int kKVBoxBytes = kFaCols * 128;  // 64 positions x 64 head dims, bf16

// Whether a key at position kpos is visible to a query at position qpos.
__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window) {
  return kpos >= 0 && (!causal || qpos >= kpos) && (window <= 0 || (long long)qpos - kpos < window);
}

// The pre-pass of the positions route. Axis x is cut into blocks: folded
// query rows (x_q = 1; row r at query position r / g, xrows rows a block) or
// keys (x_q = 0, xrows keys a block); axis y, the other side's positions
// (unfolded), into blocks of yblk. For each (block i of x, batch b) it
// writes to out[b * nx + i] the hull [first, last + 1) of the y blocks that
// may hold a pair the mask keeps, judged on the least and greatest position
// of each block (keys < 0 left out), or [0, 0). grid = (nx, B), 256 threads.
__global__ void __launch_bounds__(256)
fa_pos_ranges(const int* __restrict__ qp, const int* __restrict__ kp, int Sq, int Skv, int g, int x_q,
              int xrows, int yblk, int causal, int window, int2* __restrict__ out) {
  __shared__ int s_min, s_max, s_first, s_last;
  const int b = blockIdx.y, i = blockIdx.x;
  const int* xp = x_q ? qp + (size_t)b * Sq : kp + (size_t)b * Skv;
  const int* yp = x_q ? kp + (size_t)b * Skv : qp + (size_t)b * Sq;
  const int ny = x_q ? Skv : Sq;
  const int x_end = x_q ? Sq * g : Skv;
  const int r0 = i * xrows, r1 = min(x_end, r0 + xrows);
  // positions indices of the x block: [r0 / g, (r1 - 1) / g] or [r0, r1 - 1]
  const int lo = x_q ? r0 / g : r0, hi = x_q ? (r1 - 1) / g : r1 - 1;
  if (threadIdx.x == 0) {
    s_min = INT_MAX;
    s_max = INT_MIN;
    s_first = INT_MAX;
    s_last = -1;
  }
  __syncthreads();
  int mn = INT_MAX, mx = INT_MIN;
  for (int j = lo + threadIdx.x; j <= hi; j += blockDim.x) {
    const int v = xp[j];
    if (x_q || v >= 0) {
      mn = min(mn, v);
      mx = max(mx, v);
    }
  }
  atomicMin(&s_min, mn);
  atomicMax(&s_max, mx);
  __syncthreads();
  const int xmin = s_min, xmax = s_max;
  if (xmin <= xmax) {
    for (int jb = threadIdx.x; jb * yblk < ny; jb += blockDim.x) {
      int ymin = INT_MAX, ymax = INT_MIN;
      for (int j = jb * yblk; j < min(ny, (jb + 1) * yblk); ++j) {
        const int v = yp[j];
        if (!x_q || v >= 0) {
          ymin = min(ymin, v);
          ymax = max(ymax, v);
        }
      }
      if (ymin > ymax) continue;
      const long long qmin = x_q ? xmin : ymin, qmax = x_q ? xmax : ymax;
      const long long kmin = x_q ? ymin : xmin, kmax = x_q ? ymax : xmax;
      if ((!causal || qmax >= kmin) && (window <= 0 || qmin - kmax < window)) {
        atomicMin(&s_first, jb);
        atomicMax(&s_last, jb);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0)
    out[(size_t)b * gridDim.x + i] = s_first <= s_last ? make_int2(s_first, s_last + 1) : make_int2(0, 0);
}

// The least and greatest position of each tile of kFaCols keys, invalid ones
// (< 0) included: out[b * ceil(Skv / kFaCols) + i]. grid = (ceil(tiles /
// 256), B), a thread a tile.
__global__ void __launch_bounds__(256)
fa_pos_tiles(const int* __restrict__ kp, int Skv, int2* __restrict__ out) {
  const int n = (Skv + kFaCols - 1) / kFaCols;
  const int i = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (i >= n) return;
  const int* row = kp + (size_t)b * Skv;
  int mn = INT_MAX, mx = INT_MIN;
  for (int t = i * kFaCols; t < min(Skv, (i + 1) * kFaCols); ++t) {
    mn = min(mn, row[t]);
    mx = max(mx, row[t]);
  }
  out[(size_t)b * n + i] = make_int2(mn, mx);
}

inline int launch_pos_tiles(const int* kp, int B, int Skv, int2* out, cudaStream_t stream) {
  const int n = (Skv + kFaCols - 1) / kFaCols;
  fa_pos_tiles<<<dim3((n + 255) / 256, B), 256, 0, stream>>>(kp, Skv, out);
  return static_cast<int>(cudaGetLastError());
}

// By positions, whether a tile of kFaCols keys from t0 (its least and greatest
// position kt) is visible whole to every row of a warp whose query
// positions lie in [qlo, qhi]: then no element needs the mask.
__device__ __forceinline__ bool tile_visible(int2 kt, int t0, int Skv, int qlo, int qhi, int causal, int window) {
  return t0 + kFaCols <= Skv && kt.x >= 0 && (!causal || kt.y <= qlo) &&
         (window <= 0 || (long long)qhi - kt.x < window);
}

// The least and greatest of the query positions qpos[2] of the rows R0, R0 +
// 8 of each thread of a warp (rows at or past n_rows left out).
__device__ __forceinline__ int2 warp_positions(const int qpos[2], int R0, int n_rows) {
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    if (R0 + 8 * rr < n_rows) {
      lo = min(lo, qpos[rr]);
      hi = max(hi, qpos[rr]);
    }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  return make_int2(lo, hi);
}

// One launch of fa_pos_ranges over the nx = ceil(x rows / xrows) blocks of
// x; returns cudaGetLastError().
inline int launch_pos_ranges(const int* qp, const int* kp, int B, int Sq, int Skv, int g, int x_q, int xrows,
                             int yblk, int causal, int window, int2* out, cudaStream_t stream) {
  const int nx = ((x_q ? Sq * g : Skv) + xrows - 1) / xrows;
  fa_pos_ranges<<<dim3(nx, B), 256, 0, stream>>>(qp, kp, Sq, Skv, g, x_q, xrows, yblk, causal, window, out);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
struct FaLayout {
  static_assert(D == 64 || D == 80 || D == 128 || D == 256, "the wgmma route's head dims");
  static constexpr int kBoxes = (D + 63) / 64;           // 64-wide head-dim boxes
  static constexpr int kStages = D > 128 ? 2 : 3;        // K/V ring stages
  static constexpr int kQBytes = kBoxes * kFaRows * 128;
  static constexpr int kKBytes = kBoxes * kKVBoxBytes;   // one K (or V) tile
  static constexpr int kStageBytes = 2 * kKBytes;
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes + 2 * kStages * 8;
};

// One work item: kRows folded rows of one (batch, kv head), and the KV tiles
// they must visit: by index from the masks, by positions (kPos) the
// pre-pass's hull (rng, (B, row blocks) pairs of tiles). Items are
// numbered heaviest first: the causal mask gives late row blocks the most
// tiles, so item it takes row block n_row_blocks - 1 - it / (B * Hkv).
struct FaItem {
  int b, kvh, r0, t_begin, n_tiles;
};

template <int kRows, bool kPos>
__device__ __forceinline__ FaItem fa_item(int it, int B, int Hkv, int g, int n_rows, int Skv,
                                          int causal, int window, const int2* __restrict__ rng) {
  const int n_row_blocks = (n_rows + kRows - 1) / kRows;
  FaItem w;
  const int bh = it % (B * Hkv);
  w.b = bh / Hkv;
  w.kvh = bh % Hkv;
  const int rb = n_row_blocks - 1 - it / (B * Hkv);
  w.r0 = rb * kRows;
  if constexpr (kPos) {
    const int2 r = rng[w.b * n_row_blocks + rb];
    w.t_begin = r.x * kFaCols;
    w.n_tiles = r.y - r.x;
    return w;
  }
  // KV range the item must visit (Sq <= Skv: every row sees a key)
  const int s_lo = w.r0 / g;
  const int s_hi = (min(n_rows, w.r0 + kRows) - 1) / g;
  int t_end = Skv;
  w.t_begin = 0;
  if (causal) t_end = min(Skv, s_hi + 1);
  if (window > 0) w.t_begin = (max(0, s_lo - window + 1) / kFaCols) * kFaCols;
  w.n_tiles = (t_end - w.t_begin + kFaCols - 1) / kFaCols;
  return w;
}

// The item block x takes in round k: items are dealt in rounds of gridDim.x,
// every other round in reverse, so that heavy and light items pair up.
__device__ __forceinline__ int fa_item_index(int k) {
  return k * gridDim.x + ((k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// 16-byte pieces of one warpgroup's 64 rows [r0, r0 + 64) of a (B, S, H, D)
// bf16 tensor, folded; thread tid takes pieces tid + 128u; rows at or past
// n_rows are 0. Fetched into registers first, so that every load is in
// flight before the first store (fa_store_rows). At D = 80 a row is 10
// pieces: the second box gets head dims 64..79, and its columns past them
// keep whatever they held (no product reads them).
template <int D>
struct FaRows {
  static constexpr int kChunks = D / 8;
  static constexpr int kPerThread = 64 * kChunks / 128;
  uint4 v[kPerThread];
};

template <int D>
__device__ __forceinline__ void fa_fetch_rows(FaRows<D>& rows, const __nv_bfloat16* __restrict__ src,
                                              int b, int kvh, int g, int S, int H, int r0, int n_rows,
                                              int tid) {
  constexpr int kChunks = FaRows<D>::kChunks;
#pragma unroll
  for (int u = 0; u < FaRows<D>::kPerThread; ++u) {
    const int p = tid + 128 * u;
    const int r = r0 + p / kChunks;
    rows.v[u] = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) {
      const int sq = r / g, h = kvh * g + r % g;
      rows.v[u] = __ldg(reinterpret_cast<const uint4*>(src + (((size_t)b * S + sq) * H + h) * D +
                                                       (p % kChunks) * 8));
    }
  }
}

// Stores fetched rows into the swizzled layout wgmma reads: `dst` is the
// warpgroup's first row, box j (head dims 64j .. 64j + 63, 128 bytes a row)
// box_stride bytes after box j - 1.
template <int D>
__device__ __forceinline__ void fa_store_rows(uint8_t* dst, int box_stride, const FaRows<D>& rows,
                                              int tid) {
  constexpr int kChunks = FaRows<D>::kChunks;
#pragma unroll
  for (int u = 0; u < FaRows<D>::kPerThread; ++u) {
    const int p = tid + 128 * u;
    const int row = p / kChunks, ch = p % kChunks;
    *reinterpret_cast<uint4*>(dst + (ch / 8) * box_stride + row * 128 + (((ch % 8) ^ (row % 8)) * 16)) =
        rows.v[u];
  }
}

// The producer thread of a block that walks fa_item<kRows>'s items: every K
// and V tile of every item, in order, into the kStages-stage ring at kv_s
// (stage s: K tile, then V tile). The ring runs on across items, so the next
// item's first tiles load while the consumers finish the current one.
template <int D, int kRows, int kStages, bool kPos>
__device__ __forceinline__ void fa_produce_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                              uint8_t* kv_s, uint64_t* full, uint64_t* empty,
                                              int n_items, int B, int Hkv, int g, int n_rows,
                                              int Skv, int causal, int window, const int2* rng) {
  using L = FaLayout<D>;
  int gi = 0;  // tiles loaded by this block so far: the ring's position
  for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
    const int it = fa_item_index(k);
    if (it >= n_items) continue;
    const FaItem w = fa_item<kRows, kPos>(it, B, Hkv, g, n_rows, Skv, causal, window, rng);
    for (int i = 0; i < w.n_tiles; ++i, ++gi) {
      const int s = gi % kStages;
      if (gi >= kStages) hopper::mbar_wait(&empty[s], ((gi / kStages) - 1) & 1);
      hopper::mbar_arrive_expect_tx(&full[s], L::kStageBytes);
      uint8_t* k_s = kv_s + s * L::kStageBytes;
      const int t0 = w.t_begin + i * kFaCols;
#pragma unroll
      for (int j = 0; j < L::kBoxes; ++j) {
        hopper::tma_load_4d(k_s + j * kKVBoxBytes, tk, &full[s], 64 * j, w.kvh, t0, w.b);
        hopper::tma_load_4d(k_s + L::kKBytes + j * kKVBoxBytes, tv, &full[s], 64 * j, w.kvh, t0,
                            w.b);
      }
    }
  }
}

// Persistent: grid = min(items, SMs); each block walks its items in rounds.
// lse: null, or (B, H, Sq) f32 that receives each row's statistics. qp, kp,
// rng, kts: by positions (kPos) the positions and the pre-passes' tile
// ranges and tile positions; by index unread, and the code is the index's.
template <int D, bool kPos>
__global__ void __launch_bounds__(kFaThreads, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, const int* __restrict__ qp, const int* __restrict__ kp,
                const int2* __restrict__ rng, const int2* __restrict__ kts, int B, int Sq, int Skv, int H,
                int Hkv, float scale, int causal, int window) {
  using L = FaLayout<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t fa_smem[];
  const uint32_t pad = (1024 - (hopper::smem_u32(fa_smem) & 1023)) & 1023;
  uint8_t* q_s = fa_smem + pad;
  uint8_t* kv_s = q_s + L::kQBytes;  // stage s: K tile, then V tile
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + kStages * L::kStageBytes);
  uint64_t* empty = full + kStages;

  const int g = H / Hkv;
  const int n_rows = Sq * g;
  const int n_items = B * Hkv * ((n_rows + kFaRows - 1) / kFaRows);
  const float scale2 = scale * kLog2e;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      fa_produce_kv<D, kFaRows, kStages, kPos>(&tk, &tv, kv_s, full, empty, n_items, B, Hkv, g, n_rows, Skv,
                                               causal, window, rng);
  } else {
    hopper::setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const uint32_t q_addr = hopper::smem_u32(q_s) + c * 64 * 128;
    int gi = 0;  // tiles consumed by this block so far

    for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
      const int it = fa_item_index(k);
      if (it >= n_items) continue;
      const FaItem w = fa_item<kFaRows, kPos>(it, B, Hkv, g, n_rows, Skv, causal, window, rng);

      // This warpgroup's 64 Q rows (it alone reads them); the barrier first
      // lets every warp finish the previous item's products, which read them.
      FaRows<D> qv;
      fa_fetch_rows<D>(qv, q, w.b, w.kvh, g, Sq, H, w.r0 + c * 64, n_rows, tid);
      hopper::named_barrier(1 + c, 128);
      fa_store_rows<D>(q_s + c * 64 * 128, kFaRows * 128, qv, tid);
      hopper::fence_proxy_async();
      hopper::named_barrier(1 + c, 128);

      const int R0 = w.r0 + c * 64 + warp * 16 + lane / 4;  // this thread's rows: R0, R0 + 8
      const int pos[2] = {R0 / g, (R0 + 8) / g};
      const int warp_pos_lo = (w.r0 + c * 64 + warp * 16) / g;  // positions of the warp's 16 rows
      const int warp_pos_hi = (w.r0 + c * 64 + warp * 16 + 15) / g;
      int qpos[2] = {0, 0};  // by positions: the rows' query positions
      const int* krow = kp + (size_t)w.b * Skv;
      if constexpr (kPos) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          if (R0 + 8 * rr < n_rows) qpos[rr] = __ldg(qp + (size_t)w.b * Sq + pos[rr]);
      }
      const int2 wq = kPos ? warp_positions(qpos, R0, n_rows) : make_int2(0, 0);
      const int2* ktiles = kts + (size_t)w.b * ((Skv + kFaCols - 1) / kFaCols);
      float m_run[2] = {kNegInf, kNegInf};
      float l_run[2] = {0.f, 0.f};  // this thread's columns only; summed over the quad at the end
      float oacc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;

      for (int i = 0; i < w.n_tiles; ++i, ++gi) {
        const int s = gi % kStages;
        const int t0 = w.t_begin + i * kFaCols;
        hopper::mbar_wait(&full[s], (gi / kStages) & 1);
        const uint32_t k_addr = hopper::smem_u32(kv_s + s * L::kStageBytes);
        const uint32_t v_addr = k_addr + L::kKBytes;

        // S = Q K^T: K tile K-major (head dim contiguous), 64 positions wide;
        // D / 16 k-steps (5 at D = 80: the second box's first 16 head dims)
        float sacc[kFaCols / 2];
#pragma unroll
        for (int j = 0; j < kFaCols / 2; ++j) sacc[j] = 0.f;
        hopper::fence_regs(sacc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss<kFaCols, 0>(
              sacc,
              hopper::desc_sw128(q_addr + (kk / 4) * (kFaRows * 128) + (kk % 4) * 32, 16, 1024),
              hopper::desc_sw128(k_addr + (kk / 4) * kKVBoxBytes + (kk % 4) * 32, 16, 1024), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sacc);

        // Scale, masks, online softmax, in log2 units (scale2 = scale *
        // log2(e), so exp(x - m) = 2^(x2 - m2); the sentinel and -inf keep
        // their meaning). sacc[4j + e]: row R0 + 8 (e / 2), column t0 + 8j +
        // 2 (lane % 4) + e % 2. A tile that no mask reaches for any row of
        // this warp (most tiles of a causal prefill) skips the per-column
        // tests and keeps raw scores: with a positive scale their max is the
        // max of the scaled ones, and the scale rides in the exponent's FMA.
        const bool masked =
            (kPos ? !tile_visible(ktiles[t0 / kFaCols], t0, Skv, wq.x, wq.y, causal, window)
                             : t0 + kFaCols > Skv || (causal && t0 + kFaCols - 1 > warp_pos_lo) ||
                                   (window > 0 && warp_pos_hi - t0 >= window)) ||
            !(scale2 > 0.f);
        float sf = scale2;  // the factor still to apply to sacc
        if (kPos && masked) {
          sf = 1.f;
#pragma unroll
          for (int j = 0; j < kFaCols / 8; ++j) {
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int t = t0 + 8 * j + 2 * (lane % 4) + cc;
              const int kpos = t < Skv ? __ldg(krow + t) : -1;
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) {
                float val = sacc[4 * j + 2 * rr + cc] * scale2;
                if (t >= Skv) {
                  val = -INFINITY;
                } else if (!visible(qpos[rr], kpos, causal, window)) {
                  val = kNegInf;
                }
                sacc[4 * j + 2 * rr + cc] = val;
              }
            }
          }
        } else if (masked) {
          sf = 1.f;
#pragma unroll
          for (int j = 0; j < kFaCols / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = t0 + 8 * j + 2 * (lane % 4) + (e & 1);
              const int sp = pos[e >> 1];
              float val = sacc[4 * j + e] * scale2;
              if (t >= Skv) {
                val = -INFINITY;
              } else if ((causal && sp < t) || (window > 0 && sp - t >= window)) {
                val = kNegInf;
              }
              sacc[4 * j + e] = val;
            }
          }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kFaCols / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sacc[j]);
        float alpha[2], neg_m[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
          const float m_new = fmaxf(m_run[rr], mx[rr] * sf);
          alpha[rr] = hopper::exp2_approx(m_run[rr] - m_new);
          m_run[rr] = m_new;
          neg_m[rr] = -m_new;
        }
#pragma unroll
        for (int j = 0; j < kFaCols / 2; ++j) {
          const float p = hopper::exp2_approx(fmaf(sacc[j], sf, neg_m[(j >> 1) & 1]));
          sacc[j] = p;
          rowsum[(j >> 1) & 1] += p;
        }
        // P in bf16 as the A operand of PV: k-step kk covers columns 16kk ..
        // 16kk + 15, the accumulator's 8-column chunks 2kk and 2kk + 1
        uint32_t pf[kFaCols / 16][4];
#pragma unroll
        for (int kk = 0; kk < kFaCols / 16; ++kk) {
          pf[kk][0] = hopper::pack_bf16x2(sacc[8 * kk + 0], sacc[8 * kk + 1]);
          pf[kk][1] = hopper::pack_bf16x2(sacc[8 * kk + 2], sacc[8 * kk + 3]);
          pf[kk][2] = hopper::pack_bf16x2(sacc[8 * kk + 4], sacc[8 * kk + 5]);
          pf[kk][3] = hopper::pack_bf16x2(sacc[8 * kk + 6], sacc[8 * kk + 7]);
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) l_run[rr] = l_run[rr] * alpha[rr] + rowsum[rr];
#pragma unroll
        for (int j = 0; j < D / 2; ++j) oacc[j] *= alpha[(j >> 1) & 1];

        // O += P V: V tile MN-major (head dim contiguous), its 64-wide boxes
        // kKVBoxBytes apart; 16 positions = 16 rows of 128 bytes a k-step;
        // N = D (at 256 a thread's O is 128 registers)
        hopper::fence_regs(oacc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kFaCols / 16; ++kk)
          hopper::wgmma_rs<D>(oacc, pf[kk],
                              hopper::desc_sw128(v_addr + kk * 16 * 128, kKVBoxBytes, 1024), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(oacc);
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      }

#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 1);
        l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 2);
        const int r = R0 + 8 * rr;
        if (r >= n_rows) continue;
        // by positions, a row that saw no key (its max still the sentinel) writes 0 and -inf
        const bool none = kPos && m_run[rr] <= kNegInf;
        const float inv = none ? 0.f : 1.f / fmaxf(l_run[rr], 1e-30f);
        const int h = w.kvh * g + r % g;
        __nv_bfloat16* out = o + (((size_t)w.b * Sq + pos[rr]) * H + h) * D + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(out + 8 * j) =
              hopper::pack_bf16x2(oacc[4 * j + 2 * rr] * inv, oacc[4 * j + 2 * rr + 1] * inv);
        if (lse != nullptr && lane % 4 == 0)
          lse[((size_t)w.b * H + h) * Sq + pos[rr]] = none ? -INFINITY : m_run[rr] + log2f(l_run[rr]);
      }
    }
  }
}

// K and V tensor maps of the wgmma kernels: (D, Hkv, Skv, B), boxes of 64
// head dims x 64 positions. Returns 0 or a cudaError_t code.
template <int D>
int encode_kv_maps(CUtensorMap* tk, CUtensorMap* tv, const void* k, const void* v, int B, int Skv,
                   int Hkv) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2,
                                 (cuuint64_t)Skv * Hkv * D * 2};
  const cuuint32_t box[4] = {64, 1, kFaCols, 1};
  int err = hopper::encode_bf16_sw128(tk, k, 4, dims, strides, box);
  if (err == 0) err = hopper::encode_bf16_sw128(tv, v, 4, dims, strides, box);
  return err;
}

// One launch of the forward's wgmma kernel; lse may be null. By positions
// (qp, kp not null) the pre-passes first write the items' tile ranges into
// rng, B * ceil(Sq * H / Hkv / 128) pairs, and the tiles' positions into
// kts, B * ceil(Skv / 64) pairs.
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, const int* qp,
                 const int* kp, int2* rng, int2* kts, int B, int Sq, int Skv, int H, int Hkv, float scale,
                 int causal, int window, int sms, cudaStream_t stream) {
  using L = FaLayout<D>;
  CUtensorMap tk, tv;
  int err = encode_kv_maps<D>(&tk, &tv, k, v, B, Skv, Hkv);
  static std::atomic<uint32_t> smem_set{0}, smem_set_pos{0};
  const bool by_pos = qp != nullptr;
  auto kernel = by_pos ? fa_wgmma_kernel<D, true> : fa_wgmma_kernel<D, false>;
  if (err == 0) err = hopper::allow_smem(kernel, L::kSmem, by_pos ? smem_set_pos : smem_set);
  if (err == 0 && by_pos)
    err = launch_pos_ranges(qp, kp, B, Sq, Skv, H / Hkv, 1, kFaRows, kFaCols, causal, window, rng, stream);
  if (err == 0 && by_pos) err = launch_pos_tiles(kp, B, Skv, kts, stream);
  if (err != 0) return err;
  const int items = B * Hkv * ((Sq * (H / Hkv) + kFaRows - 1) / kFaRows);
  kernel<<<min(items, sms), kFaThreads, L::kSmem, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), lse, qp, kp, rng, kts, B, Sq,
      Skv, H, Hkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa
}  // namespace
