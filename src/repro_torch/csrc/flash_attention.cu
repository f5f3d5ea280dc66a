// Online-softmax attention for Hopper (sm_90a), causal, sliding-window or
// bidirectional, with grouped KV heads.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, flash_attention /
// _fa_kernel, a (B*Hkv, Sq/bq) Pallas grid whose body loops over KV blocks
// with a running max and denominator in f32.
//
// Bound on this card: at prefill lengths the QK^T and PV products dominate
// (4*Sq*Skv*H*D flops, halved by the causal mask), so the time is operations
// over the bf16 tensor-core rate; at the live step (Sq = Skv = 1) it is a few
// KiB of q/k/v and the launch itself.
//
// Rows: a row is one (query position, query head of the group): the g = H /
// Hkv query heads that share a KV head are folded into the rows, so K and V
// tiles are loaded once for the whole group. Scores, the running max m, the
// denominator l and the output accumulator stay in f32, so the (Sq, Skv)
// score matrix never reaches device memory. Two routes, chosen by the wrapper
// (ops.py, fa_route) from dtype and shape:
//  * wgmma (bf16, D = 64 or 128, Sq <= Skv, Sq * g >= 64): a work item is
//    128 rows of one (batch, kv head); two consumer warpgroups take 64 each.
//    Blocks are persistent, one an SM, and walk the items heaviest first
//    (the causal mask gives late rows the most tiles), so one item's set-up
//    overlaps the previous item's work. The Q tile is loaded once an item
//    with 16-byte loads into the 128-byte-swizzled layout wgmma reads. One
//    producer thread streams K and V tiles of 64 positions through a
//    3-stage ring with TMA (a 4-D tensor map over
//    (D, Hkv, Skv, B), 64-element boxes, zero fill past Skv). S = Q K^T is a
//    wgmma with both operands in shared memory; the scale, the masks and the
//    online softmax run on the f32 accumulator fragment, where a row's values
//    live in the 4 threads of a quad (2 shuffles for its max). The softmax is
//    the serial part of a tile, so it is kept short: log2 units with one
//    FMA and one ex2.approx a score, and no mask tests on tiles that no mask
//    reaches for any row of the warp (about 30% faster at prefill). P is rounded
//    to bf16 in registers and fed back as the A operand of O += P V (V
//    MN-major, the transpose bit). Rounding P to bf16 is the route's one
//    precision change against the f32 plain version: the output's relative
//    L2 error against attention_ref is 2.0-2.1e-3 at the prefill shapes on
//    an H100 (chip_smoke.py gates it at 1e-2).
//  * simt (f32, the one-token live call, other head dims, Sq > Skv): a block
//    owns 64 rows and walks KV tiles of 32 positions through shared memory in
//    plain f32 arithmetic, 16 x 16 threads. Its tiles are sized for D <= 128
//    or D <= 256 (recurrentgemma's head dim), a template argument chosen by D.
// Masking keeps the reference's finite sentinel -1e30 and max(l, 1e-30): a
// window can mask every column of a row's first tile, where -inf would give
// exp(-inf + inf) = NaN; with -1e30 the next visible score rescales that tile
// away. Columns past Skv are -inf and contribute exactly 0. When Sq <= Skv
// every row sees at least one key, so tiles that the causal or window mask
// hides from every row of the block are skipped: that changes only speed.
// Both routes are deterministic (no atomics). Any Sq and Skv; D <= 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kRows = 64;      // rows (query position x group head) per block
constexpr int kCols = 32;      // KV positions per tile
constexpr int kMaxD = 256;     // the simt route's widest head; its blocks come in 128 and 256
constexpr float kNegInf = -1e30f;  // the reference's masked-score sentinel

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Shared memory of a simt block whose head dims go up to MD: 74,880 bytes at
// MD = 128, 140,416 at MD = 256 (above 48 KB, so both opt in through
// hopper::allow_smem; one block of 256 threads an SM at 256).
template <int MD>
constexpr size_t smem_floats() {
  return kRows * MD            // q tile, pre-scaled
         + kCols * (MD + 1)    // k tile (+1 pad: threads read different rows)
         + kCols * MD          // v tile
         + kRows * (kCols + 1) // scores, then probabilities
         + 3 * kRows;          // running max, denominator, rescale factor
}

// q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D); o like q. grid = (B*Hkv, ceil(Sq*g/64)).
// MD (128 or 256) bounds D: a thread holds head dims tx + 16c, c < MD / 16. D
// <= 128 takes MD = 128, the code and the bits it always had.
template <typename T, int MD>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int Sq, int Skv, int H, int Hkv, int D, float scale,
          int causal, int window, int skip_ok) {
  constexpr int kAcc = MD / 16;  // head dims a thread accumulates
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kRows * MD;
  float* vs = ks + kCols * (MD + 1);
  float* ps = vs + kCols * MD;
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
    qs[i * MD + d] = val;
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

  float acc[4][kAcc];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[a][c] = 0.f;

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
      ks[j * (MD + 1) + d] = kv;
      vs[j * MD + d] = vv;
    }
    __syncthreads();

    // Scores: rows ty + 16a, columns tx + 16c.
    float sc[4][2] = {};
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[2];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qs[(ty + 16 * a) * MD + d];
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
      for (int c = 0; c < kAcc; ++c) acc[a][c] *= alpha;
      for (int j = 0; j < kCols; ++j) {
        const float p = ps[i * (kCols + 1) + j];
#pragma unroll
        for (int c = 0; c < kAcc; ++c) {
          const int d = tx + 16 * c;
          if (d < D) acc[a][c] = fmaf(p, vs[j * MD + d], acc[a][c]);
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
    for (int c = 0; c < kAcc; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(out + d, acc[a][c] * inv);
    }
  }
}

// ---- wgmma route ---------------------------------------------------------------

constexpr int kFaRows = 128;    // folded rows a block: two consumer warpgroups of 64
constexpr int kFaCols = 64;     // KV positions a tile
constexpr int kFaStages = 3;
constexpr int kFaThreads = 384;  // producer warpgroup + two consumers
constexpr int kKVBoxBytes = kFaCols * 128;  // 64 positions x 64 head dims, bf16

template <int D>
struct FaLayout {
  static constexpr int kBoxes = D / 64;                  // 64-wide head-dim boxes
  static constexpr int kQBytes = kBoxes * kFaRows * 128;
  static constexpr int kKBytes = kBoxes * kKVBoxBytes;   // one K (or V) tile
  static constexpr int kStageBytes = 2 * kKBytes;
  static constexpr int kSmem = 1024 + kQBytes + kFaStages * kStageBytes + 2 * kFaStages * 8;
};

// One work item: 128 folded rows of one (batch, kv head), and the KV tiles
// they must visit. Items are numbered heaviest first: the causal mask gives
// late row blocks the most tiles, so item it takes row block
// n_row_blocks - 1 - it / (B * Hkv).
struct FaItem {
  int b, kvh, r0, t_begin, n_tiles;
};

__device__ __forceinline__ FaItem fa_item(int it, int B, int Hkv, int g, int n_rows, int Skv,
                                          int causal, int window) {
  const int n_row_blocks = (n_rows + kFaRows - 1) / kFaRows;
  FaItem w;
  const int bh = it % (B * Hkv);
  w.b = bh / Hkv;
  w.kvh = bh % Hkv;
  w.r0 = (n_row_blocks - 1 - it / (B * Hkv)) * kFaRows;
  // KV range the item must visit (Sq <= Skv: every row sees a key)
  const int s_lo = w.r0 / g;
  const int s_hi = (min(n_rows, w.r0 + kFaRows) - 1) / g;
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

// Persistent: grid = min(items, SMs); each block walks its items in rounds.
// The K/V ring runs on across items, so the producer loads the next item's
// first tiles while the consumers finish the current one.
template <int D>
__global__ void __launch_bounds__(kFaThreads, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o, int B, int Sq,
                int Skv, int H, int Hkv, float scale, int causal, int window) {
  using L = FaLayout<D>;
  extern __shared__ uint8_t fa_smem[];
  const uint32_t pad = (1024 - (hopper::smem_u32(fa_smem) & 1023)) & 1023;
  uint8_t* q_s = fa_smem + pad;
  uint8_t* kv_s = q_s + L::kQBytes;  // stage s: K tile, then V tile
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + kFaStages * L::kStageBytes);
  uint64_t* empty = full + kFaStages;

  const int g = H / Hkv;
  const int n_rows = Sq * g;
  const int n_items = B * Hkv * ((n_rows + kFaRows - 1) / kFaRows);
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFaStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int gi = 0;  // tiles loaded by this block so far: the ring's position
      for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
        const int it = fa_item_index(k);
        if (it >= n_items) continue;
        const FaItem w = fa_item(it, B, Hkv, g, n_rows, Skv, causal, window);
        for (int i = 0; i < w.n_tiles; ++i, ++gi) {
          const int s = gi % kFaStages;
          if (gi >= kFaStages) hopper::mbar_wait(&empty[s], ((gi / kFaStages) - 1) & 1);
          hopper::mbar_arrive_expect_tx(&full[s], L::kStageBytes);
          uint8_t* k_s = kv_s + s * L::kStageBytes;
          const int t0 = w.t_begin + i * kFaCols;
#pragma unroll
          for (int j = 0; j < L::kBoxes; ++j) {
            hopper::tma_load_4d(k_s + j * kKVBoxBytes, &tk, &full[s], 64 * j, w.kvh, t0, w.b);
            hopper::tma_load_4d(k_s + L::kKBytes + j * kKVBoxBytes, &tv, &full[s], 64 * j, w.kvh,
                                t0, w.b);
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const uint32_t q_addr = hopper::smem_u32(q_s) + c * 64 * 128;
    int gi = 0;  // tiles consumed by this block so far

    for (int k = 0; k * (int)gridDim.x < n_items; ++k) {
      const int it = fa_item_index(k);
      if (it >= n_items) continue;
      const FaItem w = fa_item(it, B, Hkv, g, n_rows, Skv, causal, window);

      // This warpgroup's 64 Q rows (it alone reads them), 16 bytes a thread,
      // into the swizzled layout (box j holds head dims 64j .. 64j + 63, 128
      // bytes a row). All loads are issued before the first store, so they
      // are in flight together; the barrier first lets every warp finish
      // the previous item's products, which read these rows.
      constexpr int kChunks = D / 8;
      constexpr int kPerThread = 64 * kChunks / 128;
      uint4 qv[kPerThread];
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int p = tid + 128 * u;
        const int r = w.r0 + c * 64 + p / kChunks;
        qv[u] = make_uint4(0u, 0u, 0u, 0u);
        if (r < n_rows) {
          const int sq = r / g, h = w.kvh * g + r % g;
          qv[u] = __ldg(reinterpret_cast<const uint4*>(q + (((size_t)w.b * Sq + sq) * H + h) * D +
                                                       (p % kChunks) * 8));
        }
      }
      hopper::named_barrier(1 + c, 128);
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int p = tid + 128 * u;
        const int row = c * 64 + p / kChunks, ch = p % kChunks;
        *reinterpret_cast<uint4*>(q_s + (ch / 8) * (kFaRows * 128) + row * 128 +
                                  (((ch % 8) ^ (row % 8)) * 16)) = qv[u];
      }
      hopper::fence_proxy_async();
      hopper::named_barrier(1 + c, 128);

      const int R0 = w.r0 + c * 64 + warp * 16 + lane / 4;  // this thread's rows: R0, R0 + 8
      const int pos[2] = {R0 / g, (R0 + 8) / g};
      const int warp_pos_lo = (w.r0 + c * 64 + warp * 16) / g;  // positions of the warp's 16 rows
      const int warp_pos_hi = (w.r0 + c * 64 + warp * 16 + 15) / g;
      float m_run[2] = {kNegInf, kNegInf};
      float l_run[2] = {0.f, 0.f};  // this thread's columns only; summed over the quad at the end
      float oacc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;

      for (int i = 0; i < w.n_tiles; ++i, ++gi) {
        const int s = gi % kFaStages;
        const int t0 = w.t_begin + i * kFaCols;
        hopper::mbar_wait(&full[s], (gi / kFaStages) & 1);
        const uint32_t k_addr = hopper::smem_u32(kv_s + s * L::kStageBytes);
        const uint32_t v_addr = k_addr + L::kKBytes;

        // S = Q K^T: K tile K-major (head dim contiguous), 64 positions wide
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
        const bool masked = t0 + kFaCols > Skv || (causal && t0 + kFaCols - 1 > warp_pos_lo) ||
                            (window > 0 && warp_pos_hi - t0 >= window) || !(scale2 > 0.f);
        float sf = scale2;  // the factor still to apply to sacc
        if (masked) {
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
        // kKVBoxBytes apart; 16 positions = 16 rows of 128 bytes a k-step
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
        const float inv = 1.f / fmaxf(l_run[rr], 1e-30f);
        const int h = w.kvh * g + r % g;
        __nv_bfloat16* out = o + (((size_t)w.b * Sq + pos[rr]) * H + h) * D + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(out + 8 * j) =
              hopper::pack_bf16x2(oacc[4 * j + 2 * rr] * inv, oacc[4 * j + 2 * rr + 1] * inv);
      }
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
                 int H, int Hkv, float scale, int causal, int window, int sms,
                 cudaStream_t stream) {
  using L = FaLayout<D>;
  CUtensorMap tk, tv;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2,
                                 (cuuint64_t)Skv * Hkv * D * 2};
  const cuuint32_t box[4] = {64, 1, kFaCols, 1};
  int err = hopper::encode_bf16_sw128(&tk, k, 4, dims, strides, box);
  if (err == 0) err = hopper::encode_bf16_sw128(&tv, v, 4, dims, strides, box);
  static std::atomic<uint32_t> smem_set{0};
  if (err == 0) err = hopper::allow_smem(fa_wgmma_kernel<D>, L::kSmem, smem_set);
  if (err != 0) return err;
  const int items = B * Hkv * ((Sq * (H / Hkv) + kFaRows - 1) / kFaRows);
  fa_wgmma_kernel<D><<<min(items, sms), kFaThreads, L::kSmem, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), B, Sq, Skv,
      H, Hkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MD>
int run_md(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int H,
           int Hkv, int D, float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_floats<MD>() * sizeof(float);
  static std::atomic<uint32_t> smem_set{0};
  const int err = hopper::allow_smem(fa_kernel<T, MD>, static_cast<int>(smem), smem_set);
  if (err != 0) return err;
  const int g = H / Hkv;
  dim3 grid(B * Hkv, (Sq * g + kRows - 1) / kRows);
  fa_kernel<T, MD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, Hkv, D, scale, causal, window, Sq <= Skv ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int H,
        int Hkv, int D, float scale, int causal, int window, cudaStream_t stream) {
  if (D <= 128)
    return run_md<T, 128>(q, k, v, o, B, Sq, Skv, H, Hkv, D, scale, causal, window, stream);
  return run_md<T, 256>(q, k, v, o, B, Sq, Skv, H, Hkv, D, scale, causal, window, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and o share it). D <= 256.
// window = 0: no window. route: 0 = simt, 1 = wgmma (bfloat16, D = 64 or
// 128, Sq <= Skv, Sq * H / Hkv >= 64, q, k, v 16-byte aligned); anything
// else is refused. `sms`: the device's SM count, the wgmma route's most
// blocks. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int Sq, int Skv, int H, int Hkv, int D, float scale,
                               int causal, int window, int dtype, int route, int sms,
                               void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > kMaxD ||
      window < 0 || route < 0 || route > 1 || (route == 1 && sms <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(v) % 16 == 0;
    if (dtype != 1 || Sq > Skv || Sq * (H / Hkv) < 64 || !aligned)
      return static_cast<int>(cudaErrorInvalidValue);
    if (D == 64)
      return launch_wgmma<64>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal, window, sms, s);
    if (D == 128)
      return launch_wgmma<128>(q, k, v, o, B, Sq, Skv, H, Hkv, scale, causal, window, sms, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, Hkv, D, scale, causal, window, s);
  if (dtype == 0)
    return run<float>(q, k, v, o, B, Sq, Skv, H, Hkv, D, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
