// The wgmma route of flash attention, shared by the forward
// (flash_attention.cu) and the backward (flash_attention_bwd.cu, which runs
// the forward to rebuild the row statistics when the caller has none, and
// walks the same work items and K/V ring in its dQ kernel).
//
// Rows: row r of a (batch, kv head) is query position r / g and query head
// kvh * g + r % g, g = H / Hkv. A work item is 128 rows of one (batch, kv
// head), two consumer warpgroups of 64; one producer thread streams the K
// and V tiles (64 positions) the item must visit through a 3-stage ring with
// TMA: a 4-D tensor map over (D, Hkv, Skv, B), 64-element boxes, 128-byte
// swizzle, zero fill past Skv. Blocks are persistent and walk the items
// heaviest first.
//
// Row statistics (the one convention of both routes' kernels that exchange
// them): lse2 = m2 + log2(l) of each row, in log2 units of the scaled
// scores: m2 is the row's largest score * scale * log2(e) over the keys it
// sees, l = sum_t 2^(s_t * scale * log2(e) - m2), so that
// softmax = 2^(s * scale * log2(e) - lse2) and lse2 = log2(e) * logsumexp(s *
// scale). f32, laid out (B, H, Sq) (batch, query head, query position).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

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

// 16-byte pieces of one warpgroup's 64 rows [r0, r0 + 64) of a (B, S, H, D)
// bf16 tensor, folded; thread tid takes pieces tid + 128u; rows at or past
// n_rows are 0. Fetched into registers first, so that every load is in
// flight before the first store (fa_store_rows).
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

// The producer thread of a block that walks fa_item's items: every K and V
// tile of every item, in order, into the ring at kv_s (stage s: K tile, then
// V tile). The ring runs on across items, so the next item's first tiles
// load while the consumers finish the current one.
template <int D>
__device__ __forceinline__ void fa_produce_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                              uint8_t* kv_s, uint64_t* full, uint64_t* empty,
                                              int n_items, int B, int Hkv, int g, int n_rows,
                                              int Skv, int causal, int window) {
  using L = FaLayout<D>;
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
        hopper::tma_load_4d(k_s + j * kKVBoxBytes, tk, &full[s], 64 * j, w.kvh, t0, w.b);
        hopper::tma_load_4d(k_s + L::kKBytes + j * kKVBoxBytes, tv, &full[s], 64 * j, w.kvh, t0,
                            w.b);
      }
    }
  }
}

// Persistent: grid = min(items, SMs); each block walks its items in rounds.
// lse: null, or (B, H, Sq) f32 that receives each row's statistics.
template <int D>
__global__ void __launch_bounds__(kFaThreads, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int B, int Sq, int Skv, int H, int Hkv, float scale,
                int causal, int window) {
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
  const float scale2 = scale * kLog2e;
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
    if (threadIdx.x == 0)
      fa_produce_kv<D>(&tk, &tv, kv_s, full, empty, n_items, B, Hkv, g, n_rows, Skv, causal, window);
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
        if (lse != nullptr && lane % 4 == 0)
          lse[((size_t)w.b * H + h) * Sq + pos[rr]] = m_run[rr] + log2f(l_run[rr]);
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

// One launch of the forward's wgmma kernel; lse may be null.
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
                 int Skv, int H, int Hkv, float scale, int causal, int window, int sms,
                 cudaStream_t stream) {
  using L = FaLayout<D>;
  CUtensorMap tk, tv;
  int err = encode_kv_maps<D>(&tk, &tv, k, v, B, Skv, Hkv);
  static std::atomic<uint32_t> smem_set{0};
  if (err == 0) err = hopper::allow_smem(fa_wgmma_kernel<D>, L::kSmem, smem_set);
  if (err != 0) return err;
  const int items = B * Hkv * ((Sq * (H / Hkv) + kFaRows - 1) / kFaRows);
  fa_wgmma_kernel<D><<<min(items, sms), kFaThreads, L::kSmem, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), lse, B, Sq,
      Skv, H, Hkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa
}  // namespace
