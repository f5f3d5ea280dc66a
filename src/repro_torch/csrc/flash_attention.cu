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
//  * wgmma (bf16, D = 64, 80, 128 or 256, Sq <= Skv, Sq * g >= 64): a work item is
//    128 rows of one (batch, kv head); two consumer warpgroups take 64 each.
//    Blocks are persistent, one an SM, and walk the items heaviest first
//    (the causal mask gives late rows the most tiles), so one item's set-up
//    overlaps the previous item's work. The Q tile is loaded once an item
//    with 16-byte loads into the 128-byte-swizzled layout wgmma reads. One
//    producer thread streams K and V tiles of 64 positions through a
//    ring with TMA (a 4-D tensor map over (D, Hkv, Skv, B), 64-element
//    boxes, zero fill past Skv and past D; 3 stages, 2 at D = 256, whose
//    stage is 64 KiB). S = Q K^T is a
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
//    an H100 (chip_smoke.py gates it at 1e-2). Given a statistics buffer
//    (autograd's forward, for the backward), each thread that writes a row
//    of O also writes that row's lse2 = m2 + log2(l); the convention, and
//    the route's code, which the backward shares, are in
//    flash_attention_wgmma.cuh. Without one the launch is what it was.
//  * simt (f32, the one-token live call, fewer than 64 folded rows, other
//    head dims, Sq > Skv): a block
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
// By positions (q_positions, kv_positions: the mask of the reference's
// attend, flash_attention_wgmma.cuh) both routes skip tiles by the
// pre-pass's ranges instead, mask every tile element by element, and a row
// that sees no key writes 0 (and, on the wgmma route, the statistic -inf)
// where the index keeps the uniform average above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_wgmma.cuh"

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
template <typename T, int MD, bool kPos>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, const int* __restrict__ qp, const int* __restrict__ kp,
          const int2* __restrict__ rng, int Sq, int Skv, int H, int Hkv, int D, float scale,
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
  if constexpr (kPos) {  // the pre-pass's tiles
    const int2 r = rng[blockIdx.x / Hkv * gridDim.y + blockIdx.y];
    t_begin = r.x * kCols;
    t_end = min(Skv, r.y * kCols);
  } else if (skip_ok) {
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
      const int qpos = kPos && r0 + i < n_rows ? qp[(size_t)b * Sq + s] : 0;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = tx + 16 * c;
        const int t = t0 + j;
        float val = sc[a][c];
        if (t >= Skv) {
          val = -INFINITY;
        } else if (kPos ? !fa::visible(qpos, kp[(size_t)b * Skv + t], causal, window)
                                 : (causal && s < t) || (window > 0 && s - t >= window)) {
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
    // by positions, a row that saw no key (its max still the sentinel) writes 0
    const float inv = kPos && row_m[i] <= kNegInf ? 0.f : 1.f / fmaxf(row_l[i], 1e-30f);
    T* out = o + (((size_t)b * Sq + s) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(out + d, acc[a][c] * inv);
    }
  }
}

template <typename T, int MD>
int run_md(const void* q, const void* k, const void* v, void* o, const int* qp, const int* kp, int2* rng,
           int B, int Sq, int Skv, int H, int Hkv, int D, float scale, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = smem_floats<MD>() * sizeof(float);
  static std::atomic<uint32_t> smem_set{0}, smem_set_pos{0};
  const bool by_pos = qp != nullptr;
  auto kernel = by_pos ? fa_kernel<T, MD, true> : fa_kernel<T, MD, false>;
  int err = hopper::allow_smem(kernel, static_cast<int>(smem), by_pos ? smem_set_pos : smem_set);
  const int g = H / Hkv;
  if (err == 0 && by_pos)
    err = fa::launch_pos_ranges(qp, kp, B, Sq, Skv, g, 1, kRows, kCols, causal, window, rng, stream);
  if (err != 0) return err;
  dim3 grid(B * Hkv, (Sq * g + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), qp, kp, rng, Sq, Skv, H, Hkv, D, scale, causal, window, Sq <= Skv ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, const int* qp, const int* kp, int2* rng, int B,
        int Sq, int Skv, int H, int Hkv, int D, float scale, int causal, int window, cudaStream_t stream) {
  if (D <= 128)
    return run_md<T, 128>(q, k, v, o, qp, kp, rng, B, Sq, Skv, H, Hkv, D, scale, causal, window, stream);
  return run_md<T, 256>(q, k, v, o, qp, kp, rng, B, Sq, Skv, H, Hkv, D, scale, causal, window, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and o share it). D <= 256.
// window = 0: no window. route: 0 = simt, 1 = wgmma (bfloat16, D = 64, 80,
// 128 or 256, Sq <= Skv, Sq * H / Hkv >= 64, q, k, v 16-byte aligned); anything
// else is refused. lse: null, or (wgmma route only) (B, H, Sq) f32 that
// receives each row's statistics (flash_attention_wgmma.cuh). qpos, kvpos:
// null (the index), or int32 (B, Sq) and (B, Skv) positions, with ranges
// scratch of B * (ceil(Sq * H / Hkv / 64) + ceil(Skv / 64)) int pairs for
// the pre-passes' tile ranges and, on the wgmma route, the tiles' positions
// (fa_pos_ranges, fa_pos_tiles: a launch each more). `sms`: the device's SM count, the
// wgmma route's most blocks. Returns cudaGetLastError() after the last
// launch, or the first error.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, void* lse,
                               const void* qpos, const void* kvpos, void* ranges, int B, int Sq,
                               int Skv, int H, int Hkv, int D, float scale, int causal, int window,
                               int dtype, int route, int sms, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > kMaxD ||
      window < 0 || route < 0 || route > 1 || (route == 1 && sms <= 0) ||
      (route == 0 && lse != nullptr) || ((qpos == nullptr) != (kvpos == nullptr)) ||
      (qpos != nullptr && ranges == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kvpos);
  int2* rng = static_cast<int2*>(ranges);
  // the wgmma route's tiles' positions after its items' ranges
  int2* kts = rng == nullptr ? nullptr : rng + B * ((Sq * (H / Hkv) + fa::kFaRows - 1) / fa::kFaRows);
  if (route == 1) {
    const bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(v) % 16 == 0;
    if (dtype != 1 || Sq > Skv || Sq * (H / Hkv) < 64 || !aligned)
      return static_cast<int>(cudaErrorInvalidValue);
    float* stats = static_cast<float*>(lse);
    if (D == 64)
      return fa::launch_wgmma<64>(q, k, v, o, stats, qp, kp, rng, kts, B, Sq, Skv, H, Hkv, scale, causal, window, sms, s);
    if (D == 80)
      return fa::launch_wgmma<80>(q, k, v, o, stats, qp, kp, rng, kts, B, Sq, Skv, H, Hkv, scale, causal, window, sms, s);
    if (D == 128)
      return fa::launch_wgmma<128>(q, k, v, o, stats, qp, kp, rng, kts, B, Sq, Skv, H, Hkv, scale, causal, window, sms,
                                   s);
    if (D == 256)
      return fa::launch_wgmma<256>(q, k, v, o, stats, qp, kp, rng, kts, B, Sq, Skv, H, Hkv, scale, causal, window, sms,
                                   s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, o, qp, kp, rng, B, Sq, Skv, H, Hkv, D, scale, causal, window, s);
  if (dtype == 0)
    return run<float>(q, k, v, o, qp, kp, rng, B, Sq, Skv, H, Hkv, D, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
