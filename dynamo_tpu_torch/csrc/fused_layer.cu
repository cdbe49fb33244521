// One whole decoder layer for C = 1 decode over int8 weights, for Hopper
// (sm_90a): the counterpart of _fused_decoder_layer_impl in
// dynamo_tpu/ops/pallas/fused_layer.py (pallas_call at :809).
//
// One cooperative launch a layer. Every phase needs the previous phase's
// whole [B, .] output, so the blocks meet at a grid barrier
// (cooperative_groups::this_grid().sync()) between phases; the grid is as
// large as can be co-resident (occupancy x SMs: two blocks an SM, at most
// 128 registers a thread, so one block's product or attention steps run
// while the other waits at a __syncthreads), and a launch the card refuses
// returns its error, so nothing waits on a block that never ran.
//
//   1. attn-norm        h = bf16(x * rsqrt(mean x^2 + eps)) * w         rows
//   2. q/k/v products   int8 column tiles x K splits -> f32 partial sums tiles
//   3a. q/k/v epilogue  per (row b, KV head): the split sums in fixed order,
//                       x scale, + bias, qk-norm, RoPE -> q (f32), k_new,
//                       v_new                                           pairs
//   3b. attention       per (row, KV head, 256-key split): the G query
//                       heads over the split's share of the history keys
//                       [wlo, min(start, pcount * BS)) of the row's block
//                       table, online softmax in f32; the pair's last split
//                       to finish merges the splits in order with the
//                       current token                                   items
//   4. o-proj products                                                  tiles
//   5. o-proj sums x scale (-> post-norm) + residual -> x_out; mlp-norm rows
//   6. gate/up products                                                 tiles
//   7. act(gate) * up -> bf16 gu (SiLU or tanh-GeGLU)                   elems
//   8. down products                                                    tiles
//   9. down sums x scale (-> post-norm) + residual -> x_out             rows
//
// Rounding points are the TPU kernel's (ops/fused_layer.py has the plain
// version): products are f32 sums of bf16 x int8, times the f32 column
// scale; h, attn, h2 and gu are bf16; q/k/v stay f32 through bias, qk-norm
// and RoPE and only k_new/v_new are cast; scores are f32; the o-proj and
// down sums are added to the residual in f32. Every epilogue (qkv bias,
// qk-norm, softcap, post-norms, unit-offset norms, GeGLU, sliding window)
// is a runtime switch: a null vector pointer or a zero scalar turns it off.
// Only the head dim D is a template parameter (128 and 256 are built).
//
// Determinism: no float atomics. Each output column is summed by one block
// in a fixed order, the K splits of a product are added in split order by
// the phase that reads them, and an attention pair's key splits are merged
// in split order (integer counters only pick which block takes an item and
// which merges), so a step gives the same bits on every run.
//
// Where the time goes: the layer reads its int8 weights once (218 MB for
// Llama-3-8B), plus the live K/V of every row, and does 2 flops per weight
// and row: at B = 16 the bound is the bytes. The products run on the
// tensor cores (int8_gemv.cuh: mma.sync, the codes converted to bf16 in
// shared memory), one column tile of 64 and one K split per block at a
// time. Left for later PRs: TMA weight streaming and wgmma, tensor-core
// attention, and fewer grid barriers.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_gemv.cuh"

namespace cg = cooperative_groups;
using int8_gemv::kThreads;

// Field for field ops/cuda/fused_layer.py's _Params.
struct FusedLayerParams {
  const __nv_bfloat16 *x;               // [B, d] residual in
  const float *cos, *sin;               // [B, D] the layer's rope table
  const __nv_bfloat16 *attn_norm, *mlp_norm;
  const __nv_bfloat16 *q_norm, *k_norm;  // [D] or null
  const __nv_bfloat16 *bq, *bk, *bv;     // [H*D], [KH*D] or null
  const __nv_bfloat16 *attn_post_norm, *mlp_post_norm;  // [d] or null
  const int8_t *wq, *wk, *wv, *wo, *w_gate, *w_up, *w_down;
  const float *s_wq, *s_wk, *s_wv, *s_wo, *s_w_gate, *s_w_up, *s_w_down;
  const __nv_bfloat16 *k_pool, *v_pool;  // [NB, BS, KH, D]
  const int32_t *tables;                 // [B, P]
  const int32_t *start;                  // [B] tokens before the current one
  const int32_t *pcounts;                // [B] history pages, <= P
  __nv_bfloat16 *x_out;                  // [B, d]
  __nv_bfloat16 *k_new, *v_new;          // [B, KH, D]
  unsigned char *workspace;
  int B, d, H, KH, D, F, NB, BS, P, window, act, unit_offset;
  float eps, sm_scale, softcap;
};

namespace {

constexpr int kTileKeys = 64;  // history keys per attention step
constexpr int kSplitKeys = 4 * kTileKeys;  // history keys per attention item
constexpr int kTablePages = 1024;  // block-table entries an attention item keeps in smem
constexpr float kNegInf = -1e30f;

// Grid size, K splits of each product and the workspace layout.
struct Plan {
  int grid, smem;
  int s_qkv, s_o, s_gu, s_down;
  size_t h, attn, h2, gu, p_qkv, p_o, p_gu, p_down;
  size_t ybuf, ss_a, ss_b;  // the row phases' f32 row and slice sums of squares
  int n_split;              // attention items per (row, KV head), at most
  size_t qbuf;              // q after qk-norm and RoPE, f32
  size_t p_attn, done;      // the items' partial softmax state; finished items a
                            // pair, then the attention item queue's head
  size_t total;
};

constexpr int kSliceW = 128;  // row elements per item of the row phases

__device__ __forceinline__ float ld_bf16(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ldcg_bf16(const __nv_bfloat16* p) {
  return int8_gemv::bf16_bits(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// Norm weight as the TPU kernel reads it: Gemma stores w - 1, so the scale
// is 1 + w, added in the weight's dtype (bf16) or in f32.
__device__ __forceinline__ float norm_w_bf16(const __nv_bfloat16* w, int i, int unit) {
  const float v = ld_bf16(w + i);
  return unit ? round_bf16(v + 1.f) : v;
}
__device__ __forceinline__ float norm_w_f32(const __nv_bfloat16* w, int i, int unit) {
  const float v = ld_bf16(w + i);
  return unit ? v + 1.f : v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block, added in warp order (the same bits every run).
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// The sum of a product's K splits at (b, n): four loads issued together at
// a time, the adds in split order.
__device__ __forceinline__ float split_sum(const float* part, int S, int B, int N, int b, int n) {
  const size_t stride = size_t(B) * N;
  const float* at = part + size_t(b) * N + n;
  float s = 0.f;
  for (int i = 0; i < S; i += 4) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = i + j < S ? __ldcg(at + (i + j) * stride) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i + j < S) s += v[j];
  }
  return s;
}

// Phases 2, 4, 6, 8: up to three weight matrices side by side (q|k|v,
// gate|up) form one [K, N] product; items are (column tile, K split, row
// group), spread over the grid. Split i of row b, column n lands in
// part[(i * B + b) * N + n].
struct Product {
  const __nv_bfloat16* A;  // [B, K] bf16 activations (workspace)
  int K;
  const int8_t* w[3];
  int cols[3];  // columns of each matrix; N = their sum
  int S;
  float* part;
};

__device__ void product_phase(const Product& pr, int B, float* smem) {
  using namespace int8_gemv;
  const int N = pr.cols[0] + pr.cols[1] + pr.cols[2];
  const int tiles = N / kTileN;
  const int groups = (B + kRows - 1) / kRows;
  const int items = tiles * pr.S * groups;
  const int k_len = pr.K / pr.S;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it % tiles;
    const int split = (it / tiles) % pr.S;
    const int group = it / (tiles * pr.S);
    int n0 = tile * kTileN;
    int m = 0;
    while (n0 >= pr.cols[m]) n0 -= pr.cols[m++];
    const int row0 = group * kRows;
    float out[kOutPerThread];
    tile_sums(pr.A + size_t(row0) * pr.K, pr.K, min(kRows, B - row0), pr.w[m], pr.cols[m], n0,
              pr.cols[m], split * k_len, (split + 1) * k_len, smem, out);
#pragma unroll
    for (int i = 0; i < kOutPerThread; ++i) {
      const int b = row0 + out_row(i);
      if (b < B) pr.part[(size_t(split) * B + b) * N + tile * kTileN + out_col(i)] = out[i];
    }
  }
}

// Phase 1: h = bf16(x * rsqrt(mean x^2 + eps)) * w, one row per block.
__device__ void attn_norm_phase(const FusedLayerParams& p, __nv_bfloat16* h, float* red) {
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const __nv_bfloat16* xr = p.x + size_t(b) * p.d;
    float ss = 0.f;
    for (int n = threadIdx.x; n < p.d; n += kThreads) {
      const float v = ld_bf16(xr + n);
      ss += v * v;
    }
    const float rs = 1.f / sqrtf(block_sum(ss, red) / p.d + p.eps);
    for (int n = threadIdx.x; n < p.d; n += kThreads)
      h[size_t(b) * p.d + n] = __float2bfloat16_rn(
          round_bf16(ld_bf16(xr + n) * rs) * norm_w_bf16(p.attn_norm, n, p.unit_offset));
  }
}

// The per-head scalars (m, l, alpha, p_cur), padded so what follows them
// stays 16-byte aligned.
__host__ __device__ __forceinline__ int stat_floats(int G) { return (4 * G + 3) / 4 * 4; }

template <int D>
struct AttnSmem {
  // Tile stages: two, so that two blocks fit an SM's shared memory at D = 128.
  static constexpr int kStages = 2;
  static size_t bytes(int G) {
    const size_t epilogue = sizeof(float) * (size_t(G + 2) * D + G + 1);  // phase 3a
    const size_t attention = sizeof(float) * (2 * size_t(G) * D      // q, acc
                                              + size_t(G) * kTileKeys  // p
                                              + stat_floats(G))        // m, l, alpha, p_cur
                             + sizeof(int32_t) * kTablePages           // the row's block table
                             + kStages * 2 * sizeof(__nv_bfloat16) * kTileKeys * (D + 8);
    return epilogue > attention ? epilogue : attention;
  }
};

// 16 bytes global -> shared without registers; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Phase 3a, one item a (row, KV head) pair: the q/k/v split sums in split
// order, x scale, + bias, qk-norm, RoPE. q (f32) goes to the workspace for
// phase 3b, k_new and v_new (bf16) are outputs.
template <int D>
__device__ void qkv_epilogue_phase(const FusedLayerParams& p, const Plan& plan, float* smem) {
  const int G = p.H / p.KH;
  const int HD = p.H * D, KHD = p.KH * D;
  const int Nq = HD + 2 * KHD;
  const int half = D / 2;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* part = reinterpret_cast<const float*>(p.workspace + plan.p_qkv);
  float* qbuf = reinterpret_cast<float*>(p.workspace + plan.qbuf);
  float* raw = smem;                  // (G + 2) x D
  float* rstat = raw + (G + 2) * D;   // G + 1
  const size_t stride = size_t(p.B) * Nq;
  for (int pair = blockIdx.x; pair < p.B * p.KH; pair += gridDim.x) {
    const int b = pair / p.KH;
    const int kh = pair % p.KH;
    __syncthreads();  // smem of the previous pair is no longer read
    // q heads kh*G .. kh*G + G - 1, then k and v head kh; four elements a
    // thread at a time, all their split loads in flight together.
    for (int e0 = tid; e0 < (G + 2) * D; e0 += 4 * kThreads) {
      int col[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = e0 + j * kThreads;
        const int hh = e / D, dd = e % D;
        col[j] = e >= (G + 2) * D ? -1
                 : hh < G         ? (kh * G + hh) * D + dd
                 : hh == G        ? HD + kh * D + dd
                                  : HD + KHD + kh * D + dd;
      }
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i0 = 0; i0 < plan.s_qkv; i0 += 4) {
        float t[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            t[i][j] = i0 + i < plan.s_qkv && col[j] >= 0
                          ? __ldcg(part + (i0 + i) * stride + size_t(b) * Nq + col[j])
                          : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (i0 + i < plan.s_qkv) v[j] += t[i][j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col[j];
        if (c < 0) continue;
        float y;
        if (c < HD) {
          y = v[j] * p.s_wq[c];
          if (p.bq) y += ld_bf16(p.bq + c);
        } else if (c < HD + KHD) {
          y = v[j] * p.s_wk[c - HD];
          if (p.bk) y += ld_bf16(p.bk + c - HD);
        } else {
          y = v[j] * p.s_wv[c - HD - KHD];
          if (p.bv) y += ld_bf16(p.bv + c - HD - KHD);
        }
        raw[e0 + j * kThreads] = y;
      }
    }
    __syncthreads();
    // qk-norm: per-head 1/rms over D, before RoPE (q heads and the k head).
    if (p.q_norm) {
      for (int hh = warp; hh < G + 1; hh += kThreads / 32) {
        float ss = 0.f;
        for (int dd = lane; dd < D; dd += 32) ss += raw[hh * D + dd] * raw[hh * D + dd];
        ss = warp_sum(ss);
        if (lane == 0) rstat[hh] = 1.f / sqrtf(ss / D + p.eps);
      }
      __syncthreads();
    }
    const float* cos_r = p.cos + size_t(b) * D;
    const float* sin_r = p.sin + size_t(b) * D;
    for (int e = tid; e < (G + 1) * D; e += kThreads) {
      const int hh = e / D, dd = e % D;
      const int pd = dd < half ? dd + half : dd - half;
      float y = raw[hh * D + dd];
      float yp = raw[hh * D + pd];
      if (p.q_norm) {
        const __nv_bfloat16* w = hh < G ? p.q_norm : p.k_norm;
        y *= rstat[hh] * norm_w_f32(w, dd, p.unit_offset);
        yp *= rstat[hh] * norm_w_f32(w, pd, p.unit_offset);
      }
      const float rot = dd < half ? -yp : yp;
      const float out = y * cos_r[dd] + rot * sin_r[dd];
      if (hh < G)
        qbuf[size_t(pair) * G * D + e] = out;
      else
        p.k_new[size_t(pair) * D + dd] = __float2bfloat16_rn(out);
    }
    for (int dd = tid; dd < D; dd += kThreads)
      p.v_new[size_t(pair) * D + dd] = __float2bfloat16_rn(raw[(G + 1) * D + dd]);
  }
}

// Phase 3b, one item a (256-key split, row, KV head): the pair's G query
// heads over the split's share of the row's history keys, online softmax
// in f32; the pair's last split to finish merges the splits in split order
// with the current token and writes attn.
template <int D>
__device__ void attention_phase(const FusedLayerParams& p, const Plan& plan, float* smem) {
  constexpr int kStride = D + 8;  // padded K/V rows: conflict-free 16-byte reads
  constexpr int kVecs = kTileKeys * D / 8;
  constexpr int kLoads = (kVecs + kThreads - 1) / kThreads;
  constexpr int kStages = AttnSmem<D>::kStages;
  const int G = p.H / p.KH;
  const int HD = p.H * D;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* qbuf = reinterpret_cast<const float*>(p.workspace + plan.qbuf);
  __nv_bfloat16* attn = reinterpret_cast<__nv_bfloat16*>(p.workspace + plan.attn);
  float* p_attn = reinterpret_cast<float*>(p.workspace + plan.p_attn);
  int* done = reinterpret_cast<int*>(p.workspace + plan.done);

  float* qs = smem;                     // G x D
  float* acc = qs + G * D;              // G x D
  float* ps = acc + G * D;              // G x kTileKeys (the merge: split weights)
  float* m_s = ps + G * kTileKeys;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  float* pc_s = a_s + G;
  int32_t* tab = reinterpret_cast<int32_t*>(m_s + stat_floats(G));
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(tab + kTablePages);  // kStages x (K, V)
  int* queue = done + p.B * p.KH;
  __shared__ int last, next;

  const int pairs = p.B * p.KH;
  const int state = G * (D + 2);  // a split's m, l (G each) and acc (G x D)
  // Items are split-major (the first splits of every pair come first) and
  // handed out from a queue: their cost follows the rows' lengths.
  for (;;) {
    __syncthreads();  // every thread has read the previous `next`
    if (tid == 0) next = atomicAdd(queue, 1);
    __syncthreads();
    const int item = next;
    if (item >= plan.n_split * pairs) break;
    const int pair = item % pairs;
    const int split = item / pairs;
    const int b = pair / p.KH;
    const int kh = pair % p.KH;
    // History keys [wlo, kend): below the row's start and its page count,
    // at or past the window's first visible key; this item takes keys
    // [lo, hi) of them.
    const int start = p.start[b];
    const int kend = min(start, p.pcounts[b] * p.BS);
    const int wlo = p.window > 0 ? max(start - p.window + 1, 0) : 0;
    const int n_split = max(1, (max(kend - wlo, 0) + kSplitKeys - 1) / kSplitKeys);
    if (split >= n_split) continue;
    const int lo = wlo + split * kSplitKeys;
    const int hi = min(kend, lo + kSplitKeys);
    __syncthreads();  // smem of the previous item is no longer read
    for (int o = tid; o < G * D; o += kThreads) {
      qs[o] = __ldcg(qbuf + size_t(pair) * G * D + o);
      acc[o] = 0.f;
    }
    for (int g = tid; g < G; g += kThreads) {
      m_s[g] = kNegInf;
      l_s[g] = 0.f;
    }
    // The row's block table, clamped to the pool, in smem (pages past the
    // cache are read from the table itself).
    const int32_t* table = p.tables + size_t(b) * p.P;
    for (int i = tid; i < min(p.P, kTablePages); i += kThreads)
      tab[i] = min(max(table[i], 0), p.NB - 1);
    __syncthreads();

    // Tile i of the item's keys goes to stage i % kStages; tiles i + 1 ..
    // i + kStages - 1 are in flight while tile i is used. Keys at or past
    // hi are zero-filled (and weigh 0 below).
    const int n_tiles = lo < hi ? (hi - lo + kTileKeys - 1) / kTileKeys : 0;
    auto issue = [&](int i) {
      if (i < n_tiles) {
        __nv_bfloat16* kst = ks + (i % kStages) * 2 * kTileKeys * kStride;
        __nv_bfloat16* vst = kst + kTileKeys * kStride;
#pragma unroll
        for (int l = 0; l < kLoads; ++l) {
          const int vec = tid + l * kThreads;
          const int t = lo + i * kTileKeys + vec / (D / 8);
          if (vec < kVecs) {
            const bool live = t < hi;
            const int page = t / p.BS;
            const int blk = !live ? 0
                            : page < kTablePages ? tab[page]
                                                 : min(max(table[page], 0), p.NB - 1);
            const size_t off =
                ((size_t(blk) * p.BS + (live ? t % p.BS : 0)) * p.KH + kh) * D + (vec % (D / 8)) * 8;
            const int so = (vec / (D / 8)) * kStride + (vec % (D / 8)) * 8;
            cp_async16(kst + so, p.k_pool + off, live);
            cp_async16(vst + so, p.v_pool + off, live);
          }
        }
      }
      cp_async_commit();  // one group a tile, empty past the end: counts stay uniform
    };
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) issue(i);
    for (int it = 0; it < n_tiles; ++it) {
      const int t0 = lo + it * kTileKeys;
      issue(it + kStages - 1);  // into the stage tile it - 1 used (done: barrier below)
      cp_async_wait<kStages - 1>();
      __syncthreads();  // every thread's copies of tile it have landed
      const __nv_bfloat16* kt = ks + (it % kStages) * 2 * kTileKeys * kStride;
      const __nv_bfloat16* vt = kt + kTileKeys * kStride;
      // scores; a warp shares g, so its q reads broadcast
      for (int si = tid; si < G * kTileKeys; si += kThreads) {
        const int g = si / kTileKeys, j = si % kTileKeys;
        const float* q = qs + g * D;
        const __nv_bfloat16* kk = kt + j * kStride;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;  // four chains: more in flight
#pragma unroll 4
        for (int dd = 0; dd < D; dd += 8) {
          const uint4 raw8 = *reinterpret_cast<const uint4*>(kk + dd);
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw8);
          const float4 qa = *reinterpret_cast<const float4*>(q + dd);
          const float4 qb = *reinterpret_cast<const float4*>(q + dd + 4);
          const float2 k0 = __bfloat1622float2(k2[0]), k1 = __bfloat1622float2(k2[1]);
          const float2 k2f = __bfloat1622float2(k2[2]), k3 = __bfloat1622float2(k2[3]);
          s0 += qa.x * k0.x + qa.y * k0.y;
          s1 += qa.z * k1.x + qa.w * k1.y;
          s2 += qb.x * k2f.x + qb.y * k2f.y;
          s3 += qb.z * k3.x + qb.w * k3.y;
        }
        float s = ((s0 + s1) + (s2 + s3)) * p.sm_scale;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        ps[si] = s;
      }
      __syncthreads();
      // online softmax, one warp per query head; invalid keys weigh 0
      for (int g = warp; g < G; g += kThreads / 32) {
        float mx = kNegInf;
        for (int j = lane; j < kTileKeys; j += 32)
          if (t0 + j < hi) mx = fmaxf(mx, ps[g * kTileKeys + j]);
        mx = warp_max(mx);
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int j = lane; j < kTileKeys; j += 32) {
          const float pj = t0 + j < hi ? expf(ps[g * kTileKeys + j] - m_new) : 0.f;
          ps[g * kTileKeys + j] = pj;
          sum += pj;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          a_s[g] = alpha;
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
      for (int o = tid; o < G * D; o += kThreads) {
        const int g = o / D, dd = o % D;
        const float* pr = ps + g * kTileKeys;
        float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;  // four chains
#pragma unroll 4
        for (int j = 0; j < kTileKeys; j += 4) {
          v0 += pr[j] * __bfloat162float(vt[j * kStride + dd]);
          v1 += pr[j + 1] * __bfloat162float(vt[(j + 1) * kStride + dd]);
          v2 += pr[j + 2] * __bfloat162float(vt[(j + 2) * kStride + dd]);
          v3 += pr[j + 3] * __bfloat162float(vt[(j + 3) * kStride + dd]);
        }
        acc[o] = acc[o] * a_s[g] + ((v0 + v1) + (v2 + v3));
      }
      __syncthreads();  // this tile's stage and ps are free
    }
    cp_async_wait<0>();
    // This item's softmax state over its keys.
    float* all = p_attn + size_t(pair) * plan.n_split * state;
    float* mine = all + size_t(split) * state;
    for (int g = tid; g < G; g += kThreads) {
      mine[g] = m_s[g];
      mine[G + g] = l_s[g];
    }
    for (int o = tid; o < G * D; o += kThreads) mine[2 * G + o] = acc[o];
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(done + pair, 1) == n_split - 1;
    __syncthreads();
    if (!last) continue;
    // The pair's last item: the splits in split order, then the current
    // token (always visible), normalised.
    __threadfence();
    const __nv_bfloat16* k_cur = p.k_new + size_t(pair) * D;
    const __nv_bfloat16* v_cur = p.v_new + size_t(pair) * D;
    for (int g = warp; g < G; g += kThreads / 32) {
      float sc = 0.f;
      for (int dd = lane; dd < D; dd += 32) sc += qs[g * D + dd] * ldcg_bf16(k_cur + dd);
      sc = warp_sum(sc) * p.sm_scale;
      if (p.softcap > 0.f) sc = p.softcap * tanhf(sc / p.softcap);
      float m = sc;
      for (int sp = lane; sp < n_split; sp += 32) m = fmaxf(m, __ldcg(all + sp * state + g));
      m = warp_max(m);
      float l = 0.f;
      for (int sp = lane; sp < n_split; sp += 32)
        l += __ldcg(all + sp * state + G + g) * expf(__ldcg(all + sp * state + g) - m);
      l = warp_sum(l);
      if (lane == 0) {
        const float pc = expf(sc - m);
        m_s[g] = m;
        pc_s[g] = pc;
        l_s[g] = l + pc;
      }
    }
    for (int o = tid; o < G * D; o += kThreads) acc[o] = 0.f;
    for (int c0 = 0; c0 < n_split; c0 += kTileKeys) {  // kTileKeys splits at a time
      const int n = min(kTileKeys, n_split - c0);
      __syncthreads();
      for (int e = tid; e < n * G; e += kThreads)
        ps[e] = expf(__ldcg(all + (c0 + e / G) * state + e % G) - m_s[e % G]);
      __syncthreads();
      for (int o = tid; o < G * D; o += kThreads) {
        const int g = o / D;
        float a = acc[o];
        for (int j = 0; j < n; ++j) a += __ldcg(all + (c0 + j) * state + 2 * G + o) * ps[j * G + g];
        acc[o] = a;
      }
    }
    for (int o = tid; o < G * D; o += kThreads) {
      const int g = o / D, dd = o % D;
      const float a = acc[o] + pc_s[g] * ldcg_bf16(v_cur + dd);
      attn[size_t(b) * HD + (kh * G + g) * D + dd] = __float2bfloat16_rn(a / fmaxf(l_s[g], 1e-30f));
    }
  }
}

// The row phases (5 and 9) run over (row, 128-wide slice) items spread
// over the grid. A row norm needs the whole row: each item writes its
// slice's sum of squares, and after a grid barrier every item adds its
// row's slice sums in slice order (one thread, handed to the block).
__device__ float row_rs(const float* ss, int nsl, int b, int d, float eps, float* bcast) {
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < nsl; ++i) s += __ldcg(ss + size_t(b) * nsl + i);
    bcast[0] = 1.f / sqrtf(s / d + eps);
  }
  __syncthreads();
  return bcast[0];
}

// Phases 5a / 9a: y = product sums x scale. With a post-norm, y goes to
// ybuf and its slice sums of squares to ss_a; without, the residual is
// added now (x_out = bf16(residual + y)) and phase 5 writes the new
// residual's slice sums of squares to ss_b for the mlp-norm.
__device__ void residual_sums(const FusedLayerParams& p, const Plan& plan, bool ffn, float* red) {
  const float* part = reinterpret_cast<const float*>(
      p.workspace + (ffn ? plan.p_down : plan.p_o));
  const int S = ffn ? plan.s_down : plan.s_o;
  const float* scale = ffn ? p.s_w_down : p.s_wo;
  const bool post = (ffn ? p.mlp_post_norm : p.attn_post_norm) != nullptr;
  float* ybuf = reinterpret_cast<float*>(p.workspace + plan.ybuf);
  float* ss = reinterpret_cast<float*>(p.workspace + (post ? plan.ss_a : plan.ss_b));
  const int nsl = p.d / kSliceW;
  for (int item = blockIdx.x; item < p.B * nsl; item += gridDim.x) {
    const int b = item / nsl;
    const size_t at = size_t(b) * p.d + (item % nsl) * kSliceW + threadIdx.x;
    float sq = 0.f;
    if (threadIdx.x < kSliceW) {
      const int n = (item % nsl) * kSliceW + threadIdx.x;
      const float y = split_sum(part, S, p.B, p.d, b, n) * scale[n];
      if (post) {
        ybuf[at] = y;
        sq = y * y;
      } else {  // residual in: x (phase 5) or phase 5's output (phase 9)
        const float xo = round_bf16((ffn ? ldcg_bf16(p.x_out + at) : ld_bf16(p.x + at)) + y);
        p.x_out[at] = __float2bfloat16_rn(xo);
        sq = xo * xo;
      }
    }
    if (post || !ffn) {
      const float tot = block_sum(sq, red);
      if (threadIdx.x == 0) ss[item] = tot;
    }
  }
}

// Phases 5b / 9b (post-norms only): x_out = bf16(residual + bf16(bf16(y *
// rsqrt) * w)); phase 5b also writes the new residual's slice sums to ss_b.
__device__ void residual_post_norm(const FusedLayerParams& p, const Plan& plan, bool ffn,
                                   float* red) {
  const __nv_bfloat16* post = ffn ? p.mlp_post_norm : p.attn_post_norm;
  const float* ybuf = reinterpret_cast<const float*>(p.workspace + plan.ybuf);
  const float* ss_a = reinterpret_cast<const float*>(p.workspace + plan.ss_a);
  float* ss_b = reinterpret_cast<float*>(p.workspace + plan.ss_b);
  const int nsl = p.d / kSliceW;
  for (int item = blockIdx.x; item < p.B * nsl; item += gridDim.x) {
    const int b = item / nsl;
    const float rs = row_rs(ss_a, nsl, b, p.d, p.eps, red + 16);
    const size_t at = size_t(b) * p.d + (item % nsl) * kSliceW + threadIdx.x;
    float sq = 0.f;
    if (threadIdx.x < kSliceW) {
      const int n = (item % nsl) * kSliceW + threadIdx.x;
      const float y = round_bf16(round_bf16(__ldcg(ybuf + at) * rs) *
                                 norm_w_bf16(post, n, p.unit_offset));
      const float xo = round_bf16((ffn ? ldcg_bf16(p.x_out + at) : ld_bf16(p.x + at)) + y);
      p.x_out[at] = __float2bfloat16_rn(xo);
      sq = xo * xo;
    }
    if (!ffn) {
      const float tot = block_sum(sq, red);
      if (threadIdx.x == 0) ss_b[item] = tot;
    }
  }
}

// Phase 5c: h2 = bf16(x_out * rsqrt(mean x_out^2 + eps)) * mlp_norm.
__device__ void mlp_norm_phase(const FusedLayerParams& p, const Plan& plan, float* red) {
  const float* ss_b = reinterpret_cast<const float*>(p.workspace + plan.ss_b);
  __nv_bfloat16* h2 = reinterpret_cast<__nv_bfloat16*>(p.workspace + plan.h2);
  const int nsl = p.d / kSliceW;
  for (int item = blockIdx.x; item < p.B * nsl; item += gridDim.x) {
    const int b = item / nsl;
    const float rs = row_rs(ss_b, nsl, b, p.d, p.eps, red + 16);
    if (threadIdx.x < kSliceW) {
      const int n = (item % nsl) * kSliceW + threadIdx.x;
      const size_t at = size_t(b) * p.d + n;
      h2[at] = __float2bfloat16_rn(round_bf16(ldcg_bf16(p.x_out + at) * rs) *
                                   norm_w_bf16(p.mlp_norm, n, p.unit_offset));
    }
  }
}

// Phase 7: gu = bf16(act(gate) * up), every (row, column) over the grid,
// four elements a thread in flight.
__device__ void act_phase(const FusedLayerParams& p, const Plan& plan) {
  const float* part = reinterpret_cast<const float*>(p.workspace + plan.p_gu);
  __nv_bfloat16* gu = reinterpret_cast<__nv_bfloat16*>(p.workspace + plan.gu);
  const int N = 2 * p.F;
  const int total = p.B * p.F;
  const int stride = gridDim.x * kThreads;
  for (int e0 = blockIdx.x * kThreads + threadIdx.x; e0 < total; e0 += 4 * stride) {
    float g[4], u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + j * stride;
      g[j] = u[j] = 0.f;
      if (e < total) {
        const int b = e / p.F, f = e % p.F;
        g[j] = split_sum(part, plan.s_gu, p.B, N, b, f);
        u[j] = split_sum(part, plan.s_gu, p.B, N, b, p.F + f);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + j * stride;
      if (e >= total) break;
      const int f = e % p.F;
      const float gs = g[j] * p.s_w_gate[f];
      const float us = u[j] * p.s_w_up[f];
      float a;
      if (p.act == 1) {  // tanh-approximated GELU (Gemma's GeGLU)
        a = 0.5f * gs * (1.f + tanhf(0.7978845608028654f * (gs + 0.044715f * gs * gs * gs)));
      } else {  // SiLU
        a = gs / (1.f + expf(-gs));
      }
      gu[e] = __float2bfloat16_rn(a * us);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) fused_layer_kernel(FusedLayerParams p, Plan plan) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  unsigned char* ws = p.workspace;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(ws + plan.h);
  float* red = smem;  // block_sum's per-warp slots and row_rs's broadcast
  const bool post = p.attn_post_norm != nullptr;
  const int HD = p.H * D, KHD = p.KH * D;

  {  // the attention items' per-pair finish counters and their queue head,
     // read after two barriers
    int* done = reinterpret_cast<int*>(ws + plan.done);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i <= p.B * p.KH; i += gridDim.x * kThreads)
      done[i] = 0;
  }
  attn_norm_phase(p, h, red);
  grid.sync();
  {
    const Product qkv{h, p.d, {p.wq, p.wk, p.wv}, {HD, KHD, KHD}, plan.s_qkv,
                      reinterpret_cast<float*>(ws + plan.p_qkv)};
    product_phase(qkv, p.B, smem);
  }
  grid.sync();
  qkv_epilogue_phase<D>(p, plan, smem);
  grid.sync();
  attention_phase<D>(p, plan, smem);
  grid.sync();
  {
    const Product o{reinterpret_cast<const __nv_bfloat16*>(ws + plan.attn), HD,
                    {p.wo, nullptr, nullptr}, {p.d, 0, 0}, plan.s_o,
                    reinterpret_cast<float*>(ws + plan.p_o)};
    product_phase(o, p.B, smem);
  }
  grid.sync();
  residual_sums(p, plan, false, red);
  grid.sync();
  if (post) {
    residual_post_norm(p, plan, false, red);
    grid.sync();
  }
  mlp_norm_phase(p, plan, red);
  grid.sync();
  {
    const Product gate_up{reinterpret_cast<const __nv_bfloat16*>(ws + plan.h2), p.d,
                          {p.w_gate, p.w_up, nullptr}, {p.F, p.F, 0}, plan.s_gu,
                          reinterpret_cast<float*>(ws + plan.p_gu)};
    product_phase(gate_up, p.B, smem);
  }
  grid.sync();
  act_phase(p, plan);
  grid.sync();
  {
    const Product down{reinterpret_cast<const __nv_bfloat16*>(ws + plan.gu), p.F,
                       {p.w_down, nullptr, nullptr}, {p.d, 0, 0}, plan.s_down,
                       reinterpret_cast<float*>(ws + plan.p_down)};
    product_phase(down, p.B, smem);
  }
  grid.sync();
  residual_sums(p, plan, true, red);
  if (post) {
    grid.sync();
    residual_post_norm(p, plan, true, red);
  }
}

template <int D>
void* kernel_for() {
  return reinterpret_cast<void*>(fused_layer_kernel<D>);
}

// K split of a product with `tiles` column tiles x row groups over `grid`
// blocks: the least time in chunk-steps, where every item also pays about
// two chunk-steps of its own (the first loads, the cross-lane sums and the
// partial sums written and read back); the smaller S on a tie.
int choose_split(int tiles, int chunks, int grid) {
  int best = 1;
  double best_cost = 1e300;
  for (int s = 1; s <= 16 && s <= chunks; ++s) {
    if (chunks % s) continue;
    const int rounds = (tiles * s + grid - 1) / grid;
    const double cost = double(rounds) * (double(chunks) / s + 2.0);
    if (cost < best_cost - 1e-9) {
      best_cost = cost;
      best = s;
    }
  }
  return best;
}

size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

cudaError_t make_plan(int B, int d, int H, int KH, int D, int F, int P, int BS, Plan* plan) {
  using int8_gemv::kChunkK;
  using int8_gemv::kRows;
  using int8_gemv::kTileN;
  if (B <= 0 || KH <= 0 || H % KH || (D != 128 && D != 256) || d % 128 || F % 128 || P <= 0 ||
      BS <= 0)
    return cudaErrorInvalidValue;
  const int G = H / KH;
  const size_t attn = D == 128 ? AttnSmem<128>::bytes(G) : AttnSmem<256>::bytes(G);
  const size_t gemv = int8_gemv::kSmemBytes;
  const size_t smem = attn > gemv ? attn : gemv;
  void* fn = D == 128 ? kernel_for<128>() : kernel_for<256>();
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
  plan->grid = per_sm * sms;
  plan->smem = int(smem);
  const int groups = (B + kRows - 1) / kRows;
  const int HD = H * D, KHD = KH * D;
  plan->s_qkv = choose_split((HD + 2 * KHD) / kTileN * groups, d / kChunkK, plan->grid);
  plan->s_o = choose_split(d / kTileN * groups, HD / kChunkK, plan->grid);
  plan->s_gu = choose_split(2 * F / kTileN * groups, d / kChunkK, plan->grid);
  plan->s_down = choose_split(d / kTileN * groups, F / kChunkK, plan->grid);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += align256(bytes);
    return at;
  };
  plan->h = take(size_t(B) * d * 2);
  plan->attn = take(size_t(B) * HD * 2);
  plan->h2 = take(size_t(B) * d * 2);
  plan->gu = take(size_t(B) * F * 2);
  plan->p_qkv = take(sizeof(float) * plan->s_qkv * B * (HD + 2 * KHD));
  plan->p_o = take(sizeof(float) * plan->s_o * B * d);
  plan->p_gu = take(sizeof(float) * plan->s_gu * B * 2 * F);
  plan->p_down = take(sizeof(float) * plan->s_down * B * d);
  plan->ybuf = take(sizeof(float) * B * d);
  plan->ss_a = take(sizeof(float) * B * (d / kSliceW));
  plan->ss_b = take(sizeof(float) * B * (d / kSliceW));
  plan->n_split = (P * BS + kSplitKeys - 1) / kSplitKeys;
  plan->qbuf = take(sizeof(float) * size_t(B) * HD);
  plan->p_attn = take(sizeof(float) * size_t(B) * KH * plan->n_split * G * (D + 2));
  plan->done = take(sizeof(int) * (size_t(B) * KH + 1));  // + the item queue's head
  plan->total = off;
  return cudaSuccess;
}

}  // namespace

// Workspace bytes the launch below needs for these shapes (-1: refused).
extern "C" long long fused_layer_workspace_bytes(int B, int d, int H, int KH, int D, int F, int P,
                                                 int BS) {
  Plan plan;
  if (make_plan(B, d, H, KH, D, F, P, BS, &plan) != cudaSuccess) return -1;
  return (long long)plan.total;
}

// Launches one layer on `stream`; returns the CUDA error (0 = launched).
extern "C" int fused_decoder_layer_bf16(FusedLayerParams p, void* stream) {
  if (p.NB <= 0 || p.BS <= 0 || p.P <= 0 || !p.x || !p.workspace) return cudaErrorInvalidValue;
  Plan plan;
  cudaError_t err = make_plan(p.B, p.d, p.H, p.KH, p.D, p.F, p.P, p.BS, &plan);
  if (err != cudaSuccess) return err;
  void* args[] = {&p, &plan};
  void* fn = p.D == 128 ? kernel_for<128>() : kernel_for<256>();
  err = cudaLaunchCooperativeKernel(fn, dim3(plan.grid), dim3(kThreads), args, size_t(plan.smem),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
