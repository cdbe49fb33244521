// One whole decoder layer for C = 1 decode over int8 weights, for Hopper
// (sm_90a): the counterpart of _fused_decoder_layer_impl in
// dynamo_tpu/ops/pallas/fused_layer.py (pallas_call at :809).
//
// One cooperative launch a layer. Every phase needs the previous phase's
// whole [B, .] output, so the blocks meet at a grid barrier
// (cooperative_groups::this_grid().sync()) between phases; the grid is as
// large as can be co-resident (occupancy x SMs: two blocks of 256 threads
// an SM, at most 128 registers a thread: four warps a scheduler; a ninth
// producer warp put five on some and cut the budget to 96, with spills), and
// a launch the card refuses returns its error, so nothing waits on a block
// that never ran.
//
//   1. attn-norm        h = bf16(x * rsqrt(mean x^2 + eps)) * w         rows
//   2. q/k/v products   128-column tiles x K splits -> f32 partial sums tiles
//   3a. q/k/v epilogue  per (row b, KV head): the split sums in fixed order,
//                       x scale, + bias, qk-norm, RoPE -> q (f32 and three
//                       bf16 terms), k_new, v_new                       pairs
//   3b. attention       per (row, KV head, 256-key split): the G query
//                       heads over the split's share of the history keys
//                       [wlo, min(start, pcount * BS)) of the row's block
//                       table, online softmax; the pair's last split to
//                       finish merges the splits in order with the current
//                       token                                           items
//   4. o-proj products; each tile's last split: x scale (-> y, or + the
//      residual -> x_out) and the 128-wide slice's sums of squares    tiles
//   5. (post-norm) x_out = residual + post-norm(y)                      rows
//      mlp-norm -> h2                                                   rows
//   6. gate/up products; each tile's last split: act(gate) * up -> gu
//      (SiLU or tanh-GeGLU)                                             tiles
//   7. down products; each tile's last split: x scale (-> y, or + the
//      residual -> x_out)                                               tiles
//   8. (post-norm) x_out = residual + post-norm(y)                      rows
//
// Seven grid barriers a layer without post-norms (a phase per step: ten),
// nine with them (twelve): the products' epilogues run in the last split
// of each tile to finish (an integer counter a tile picks it; it adds the
// splits' partial sums in split order), so the residual adds and the
// activation need no phase and no barrier of their own.
//
// Rounding points are the TPU kernel's (ops/fused_layer.py has the plain
// version): products are f32 sums of bf16 x int8, times the f32 column
// scale; h, attn, h2 and gu are bf16; q/k/v stay f32 through bias, qk-norm
// and RoPE and only k_new/v_new are cast; scores and probabilities are f32;
// the o-proj and down sums are added to the residual in f32. Every epilogue
// (qkv bias, qk-norm, softcap, post-norms, unit-offset norms, GeGLU,
// sliding window) is a runtime switch: a null vector pointer or a zero
// scalar turns it off. Only the head dim D is a template parameter (128 and
// 256 are built).
//
// Determinism: no float atomics. Each output column is summed by one block
// in a fixed order, the K splits of a product are added in split order,
// and an attention pair's key groups and key splits are merged in order
// (integer counters only pick which block takes an item and which block
// finishes a tile or a pair), so a step gives the same bits on every run.
//
// What bounds it on the card: the layer reads its int8 weights once (218 MB
// for Llama-3-8B), plus the live K/V of every row, and does 2 flops per
// weight and row: at B = 16 the bound is the bytes (3.35 TB/s). So:
//   * Products (int8_stream.cuh's core, the int8 product's design): a
//     block's 8 warps take 128-column tiles; lane 0 of warp 0 fills a ring
//     of four 20 KB stages, each one 128 x 128 chunk of codes and the
//     chunk's 16-row slice of the activations, by 2-D tensor copies (one
//     tensor map a weight, made once per weight and kept; the activations'
//     in the workspace), a stage as soon as every warp has released the one
//     four before it, running ahead into the block's next item; the codes
//     become exact bf16 fragments on the way to mma.sync. The activations were written by other blocks of this
//     launch: each thread fences its writes into the async proxy before the
//     barrier, and the producer fences again after it.
//   * Attention on the tensor cores (decode_attention_proto.cu's
//     decode_bf16 design): a warp owns 16 keys of a tile,
//     S^T[16 keys, 8] = K . Q^T with the G query
//     rows padded to 8; acc^T[D, 8] += V^T . P^T, V by ldmatrix.trans and P
//     moved from the score accumulator by movmatrix; online softmax in
//     registers. The TPU kernel keeps q and the probabilities in f32, so
//     both enter their products as three bf16 terms (hi, the rest's hi, the
//     rest of that: 24 bits of mantissa, each product three times). Two
//     terms (hi + lo, as the chunk kernel takes P) leave ~2^-17 of a value:
//     in the CPU emulation (ops/fused_layer._attention_mma) that moved ~8
//     in 4,096 attention outputs by a bf16 step, and the layer's output by
//     1.21 steps at one LAYER_CASES miniature, past the 1-step limit.
//     K and V tiles (128 keys at D 128, 64 at D 256) come by 2-D tensor
//     copies of the pool as [NB*BS, KH*D], issued by warp 0 through a ring
//     of three 32 KB slots; boxes that hold no key of the item read zeros
//     past the tensor's edge.
//
// The wrapper (ops/cuda/fused_layer.py) chooses the K splits, the attention
// item count and the copy boxes from the shapes (its plan()) and passes
// them in the parameters; fused_layer_grid gives it the co-resident grid.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_stream.cuh"

namespace cg = cooperative_groups;
using int8_stream::fence_async_shared;
using int8_stream::Frags;
using int8_stream::kCodeBytes;
using int8_stream::kstep;
using int8_stream::ldmatrix_x4;
using int8_stream::load_box;
using int8_stream::mbar_arrive_expect;
using int8_stream::mma_bf16;
using int8_stream::Ring;
using int8_stream::row_sums;
using int8_stream::smem_addr;

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
  int s_qkv, s_o, s_gu, s_down;  // K splits of the four products
  int n_split;                   // attention items a (row, KV head), at most
  int box_keys;                  // keys a box of the pools' tensor copies
  float eps, sm_scale, softcap;
};

namespace {

constexpr int kWarps = 8;                        // warps that multiply; warp 0 also issues the copies
constexpr int kThreads = 32 * kWarps;            // 256
constexpr int kRows = 16;                        // activation rows an item: the mma's M
constexpr int kTileN = int8_stream::kTileN;      // 128 output columns an item
constexpr int kChunkK = int8_stream::kChunkK;    // 128-deep chunks
constexpr int kStages = 4;                       // the products' ring
constexpr int kXSlice = kRows * kChunkK * 2;     // a chunk's 16 rows of activations
constexpr int kStageBytes = kCodeBytes + kXSlice;  // 20 KB (a multiple of 1,024)
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kScratchBytes = 2 * kRows * kTileN * 4;  // an item's sums, two matrices
constexpr int kSliceW = 128;                     // row elements per item of the row phases
constexpr int kSplitKeys = 256;                  // history keys an attention item, at most
constexpr int kSlotBytes = 32768;                // an attention slot: SK keys x D bf16
constexpr int kASlots = 3;                       // K and V of a tile, and the next K
constexpr int kMaxG = 8;                         // query rows a KV head: the mma's N
constexpr int kMaxSplitsK = 16;                  // K splits a product, at most
constexpr int kTerms = 3;                        // bf16 terms of an f32 q or probability
constexpr int kAlign = int8_stream::kAlign;
constexpr float kNegInf = -1e30f;
static_assert(kStageBytes % kAlign == 0 && kCodeBytes % kAlign == 0 && (kXSlice / 2) % kAlign == 0,
              "stages and their boxes start on the swizzle's period");
static_assert(kTileN == kSliceW, "a product tile is one slice of the row phases");

// The workspace layout and the grid.
struct Plan {
  int grid, smem;
  size_t h, attn, h2, gu, p_qkv, p_o, p_gu, p_down;
  size_t ybuf, ss_a, ss_b;  // the row phases' f32 y and slice sums of squares
  size_t qbuf;              // q after qk-norm and RoPE, f32
  size_t qterms;            // q as kTerms bf16 terms, the attention's staging layout
  size_t p_attn;            // the attention items' partial softmax state
  size_t counters;          // finished items a pair, the item queue's head, then the
                            // o, gate/up and down tiles' finished splits
  int n_counters;
  size_t total;
};

// The copy engine's views, made on the host (kept per address and shape)
// and passed as one __grid_constant__ parameter.
struct Maps {
  CUtensorMap w[7];  // wq wk wv wo w_gate w_up w_down: int8 [K, N], 128 x 128 boxes
  CUtensorMap a[4];  // h [B, d], attn [B, HD], h2 [B, d], gu [B, F]: 16 rows x 64 boxes
  CUtensorMap k, v;  // the pools as [NB*BS, KH*D]: box_keys x 64 boxes
};
enum { kWq, kWk, kWv, kWo, kWGate, kWUp, kWDown };
enum { kAH, kAAttn, kAH2, kAGu };

__device__ __forceinline__ float ld_bf16(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ldcg_bf16(const __nv_bfloat16* p) {
  return __uint_as_float(uint32_t(__ldcg(reinterpret_cast<const unsigned short*>(p))) << 16);
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

// Activations written with ordinary stores are read by the copy engine
// after the next grid barrier: order them for the async proxy.
__device__ __forceinline__ void to_async_proxy() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// -- products ---------------------------------------------------------------

// What a product's tile does once its K splits are summed: nothing (the
// q/k/v epilogue adds them), add the residual, or apply the activation.
enum Fold { kFoldNone = 0, kFoldResidual = 1, kFoldAct = 2 };

// One product phase: up to three weight matrices side by side (q|k|v) form
// one [K, N] product, or two (gate, up) are taken tile by tile together
// (mats = 2). Items are (column tile, K split, 16-row group), spread over
// the grid in that order, so the blocks at work at once stream neighbouring
// tiles at the same k rows (whole lines of the weight in DRAM; sharing the
// chunks out as equal runs across tiles lost that and ran slower). Split i
// of row b, column n of the side-by-side product lands in part[(i * B + b)
// * width + n] (gate/up: the up sums at F + n).
struct Product {
  const CUtensorMap* w[3];
  int cols[3];  // columns of each side-by-side matrix; gate/up: cols[0] = F
  int mats;
  const CUtensorMap* a;  // the activations [B, K] (workspace)
  int K, S;
  float* part;
  int width;             // a row of part
  int fold;
  bool ffn;              // kFoldResidual: the down product's (else the o product's)
  unsigned* counters;    // [groups][tiles]: finished splits (fold with S > 1)
};

// Position pos's stage: one chunk of one matrix's codes and its slice of
// the activations, three tensor copies counted on the stage's mbarrier.
__device__ __forceinline__ void issue_stage(unsigned char* stage, const CUtensorMap* w, int n0,
                                            int kc, const CUtensorMap* a, int row0,
                                            uint64_t* bar) {
  mbar_arrive_expect(bar, kCodeBytes + kXSlice);
  fence_async_shared();  // the stage was last read, or written, by threads
  load_box(stage, w, n0, kc, bar);
  load_box(stage + kCodeBytes, a, kc, row0, bar);
  load_box(stage + kCodeBytes + kXSlice / 2, a, kc + kChunkK / 2, row0, bar);
}

// The sums of a finished tile (red [mats][16 rows][128 columns], f32),
// folded into the next phase's input.
__device__ void fold_tile(const FusedLayerParams& p, const Plan& plan, const Product& pr,
                          const float* red, int tile, int row0, int n_rows) {
  const int tid = threadIdx.x;
  unsigned char* ws = p.workspace;
  if (pr.fold == kFoldAct) {
    __nv_bfloat16* gu = reinterpret_cast<__nv_bfloat16*>(ws + plan.gu);
    for (int e = tid; e < kRows * kTileN; e += kThreads) {
      const int r = e / kTileN;
      if (r >= n_rows) break;
      const int f = tile * kTileN + e % kTileN;
      const float gs = red[e] * p.s_w_gate[f];
      const float us = red[kRows * kTileN + e] * p.s_w_up[f];
      float a;  // the plain version's ops (PyTorch's gelu and sigmoid), in its order
      if (p.act == 1) {  // tanh-approximated GELU (Gemma's GeGLU)
        const float cube = gs * gs * gs;
        const float inner = 0.7978845608028654f * (gs + 0.044715f * cube);
        a = 0.5f * gs * (1.f + tanhf(inner));
      } else {  // SiLU: g * sigmoid(g)
        a = __fmul_rn(gs, 1.f / (1.f + expf(-gs)));
      }
      gu[size_t(row0 + r) * p.F + f] = __float2bfloat16_rn(__fmul_rn(a, us));
    }
    return;
  }
  // kFoldResidual: y = sums x scale. With a post-norm, y goes to ybuf and
  // its slice sum of squares to ss_a; without, the residual is added now
  // (x_out = bf16(residual + y)) and the o product writes the new
  // residual's slice sums of squares to ss_b for the mlp-norm. Thread: row
  // tid / 16, columns 8 (tid % 16) .. + 7; a row's 16 threads are half a
  // warp, their sums added by a fixed shuffle tree.
  const bool post = (pr.ffn ? p.mlp_post_norm : p.attn_post_norm) != nullptr;
  const float* scale = pr.ffn ? p.s_w_down : p.s_wo;
  float* ybuf = reinterpret_cast<float*>(ws + plan.ybuf);
  float* ss = reinterpret_cast<float*>(ws + (post ? plan.ss_a : plan.ss_b));
  const int r = tid / 16, c0 = (tid % 16) * 8;
  const int b = row0 + r;
  const int nsl = p.d / kSliceW;
  float sq = 0.f;
  if (r < n_rows) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tile * kTileN + c0 + j;
      const size_t at = size_t(b) * p.d + n;
      const float y = red[r * kTileN + c0 + j] * scale[n];
      if (post) {
        ybuf[at] = y;
        sq += y * y;
      } else {  // residual in: x (o product) or the o product's x_out (down)
        const float xo = round_bf16((pr.ffn ? ldcg_bf16(p.x_out + at) : ld_bf16(p.x + at)) + y);
        p.x_out[at] = __float2bfloat16_rn(xo);
        sq += xo * xo;
      }
    }
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if (tid % 16 == 0 && r < n_rows && (post || !pr.ffn)) ss[size_t(b) * nsl + tile] = sq;
}

// A product phase. Lane 0 of warp 0 issues the copies of the block's items
// through the ring, stage by stage: the first kStages at the start, then
// each stage as soon as all 8 warps have released the stage kStages before
// it (so it also runs ahead into the next item while the last chunks are
// multiplied). The warps (4 column quarters x 2 halves of each chunk's
// k-steps) multiply the chunks and finish each item. `pos` counts the
// ring's positions across phases.
__device__ void product_phase(const Product& pr, const FusedLayerParams& p, const Plan& plan,
                              Ring<kStages>& ring, unsigned char* smem, int& pos) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int N = pr.cols[0] + pr.cols[1] + pr.cols[2];
  const int tiles = (pr.mats == 2 ? pr.cols[0] : N) / kTileN;
  const int groups = (p.B + kRows - 1) / kRows;
  const int items = tiles * pr.S * groups;
  const int chunks = pr.K / pr.S / kChunkK;
  const int per_item = chunks * pr.mats;  // stages an item
  const int mine = items > int(blockIdx.x) ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = mine * per_item;      // this block's stages in the phase
  const int first = pos;
  // Stage j of the block's phase: item j / per_item, chunk, matrix.
  auto issue = [&](int j) {
    const int it = blockIdx.x + (j / per_item) * gridDim.x;
    const int tile = it % tiles, split = (it / tiles) % pr.S, group = it / (tiles * pr.S);
    const int c = (j % per_item) / pr.mats, mm = j % pr.mats;
    int n0 = tile * kTileN, m = 0;  // side by side: which matrix, where in it
    while (pr.mats == 1 && m < 2 && n0 >= pr.cols[m]) n0 -= pr.cols[m++];
    ring.acquire(first + j);
    issue_stage(smem + ((first + j) % kStages) * kStageBytes, pr.w[pr.mats == 2 ? mm : m], n0,
                (split * chunks + c) * kChunkK, pr.a, group * kRows, ring.bar(first + j));
  };
  if (tid == 0) {
    to_async_proxy();  // the activations were written before the barrier
    for (int j = 0; j < min(kStages, total); ++j) issue(j);
  }

  float* red = reinterpret_cast<float*>(smem + kRingBytes);  // [mats][16][128]
  __shared__ int s_last;
  const int kq = warp / 4;         // which half of a chunk's k-steps
  const int cq = (warp % 4) * 32;  // the warp's 32 columns of the tile
  const int g = lane / 4, t = lane % 4;
  const Frags f(cq, lane);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it % tiles, split = (it / tiles) % pr.S, group = it / (tiles * pr.S);
    const int row0 = group * kRows;
    const int n_rows = min(kRows, p.B - row0);
    float acc[2][1][4][4];
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mm][0][i][e] = 0.f;
    for (int c = 0; c < chunks; ++c) {
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        if (mm < pr.mats) {
          ring.wait(pos);
          const unsigned char* stage = smem + (pos % kStages) * kStageBytes;
#pragma unroll
          for (int s = 0; s < 4; ++s)
            kstep<1>(acc[mm], stage, stage + kCodeBytes, kXSlice / 2, kq * 4 + s, f);
          ring.release(pos, lane);
          if (warp == 0) {  // the stage kStages on, once every warp is done with this one
            if (lane == 0 && pos - first + kStages < total) issue(pos - first + kStages);
            __syncwarp();
          }
          ++pos;
        }
      }
    }

    // The item's sums: the second k-half's onto the first's, through red.
    __syncthreads();  // red's previous reads are done
#pragma unroll
    for (int mm = 0; mm < 2; ++mm) {
      if (mm >= pr.mats) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[8];
        row_sums<1>(acc[mm], 0, half, v);
        float4* at = reinterpret_cast<float4*>(red + (mm * kRows + g + 8 * half) * kTileN + cq +
                                               8 * t);
        if (kq == 1) {
          at[0] = make_float4(v[0], v[1], v[2], v[3]);
          at[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
    }
    __syncthreads();
    if (kq == 0) {
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        if (mm >= pr.mats) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v[8];
          row_sums<1>(acc[mm], 0, half, v);
          float4* at = reinterpret_cast<float4*>(red + (mm * kRows + g + 8 * half) * kTileN + cq +
                                                 8 * t);
          const float4 o0 = at[0], o1 = at[1];
          at[0] = make_float4(v[0] + o0.x, v[1] + o0.y, v[2] + o0.z, v[3] + o0.w);
          at[1] = make_float4(v[4] + o1.x, v[5] + o1.y, v[6] + o1.z, v[7] + o1.w);
        }
      }
    }
    __syncthreads();

    // part's column of the tile's first column, for matrix mm
    auto part_col = [&](int mm) { return pr.mats == 2 ? mm * pr.cols[0] + tile * kTileN
                                                      : tile * kTileN; };
    constexpr int kQuads = kRows * kTileN / 4;  // float4s of one matrix's sums
    if (pr.fold == kFoldNone || pr.S > 1) {  // this split's partial sums
      for (int e = tid; e < pr.mats * kQuads; e += kThreads) {
        const int mm = e / kQuads, r = (e / (kTileN / 4)) % kRows, q = e % (kTileN / 4);
        if (r < n_rows)
          *reinterpret_cast<float4*>(pr.part + (size_t(split) * p.B + row0 + r) * pr.width +
                                     part_col(mm) + 4 * q) =
              reinterpret_cast<const float4*>(red)[e];
      }
    }
    if (pr.fold == kFoldNone) continue;
    if (pr.S > 1) {  // the tile's last split adds all of them, in split order
      __threadfence();
      __syncthreads();
      if (tid == 0) s_last = atomicAdd(pr.counters + group * tiles + tile, 1u) == unsigned(pr.S - 1);
      __syncthreads();
      if (!s_last) continue;
      __threadfence();
      for (int e = tid; e < pr.mats * kQuads; e += kThreads) {
        const int mm = e / kQuads, r = (e / (kTileN / 4)) % kRows, q = e % (kTileN / 4);
        if (r >= n_rows) continue;
        // four splits' loads in flight at a time, added in split order
        const float* at = pr.part + size_t(row0 + r) * pr.width + part_col(mm) + 4 * q;
        const size_t stride = size_t(p.B) * pr.width;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int i0 = 0; i0 < pr.S; i0 += 4) {
          float4 v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (i0 + j < pr.S) v[j] = __ldcg(reinterpret_cast<const float4*>(at + (i0 + j) * stride));
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (i0 + j < pr.S) s.x += v[j].x, s.y += v[j].y, s.z += v[j].z, s.w += v[j].w;
        }
        reinterpret_cast<float4*>(red)[e] = s;
      }
      __syncthreads();
    }
    fold_tile(p, plan, pr, red, tile, row0, n_rows);
  }
}

// -- row phases ---------------------------------------------------------------

// Phase 1: h = bf16(x * rsqrt(mean x^2 + eps)) * w, one row per block.
__device__ void attn_norm_phase(const FusedLayerParams& p, __nv_bfloat16* h, float* red) {
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const __nv_bfloat16* xr = p.x + size_t(b) * p.d;
    float ss = 0.f;
    for (int n = threadIdx.x; n < p.d; n += kThreads) {
      const float v = ld_bf16(xr + n);
      ss += v * v;
    }
    const float rs = rsqrtf(block_sum(ss, red) / p.d + p.eps);
    for (int n = threadIdx.x; n < p.d; n += kThreads)
      h[size_t(b) * p.d + n] = __float2bfloat16_rn(
          round_bf16(ld_bf16(xr + n) * rs) * norm_w_bf16(p.attn_norm, n, p.unit_offset));
  }
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
  __nv_bfloat16* qterms = reinterpret_cast<__nv_bfloat16*>(p.workspace + plan.qterms);
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
      for (int i0 = 0; i0 < p.s_qkv; i0 += 4) {
        float t[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            t[i][j] = i0 + i < p.s_qkv && col[j] >= 0
                          ? __ldcg(part + (i0 + i) * stride + size_t(b) * Nq + col[j])
                          : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (i0 + i < p.s_qkv) v[j] += t[i][j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col[j];
        if (c < 0) continue;
        float y;  // the sum times the scale, then the bias: two roundings
        if (c < HD) {
          y = __fmul_rn(v[j], p.s_wq[c]);
          if (p.bq) y = __fadd_rn(y, ld_bf16(p.bq + c));
        } else if (c < HD + KHD) {
          y = __fmul_rn(v[j], p.s_wk[c - HD]);
          if (p.bk) y = __fadd_rn(y, ld_bf16(p.bk + c - HD));
        } else {
          y = __fmul_rn(v[j], p.s_wv[c - HD - KHD]);
          if (p.bv) y = __fadd_rn(y, ld_bf16(p.bv + c - HD - KHD));
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
        if (lane == 0) rstat[hh] = rsqrtf(ss / D + p.eps);
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
      if (p.q_norm) {  // (y * rsqrt) * w, each product rounded
        const __nv_bfloat16* w = hh < G ? p.q_norm : p.k_norm;
        y = __fmul_rn(__fmul_rn(y, rstat[hh]), norm_w_f32(w, dd, p.unit_offset));
        yp = __fmul_rn(__fmul_rn(yp, rstat[hh]), norm_w_f32(w, pd, p.unit_offset));
      }
      const float rot = dd < half ? -yp : yp;
      // y cos + rot sin: both products rounded before the add (no fused
      // multiply-add), as the plain version's separate ops round them
      const float out = __fadd_rn(__fmul_rn(y, cos_r[dd]), __fmul_rn(rot, sin_r[dd]));
      if (hh < G) {
        qbuf[size_t(pair) * G * D + e] = out;
        float v = out;  // and as kTerms bf16 terms for the attention's products
#pragma unroll
        for (int j = 0; j < kTerms; ++j) {
          const __nv_bfloat16 t = __float2bfloat16_rn(v);
          qterms[(size_t(pair) * kTerms * kMaxG + j * kMaxG + hh) * (D + 8) + dd] = t;
          v -= __bfloat162float(t);
        }
      } else {
        p.k_new[size_t(pair) * D + dd] = __float2bfloat16_rn(out);
      }
    }
    for (int e = tid; e < kTerms * (kMaxG - G) * D; e += kThreads) {  // rows past G: zero
      const int j = e / ((kMaxG - G) * D), g = G + (e / D) % (kMaxG - G);
      qterms[(size_t(pair) * kTerms * kMaxG + j * kMaxG + g) * (D + 8) + e % D] =
          __float2bfloat16_rn(0.f);
    }
    for (int dd = tid; dd < D; dd += kThreads)
      p.v_new[size_t(pair) * D + dd] = __float2bfloat16_rn(raw[(G + 1) * D + dd]);
  }
}

// -- attention ------------------------------------------------------------------

// An attention slot holds SK keys x D values (32 KB): 128 keys at D 128,
// 64 at D 256; a warp takes 16 keys of a tile (KG warps walk).
template <int D>
struct Attn {
  static constexpr int SK = kSlotBytes / (2 * D);
  static constexpr int KG = SK / 16;
  static constexpr int NCH = D / 64;   // 128-byte chunks of a key's row
  static constexpr int QS = D + 8;     // q rows' stride (bf16): conflict-free ldmatrix
  static constexpr int kSteps = D / 16;
  static constexpr int kAccStride = D + 4;
  static constexpr int kWarpFloats = 8 * kAccStride + 16;  // a warp's state in the merge
  __host__ __device__ static constexpr size_t q_offset() { return size_t(kASlots) * kSlotBytes; }
  __host__ __device__ static constexpr size_t smem() {
    return q_offset() + kTerms * kMaxG * QS * 2;
  }
};

// A slot's layout: box (key run r / box_keys, chunk col / 64) holds
// box_keys lines of 128 bytes; with 8 or more keys a box (128-byte swizzle)
// the 16-byte piece u of a line sits at u ^ (line % 8).
__device__ __forceinline__ int slot_line0(int r, int box_keys, int nch) {
  return (r / box_keys) * nch * box_keys + r % box_keys;
}
__device__ __forceinline__ int slot_offset(int line0, int col, int box_keys, bool swz) {
  const int line = line0 + (col / 64) * box_keys;
  return line * 128 + ((((col / 8) % 8) ^ (swz ? line % 8 : 0)) << 4);
}

// Warp 0: the K (or V) rows of the item's tile at key k0 into `slot`, one
// box a (key run, chunk), counted on `bar`. A box holding no key in [first,
// last] reads the row past the tensor: zeros.
__device__ __forceinline__ void issue_slot(unsigned char* slot, uint64_t* bar,
                                           const CUtensorMap* map, const int32_t* table_row,
                                           int k0, int SK, int nch, int first, int last, int NB,
                                           int BS, int kh, int D, int box_keys, int lane,
                                           void* extra_dst = nullptr,
                                           const void* extra_src = nullptr, int extra = 0) {
  if (lane == 0) mbar_arrive_expect(bar, uint32_t(kSlotBytes + extra));
  __syncwarp();
  fence_async_shared();  // the slot was last read, or written, by threads
  if (extra > 0 && lane == 0)  // beside the item's first slot: its q terms, one bulk copy
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(extra_dst)), "l"(extra_src), "r"(extra), "r"(smem_addr(bar))
        : "memory");
  for (int i = lane; i < (SK / box_keys) * nch; i += 32) {
    const int kp = k0 + (i / nch) * box_keys;  // the box's first key
    int row = NB * BS;
    if (kp + box_keys - 1 >= first && kp <= last)
      row = min(max(table_row[kp / BS], 0), NB - 1) * BS + kp % BS;
    load_box(slot + i * box_keys * 128, map, kh * D + 64 * (i % nch), row, bar);
  }
}

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Phase 3b, one item a (256-key split, row, KV head), handed out from a
// queue split-major (the first splits of every pair first: their cost
// follows the rows' lengths). The history keys are [wlo, kend): below the
// row's start and its page count, at or past the window's first visible
// key; item s takes keys [base + 256 s, base + 256 (s + 1)) of them, base =
// wlo rounded down to 16 keys (so a copy box never crosses a page). Warp 0
// issues the item's slots (K, V of each tile) through the ring, the next
// one as soon as every warp has released the one kASlots before it. Its
// state (m, l, acc over its keys, f32) goes to the workspace; the pair's
// last item to finish merges the splits in split order with the current
// token (always visible) and writes attn.
template <int D>
__device__ void attention_phase(const FusedLayerParams& p, const Plan& plan, const Maps& maps,
                                unsigned char* smem, Ring<kASlots>& ring, int& pos) {
  using A = Attn<D>;
  const int G = p.H / p.KH;
  const int HD = p.H * D;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* qbuf = reinterpret_cast<const float*>(p.workspace + plan.qbuf);
  __nv_bfloat16* attn = reinterpret_cast<__nv_bfloat16*>(p.workspace + plan.attn);
  float* p_attn = reinterpret_cast<float*>(p.workspace + plan.p_attn);
  int* done = reinterpret_cast<int*>(p.workspace + plan.counters);
  int* queue = done + p.B * p.KH;
  // q's rows as kTerms bf16 terms, [term][8][QS]
  __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(smem + A::q_offset());
  const __nv_bfloat16* qterms = reinterpret_cast<const __nv_bfloat16*>(p.workspace + plan.qterms);
  constexpr int kQBytes = kTerms * kMaxG * A::QS * 2;  // a pair's q terms
  __shared__ int s_item, s_last;

  const int box_keys = p.box_keys;
  const bool swz = box_keys >= 8;
  const int pairs = p.B * p.KH;
  const int state = G * (D + 2);  // a split's m, l (G each) and acc (G x D)
  const int kg = warp;            // the warp's 16 keys of a tile
  // ldmatrix rows of the warp's 16 keys: K (A, as it lies) key lane%8 +
  // 8 ((lane/8)%2) at d 8 (lane/16); V (A by .trans) key lane%8 + 8 (lane/16)
  // at d 8 ((lane/8)%2). q's B fragments: row lane % 8 at d 8 (lane / 8) of
  // a pair of k-steps.
  const int k_line = slot_line0(kg * 16 + lane % 8 + 8 * ((lane / 8) % 2), box_keys, A::NCH);
  const int k_col = 8 * (lane / 16);
  const int v_line = slot_line0(kg * 16 + lane % 8 + 8 * (lane / 16), box_keys, A::NCH);
  const int v_col = 8 * ((lane / 8) % 2);
  const int q_off = (lane % 8) * A::QS + 8 * (lane / 8);

  const int n_items = p.n_split * pairs;
  if (tid == 0) to_async_proxy();  // the q terms were written before the barrier
  for (;;) {
    __syncthreads();  // every thread has read the previous item's smem and s_item
    if (tid == 0) s_item = atomicAdd(queue, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= n_items) break;
    const int pair = item % pairs;
    const int split = item / pairs;
    const int b = pair / p.KH;
    const int kh = pair % p.KH;
    const int start = p.start[b];
    const int kend = min(start, p.pcounts[b] * p.BS);
    const int wlo = p.window > 0 ? max(start - p.window + 1, 0) : 0;
    const int base = wlo / 16 * 16;
    const int n_split = kend > wlo ? (kend - base + kSplitKeys - 1) / kSplitKeys : 1;
    if (split >= n_split) continue;
    const int lo = base + split * kSplitKeys;
    const int vlo = max(lo, wlo), vhi = min(lo + kSplitKeys, kend);  // this item's keys
    const int n_tiles = vhi > vlo ? (vhi - lo + A::SK - 1) / A::SK : 0;
    const int32_t* table_row = p.tables + size_t(b) * p.P;
    const int first = pos;  // the item's first ring position: K, V of each tile
    auto issue = [&](int h) {  // warp 0
      if (lane == 0) ring.acquire(first + h);
      __syncwarp();
      issue_slot(smem + ((first + h) % kASlots) * kSlotBytes, ring.bar(first + h),
                 h % 2 ? &maps.v : &maps.k, table_row, lo + (h / 2) * A::SK, A::SK, A::NCH, vlo,
                 vhi - 1, p.NB, p.BS, kh, D, box_keys, lane, qt,
                 qterms + size_t(pair) * kTerms * kMaxG * A::QS, h == 0 ? kQBytes : 0);
    };
    if (warp == 0)
      for (int h = 0; h < min(kASlots, 2 * n_tiles); ++h) issue(h);

    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    float acc[A::kSteps][4];
#pragma unroll
    for (int i = 0; i < A::kSteps; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    auto done_with = [&](int h) {  // release slot h; warp 0 then issues slot h + kASlots
      ring.release(first + h, lane);
      if (warp == 0 && h + kASlots < 2 * n_tiles) issue(h + kASlots);
    };
    for (int it = 0; it < n_tiles; ++it) {
      ring.wait(first + 2 * it);  // the tile's K
      float s[4];
      if (kg < A::KG) {
        const unsigned char* kslot = smem + ((first + 2 * it) % kASlots) * kSlotBytes;
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < A::kSteps; ks += 2) {  // two chains of sums
          uint32_t a0[4], a1[4];
          ldmatrix_x4(a0, kslot + slot_offset(k_line, k_col + 16 * ks, box_keys, swz));
          ldmatrix_x4(a1, kslot + slot_offset(k_line, k_col + 16 * ks + 16, box_keys, swz));
#pragma unroll
          for (int j = 0; j < kTerms; ++j) {
            uint32_t bq[4];
            ldmatrix_x4(bq, qt + j * kMaxG * A::QS + q_off + 16 * ks);
            mma_bf16(c0, a0, bq[0], bq[1]);
            mma_bf16(c1, a1, bq[2], bq[3]);
          }
        }
        // c[e]: key 16 kg + lane/4 (+ 8 for e >= 2) of the tile, row 2 (lane%4) + e%2
        const int key = lo + it * A::SK + kg * 16 + lane / 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = (c0[e] + c1[e]) * p.sm_scale;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          const int kp = key + (e >= 2 ? 8 : 0);
          s[e] = kp >= vlo && kp < vhi ? x : kNegInf;
        }
      }
      done_with(2 * it);
      ring.wait(first + 2 * it + 1);  // the tile's V
      if (kg < A::KG) {
        float mx[2] = {fmaxf(s[0], s[2]), fmaxf(s[1], s[3])};
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], o));
          mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], o));
        }
        float alpha[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float m_new = fmaxf(m[j], mx[j]);
          alpha[j] = expf(m[j] - m_new);
          m[j] = m_new;
        }
        // f32 probabilities (masked keys weigh exactly 0), as kTerms bf16
        // terms for P.V (B fragments: keys 0-7, 8-15); l sums the f32 values
        float pf[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) pf[e] = s[e] > 0.5f * kNegInf ? expf(s[e] - m[e % 2]) : 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + pf[j] + pf[j + 2];
        uint32_t pb[kTerms][2];
        {
          float r[4] = {pf[0], pf[1], pf[2], pf[3]};
#pragma unroll
          for (int j = 0; j < kTerms; ++j) {
            __nv_bfloat16 t[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              t[e] = __float2bfloat16_rn(r[e]);
              r[e] -= __bfloat162float(t[e]);
            }
            pb[j][0] = movmatrix_trans(pack_bf16(t[0], t[1]));
            pb[j][1] = movmatrix_trans(pack_bf16(t[2], t[3]));
          }
        }
        const unsigned char* vslot = smem + ((first + 2 * it + 1) % kASlots) * kSlotBytes;
#pragma unroll
        for (int mt = 0; mt < A::kSteps; ++mt) {
          acc[mt][0] *= alpha[0];
          acc[mt][1] *= alpha[1];
          acc[mt][2] *= alpha[0];
          acc[mt][3] *= alpha[1];
          uint32_t a[4];
          ldmatrix_x4_trans(a, vslot + slot_offset(v_line, v_col + 16 * mt, box_keys, swz));
#pragma unroll
          for (int j = 0; j < kTerms; ++j) mma_bf16(acc[mt], a, pb[j][0], pb[j][1]);
        }
      }
      done_with(2 * it + 1);
    }
    pos = first + 2 * n_tiles;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      l[0] += __shfl_xor_sync(0xffffffffu, l[0], o);
      l[1] += __shfl_xor_sync(0xffffffffu, l[1], o);
    }
    __syncthreads();  // every slot is read: the slots' memory is free

    // The warps' states into the idle slots: acc^T as [8 rows][D + 4], then
    // m [8] and l [8]; then each (row, d) of the item adds its key groups in
    // order kg = 0, 1, ... into the item's state in the workspace.
    float* states = reinterpret_cast<float*>(smem);
    if (kg < A::KG) {
      float* st = states + kg * A::kWarpFloats;
      const int r = 2 * (lane % 4);
#pragma unroll
      for (int mt = 0; mt < A::kSteps; ++mt) {
        const int d = 16 * mt + lane / 4;
        st[r * A::kAccStride + d] = acc[mt][0];
        st[(r + 1) * A::kAccStride + d] = acc[mt][1];
        st[r * A::kAccStride + d + 8] = acc[mt][2];
        st[(r + 1) * A::kAccStride + d + 8] = acc[mt][3];
      }
      if (lane < 4) {
        st[8 * A::kAccStride + r] = m[0];
        st[8 * A::kAccStride + r + 1] = m[1];
        st[8 * A::kAccStride + 8 + r] = l[0];
        st[8 * A::kAccStride + 8 + r + 1] = l[1];
      }
    }
    __syncthreads();
    float* all = p_attn + size_t(pair) * p.n_split * state;
    float* mine = all + size_t(split) * state;
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D, d = e % D;
      float M = kNegInf;
      for (int j = 0; j < A::KG; ++j)
        M = fmaxf(M, states[j * A::kWarpFloats + 8 * A::kAccStride + g]);
      float Acc = 0.f, L = 0.f;
      for (int j = 0; j < A::KG; ++j) {
        const float* sj = states + j * A::kWarpFloats;
        const float w = expf(sj[8 * A::kAccStride + g] - M);
        Acc += w * sj[g * A::kAccStride + d];
        L += w * sj[8 * A::kAccStride + 8 + g];
      }
      mine[2 * G + e] = Acc;
      if (d == 0) {
        mine[g] = M;
        mine[G + g] = L;
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(done + pair, 1) == n_split - 1;
    __syncthreads();
    if (!s_last) continue;
    // The pair's last item: the splits in split order, then the current
    // token (always visible), normalised. Scratch in the idle slots.
    __threadfence();
    constexpr int kBatch = 64;  // splits weighed at a time
    float* qs = states;                  // G x D, f32
    float* am = qs + kMaxG * D;          // G x D
    float* ps = am + kMaxG * D;          // kBatch x G: split weights
    float* m_s = ps + kBatch * kMaxG;
    float* l_s = m_s + kMaxG;
    float* pc_s = l_s + kMaxG;
    __syncthreads();  // the states are read
    for (int o = tid; o < G * D; o += kThreads) {
      qs[o] = __ldcg(qbuf + size_t(pair) * G * D + o);
      am[o] = 0.f;
    }
    __syncthreads();
    const __nv_bfloat16* k_cur = p.k_new + size_t(pair) * D;
    const __nv_bfloat16* v_cur = p.v_new + size_t(pair) * D;
    for (int g = warp; g < G; g += kThreads / 32) {
      float sc = 0.f;
      for (int dd = lane; dd < D; dd += 32) sc += qs[g * D + dd] * ldcg_bf16(k_cur + dd);
      sc = warp_sum(sc) * p.sm_scale;
      if (p.softcap > 0.f) sc = p.softcap * tanhf(sc / p.softcap);
      float mm = sc;
      for (int sp = lane; sp < n_split; sp += 32) mm = fmaxf(mm, __ldcg(all + sp * state + g));
      mm = warp_max(mm);
      float ll = 0.f;
      for (int sp = lane; sp < n_split; sp += 32)
        ll += __ldcg(all + sp * state + G + g) * expf(__ldcg(all + sp * state + g) - mm);
      ll = warp_sum(ll);
      if (lane == 0) {
        const float pc = expf(sc - mm);
        m_s[g] = mm;
        pc_s[g] = pc;
        l_s[g] = ll + pc;
      }
    }
    for (int c0 = 0; c0 < n_split; c0 += kBatch) {
      const int n = min(kBatch, n_split - c0);
      __syncthreads();
      for (int e = tid; e < n * G; e += kThreads)
        ps[e] = expf(__ldcg(all + (c0 + e / G) * state + e % G) - m_s[e % G]);
      __syncthreads();
      for (int o = tid; o < G * D; o += kThreads) {
        const int g = o / D;
        float a = am[o];
        for (int j0 = 0; j0 < n; j0 += 4) {  // four splits' loads in flight, added in order
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j0 + j < n) v[j] = __ldcg(all + (c0 + j0 + j) * state + 2 * G + o);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j0 + j < n) a += v[j] * ps[(j0 + j) * G + g];
        }
        am[o] = a;
      }
    }
    for (int o = tid; o < G * D; o += kThreads) {
      const int g = o / D, dd = o % D;
      const float a = am[o] + pc_s[g] * ldcg_bf16(v_cur + dd);
      attn[size_t(b) * HD + (kh * G + g) * D + dd] = __float2bfloat16_rn(a / fmaxf(l_s[g], 1e-30f));
    }
  }
}

// The row phases run over (row, 128-wide slice) items spread over the
// grid. A row norm needs the whole row: each item writes its slice's sum of
// squares, and after a grid barrier every item adds its row's slice sums in
// slice order (one thread, handed to the block).
__device__ float row_rs(const float* ss, int nsl, int b, int d, float eps, float* bcast) {
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < nsl; ++i) s += __ldcg(ss + size_t(b) * nsl + i);
    bcast[0] = rsqrtf(s / d + eps);
  }
  __syncthreads();
  return bcast[0];
}

// Phases 5 and 8 with post-norms: x_out = bf16(residual + bf16(bf16(y *
// rsqrt) * w)); the attention's also writes the new residual's slice sums
// to ss_b.
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

// Phase 5: h2 = bf16(x_out * rsqrt(mean x_out^2 + eps)) * mlp_norm.
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

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    fused_layer_kernel(FusedLayerParams p, Plan plan, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Ring<kStages> ring;   // the products' stages
  __shared__ Ring<kASlots> aring;  // the attention's slots
  unsigned char* smem = smem_raw + ((kAlign - smem_addr(smem_raw) % kAlign) % kAlign);
  float* red = reinterpret_cast<float*>(smem);  // block_sum's per-warp slots and row_rs's broadcast
  cg::grid_group grid = cg::this_grid();
  unsigned char* ws = p.workspace;
  const bool post = p.attn_post_norm != nullptr;
  const int HD = p.H * D, KHD = p.KH * D;
  int pos = 0, apos = 0;  // the rings' positions

  if (threadIdx.x == 0) {
    ring.init(kWarps);
    aring.init(kWarps);
  }
  {  // the attention items' per-pair finish counters, their queue head and
     // the tiles' finished splits, read after at least one barrier
    unsigned* cnt = reinterpret_cast<unsigned*>(ws + plan.counters);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < plan.n_counters; i += gridDim.x * kThreads)
      cnt[i] = 0u;
  }
  const int groups = (p.B + kRows - 1) / kRows;
  unsigned* cnt_o = reinterpret_cast<unsigned*>(ws + plan.counters) + p.B * p.KH + 1;
  unsigned* cnt_gu = cnt_o + groups * (p.d / kTileN);
  unsigned* cnt_down = cnt_gu + groups * (p.F / kTileN);
  __syncthreads();  // the rings are set up

  const Product qkv{{&maps.w[kWq], &maps.w[kWk], &maps.w[kWv]}, {HD, KHD, KHD}, 1, &maps.a[kAH],
                    p.d, p.s_qkv, reinterpret_cast<float*>(ws + plan.p_qkv), HD + 2 * KHD,
                    kFoldNone, false, nullptr};
  const Product o{{&maps.w[kWo], nullptr, nullptr}, {p.d, 0, 0}, 1, &maps.a[kAAttn], HD, p.s_o,
                  reinterpret_cast<float*>(ws + plan.p_o), p.d, kFoldResidual, false, cnt_o};
  const Product gate_up{{&maps.w[kWGate], &maps.w[kWUp], nullptr}, {p.F, 0, 0}, 2, &maps.a[kAH2],
                        p.d, p.s_gu, reinterpret_cast<float*>(ws + plan.p_gu), 2 * p.F, kFoldAct,
                        false, cnt_gu};
  const Product down{{&maps.w[kWDown], nullptr, nullptr}, {p.d, 0, 0}, 1, &maps.a[kAGu], p.F,
                     p.s_down, reinterpret_cast<float*>(ws + plan.p_down), p.d, kFoldResidual,
                     true, cnt_down};

  attn_norm_phase(p, reinterpret_cast<__nv_bfloat16*>(ws + plan.h), red);
  to_async_proxy();
  grid.sync();
  product_phase(qkv, p, plan, ring, smem, pos);
  grid.sync();
  qkv_epilogue_phase<D>(p, plan, reinterpret_cast<float*>(smem));
  to_async_proxy();
  grid.sync();
  attention_phase<D>(p, plan, maps, smem, aring, apos);
  to_async_proxy();
  grid.sync();
  product_phase(o, p, plan, ring, smem, pos);
  grid.sync();
  if (post) {
    residual_post_norm(p, plan, false, red);
    grid.sync();
  }
  mlp_norm_phase(p, plan, red);
  to_async_proxy();
  grid.sync();
  product_phase(gate_up, p, plan, ring, smem, pos);
  to_async_proxy();
  grid.sync();
  product_phase(down, p, plan, ring, smem, pos);
  if (post) {
    grid.sync();
    residual_post_norm(p, plan, true, red);
  }
}

template <int D>
void* kernel_for() {
  return reinterpret_cast<void*>(fused_layer_kernel<D>);
}

template <int D>
size_t smem_for(int G) {
  const size_t products = size_t(kRingBytes) + kScratchBytes;
  const size_t attention = Attn<D>::smem();
  const size_t epilogue = sizeof(float) * (size_t(G + 2) * D + G + 1);  // phase 3a
  size_t s = products > attention ? products : attention;
  s = s > epilogue ? s : epilogue;
  return kAlign + s;
}

size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

// A K split the kernel takes: 1..16 splits of whole 128-deep chunks.
bool split_ok(int K, int S) {
  return S >= 1 && S <= kMaxSplitsK && K % kChunkK == 0 && (K / kChunkK) % S == 0;
}

// The co-resident grid and the dynamic shared memory of the kernel for D
// and G on the current device, asked once per (device, D, G).
cudaError_t grid_for(int D, int G, int* grid, int* smem) {
  if ((D != 128 && D != 256) || G < 1 || G > kMaxG) return cudaErrorInvalidValue;
  static int known[64][2][kMaxG + 1] = {};  // grid, once asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const size_t bytes = D == 128 ? smem_for<128>(G) : smem_for<256>(G);
  int* slot = dev < 64 ? &known[dev][D == 256][G] : nullptr;
  if (slot && *slot > 0) {
    *grid = *slot;
    *smem = int(bytes);
    return cudaSuccess;
  }
  void* fn = D == 128 ? kernel_for<128>() : kernel_for<256>();
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
  *grid = per_sm * sms;
  *smem = int(bytes);
  if (slot) *slot = *grid;
  return cudaSuccess;
}

cudaError_t make_plan(int B, int d, int H, int KH, int D, int F, int P, int BS, int s_qkv,
                      int s_o, int s_gu, int s_down, int n_split, int box_keys, Plan* plan) {
  if (B <= 0 || KH <= 0 || H % KH || (D != 128 && D != 256) || d % 128 || F % 128 || P <= 0 ||
      BS <= 0 || H / KH > kMaxG)
    return cudaErrorInvalidValue;
  const int G = H / KH;
  const int HD = H * D, KHD = KH * D;
  if (!split_ok(d, s_qkv) || !split_ok(HD, s_o) || !split_ok(d, s_gu) || !split_ok(F, s_down))
    return cudaErrorInvalidValue;
  if (n_split < (P * BS + kSplitKeys - 1) / kSplitKeys || box_keys < 1 || box_keys > 16 ||
      (box_keys & (box_keys - 1)) || BS % box_keys)
    return cudaErrorInvalidValue;
  cudaError_t err = grid_for(D, G, &plan->grid, &plan->smem);
  if (err != cudaSuccess) return err;
  const int groups = (B + kRows - 1) / kRows;
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
  plan->p_qkv = take(sizeof(float) * s_qkv * B * (HD + 2 * KHD));
  plan->p_o = take(s_o > 1 ? sizeof(float) * s_o * B * d : 0);
  plan->p_gu = take(s_gu > 1 ? sizeof(float) * s_gu * B * 2 * F : 0);
  plan->p_down = take(s_down > 1 ? sizeof(float) * s_down * B * d : 0);
  plan->ybuf = take(sizeof(float) * B * d);
  plan->ss_a = take(sizeof(float) * B * (d / kSliceW));
  plan->ss_b = take(sizeof(float) * B * (d / kSliceW));
  plan->qbuf = take(sizeof(float) * size_t(B) * HD);
  plan->qterms = take(size_t(B) * KH * kTerms * kMaxG * (D + 8) * 2);
  plan->p_attn = take(sizeof(float) * size_t(B) * KH * n_split * G * (D + 2));
  plan->n_counters = B * KH + 1 + groups * (2 * (d / kTileN) + F / kTileN);
  plan->counters = take(sizeof(unsigned) * plan->n_counters);
  plan->total = off;
  return cudaSuccess;
}

cudaError_t make_maps(const FusedLayerParams& p, const Plan& plan, Maps* maps) {
  using int8_stream::codes_map;
  using int8_stream::rows_map;
  using int8_stream::tensor_map;
  const int HD = p.H * p.D, KHD = p.KH * p.D;
  const int8_t* w[7] = {p.wq, p.wk, p.wv, p.wo, p.w_gate, p.w_up, p.w_down};
  const int K[7] = {p.d, p.d, p.d, HD, p.d, p.d, p.F};
  const int N[7] = {HD, KHD, KHD, p.d, p.F, p.F, p.d};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 7 && err == cudaSuccess; ++i) err = codes_map(w[i], K[i], N[i], &maps->w[i]);
  unsigned char* ws = p.workspace;
  if (err == cudaSuccess) err = rows_map(ws + plan.h, p.B, p.d, kRows, &maps->a[kAH]);
  if (err == cudaSuccess) err = rows_map(ws + plan.attn, p.B, HD, kRows, &maps->a[kAAttn]);
  if (err == cudaSuccess) err = rows_map(ws + plan.h2, p.B, p.d, kRows, &maps->a[kAH2]);
  if (err == cudaSuccess) err = rows_map(ws + plan.gu, p.B, p.F, kRows, &maps->a[kAGu]);
  const bool swz = p.box_keys >= 8;  // the 128-byte swizzle wants boxes of 8 lines or more
  if (err == cudaSuccess)
    err = tensor_map(p.k_pool, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.NB * p.BS, KHD, p.box_keys,
                     64, &maps->k, swz);
  if (err == cudaSuccess)
    err = tensor_map(p.v_pool, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.NB * p.BS, KHD, p.box_keys,
                     64, &maps->v, swz);
  return err;
}

__global__ void cluster_probe_kernel(int* ran) {
  cg::this_grid().sync();
  cg::this_cluster().sync();
  if (threadIdx.x == 0) atomicAdd(ran, 1);
}

}  // namespace

// The co-resident grid of the layer kernel for head dim D and G query rows
// a KV head (blocks, into *grid), as the wrapper's plan assumes it.
extern "C" int fused_layer_grid(int D, int G, int* grid) {
  int smem = 0;
  return grid ? grid_for(D, G, grid, &smem) : cudaErrorInvalidValue;
}

// Workspace bytes the launch below needs for these shapes and this plan
// (-1: refused).
extern "C" long long fused_layer_workspace_bytes(int B, int d, int H, int KH, int D, int F, int P,
                                                 int BS, int s_qkv, int s_o, int s_gu, int s_down,
                                                 int n_split, int box_keys) {
  Plan plan;
  if (make_plan(B, d, H, KH, D, F, P, BS, s_qkv, s_o, s_gu, s_down, n_split, box_keys, &plan) !=
      cudaSuccess)
    return -1;
  return (long long)plan.total;
}

// Launches one layer on `stream`; returns the CUDA error (0 = launched).
extern "C" int fused_decoder_layer_bf16(FusedLayerParams p, void* stream) {
  if (p.NB <= 0 || p.BS <= 0 || p.P <= 0 || !p.x || !p.workspace) return cudaErrorInvalidValue;
  Plan plan;
  cudaError_t err = make_plan(p.B, p.d, p.H, p.KH, p.D, p.F, p.P, p.BS, p.s_qkv, p.s_o, p.s_gu,
                              p.s_down, p.n_split, p.box_keys, &plan);
  if (err != cudaSuccess) return err;
  Maps maps;
  if ((err = make_maps(p, plan, &maps)) != cudaSuccess) return err;
  void* args[] = {&p, &plan, &maps};
  void* fn = p.D == 128 ? kernel_for<128>() : kernel_for<256>();
  // A cooperative launch through the attribute form: the same launch, and
  // one that CUDA graph stream capture records as a cooperative node.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = size_t(plan.smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Whether the card takes a cooperative launch with a thread block cluster
// dimension (a grid barrier and a cluster barrier in one kernel): `blocks`
// blocks in clusters of `cluster`, each adding one to *ran (a device int,
// zeroed by the caller). Returns the launch's error (0 = it launched).
extern "C" int fused_layer_cluster_probe(int cluster, int blocks, int* ran, void* stream) {
  if (cluster < 1 || blocks < cluster || blocks % cluster || ran == nullptr)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(32);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = cluster;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_probe_kernel, ran);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
