// Paged attention over a bf16 or an int8 block pool, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of dynamo_tpu/ops/pallas/paged_attention.py,
// each for both pool types the TPU kernels take:
//   * paged_attention_decode_{bf16,int8} <- _paged_attention_decode_kernel_impl
//     (body _decode_kernel): C <= 8 query tokens per sequence, C*G <= 64.
//     One thread block per (sequence b, KV head h, split of its keys).
//   * paged_attention_chunk_{bf16,int8}  <- _paged_attention_kernel_impl
//     (body _kernel): any C, ragged chunk_lens. A grid of
//     (B, KH, ceil(C*G / 64)) blocks, each holding up to 64 query rows of
//     one (b, h); rows are (c, g) pairs, c-major, as the Pallas kernels
//     order them.
// Semantics are the JAX oracle's (ops/attention.py::_paged_attention_xla_impl):
// key t is visible to row (c, g) iff t <= start + c and, with a window
// W > 0, t > start + c - W; optional softcap cap*tanh(s/cap) after
// sm_scale; the finite -1e30 sentinel (never -inf, so an all-masked padding
// row stays finite); f32 online max / normaliser / accumulator; output in
// q's dtype (bf16).
//
// What bounds it on the card: at decode it reads every live K/V byte once
// (2 * tokens * KH * D * 2 bytes per sequence) and does ~4 flops per
// byte per query row — far below the ~295 flop/byte of the H100's bf16
// ridge — so the floor is memory bandwidth (3.35 TB/s). The chunk kernel
// at C = 512 does 4*C*G*D flops per key for the same key bytes and sits
// on the compute side, where only the tensor cores reach the card's peak.
//
// Block sizes: any that divides 64 (a tile holds whole pages) or is a
// multiple of 64 up to 256 (a page spans whole tiles, e.g. 128 for the
// recipes and _prof_8b.py); the tile walk counts keys, not pages.
//
// Decode (one pass). A block walks its pages in tiles of TILE keys; each
// thread holds its share of the next tile in registers (16-byte loads: one
// token's [D] row lies at stride KH*D in the pool) while the current tile
// is scored, so one tile's loads overlap the previous tile's math. Scores,
// the softmax update and P.V run on CUDA cores in f32 from shared memory:
//   * decode layout (C*G <= 8 rows, e.g. 7 for Qwen2.5-0.5B, 2 for
//     Gemma-2-2B and 4 for Gemma-3-1B, the rest padding): 8-row blocks
//     over tiles of 16384/D keys (32 KB each of K and V). A thread scores
//     one key against every row; in P.V it accumulates two columns of every
//     row over its own group of keys, and the groups' partial sums are added
//     once at the end.
//   * 64-row layout (decode with 8 < C*G <= 64): 64-key tiles; a thread
//     scores 4 rows x 4 keys and accumulates 4 rows x D/16 columns.
//
// Decode split over the keys (flash-decoding). A block's tiles run in
// series, so B x KH one-pass blocks (32 at Gemma-3-1B's 32 sequences and
// one KV head, 64 at Gemma-2-2B's 16 x 4) leave most of the 132 SMs idle
// while each walks thousands of keys. The decode entry points take a split
// count, chosen by the caller from the shapes and this kernel's occupancy
// alone (never from start_pos, which lives on the card): with splits > 1 a
// second kernel, paged_attention_split_kernel, runs a grid of
// (B * splits, KH, 1) blocks, and split s walks an equal share, in whole
// tiles, of its (b, h)'s own tile range (the range the window and the
// causal limit leave), writing its unnormalised f32 accumulator and its
// running max m and sum l to a workspace; an empty share writes m = -1e30,
// l = 0, acc = 0. paged_attention_combine then adds the splits in a fixed
// order: out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30),
// M the largest m_s; a split whose keys are all masked for a row carries
// the weight e^(-1e30 - M) = 0 there. The split blocks, two an SM, score on
// the tensor cores (mma.sync m16n8k16, bf16 q and K, both exact, f32 sums;
// q's 8 rows the top half of the A tile, the staged K tile the B operand
// as it lies, [key][d]) and skip the padding rows in P.V. With splits == 1
// the one-pass kernel runs and no combine.
//
// Chunks (paged_attention_chunk_kernel): both products on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 sums). At C = 512 a chunk does
// 4*C*G*D flops per key, so the bound is operations, which CUDA cores
// reach only a few percent of. A block of 64
// query rows has 4 warps of 16 rows (8 warps at D 256, two a row group,
// each taking half of P.V's columns so that no thread holds more than 64
// accumulators). Per 64-key tile:
//   * S = Q K^T: q staged once as bf16 rows (exact) is the A operand, the
//     staged [key][d] K tile the B operand (ldmatrix without .trans);
//   * per accumulator element, in this order: x sm_scale, x the key's
//     scale (int8 pools), the softcap, the causal and window masks (-1e30;
//     skipped for a tile every row of the warp sees whole);
//   * online softmax in registers, each row's max and sum reduced over the
//     4 lanes that share it; no shared P tile;
//   * P V: the S accumulators are the A fragments of P, V the B operand by
//     ldmatrix.trans from the staged tile. The TPU kernel multiplies f32
//     probabilities with f32 V, so P goes in as two bf16 halves, hi =
//     bf16(p) and lo = bf16(p - hi), both into the same f32 sums: within
//     2^-16 p of the f32 product. With int8 pools p is first x the value's
//     scale, after the row sum.
// Tiles are staged two deep by 16-byte cp.async copies (int8 pools: the
// codes and the tile's scales, then converted exactly to bf16 in a shared
// tile by the block); keys on pages outside the block's walked pages read
// as zeros. The walk runs from the tile of the first key the block's first
// row may see (start + c_lo - W + 1 with a window, else 0) to that of its
// last valid row's causal limit. Row blocks are scheduled last-first: the
// last rows see the most keys, so the longest blocks start first. What
// bounds it now is latency, not the tensor cores' rate: a block's tile runs
// its products, its softmax and its staging with one or two warps an SM
// quarter (PERF.md, "what holds #2 back").
//
// int8 pools (the `quantized` branch of both TPU kernels; layout of
// ops/kv_quant.py): codes int8 [NB, BS, KH, D] and one float32 scale per
// (block, head, slot), [NB, KH, BS]. The pool type is a template
// parameter. A tile's codes are loaded as int8 (16 to a 16-byte load: half
// the bytes of a bf16 tile) and converted once, exactly, to bf16 in shared
// memory, so the math reads the same staged tile as for bf16 pools; the
// tile's scales come by a second, strided load (the scales run [KH, BS]
// within a block, not along the codes). The scales are folded in the TPU
// kernel's order: scores x= s_k[t] after sm_scale and before the softcap;
// probabilities x= s_v[t] after the row sum l and before P.V
// (paged_attention.py:139-150). The split's combine is linear in acc and
// l, so that order holds.
//
// Left for later PRs: tensor cores in the one-pass decode kernel, wgmma
// and a warp-specialised producer for the chunk kernel, a key split of
// the chunk walk where few row blocks are live (Gemma-3's global layers:
// KH 1), a decode layout narrower than 8 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_gemv.cuh"  // int8x4_to_bf16x4: the exact int8 -> bf16 convert

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 64;  // query rows per block, at most
constexpr int kVec = 8;       // bf16 per 16-byte load
constexpr int kMaxSplits = 16;  // key splits of a decode call, at most
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // e^x = 2^(x log2 e)

// What a pool holds: bf16 values, or int8 codes with a float32 scale per
// token and head.
struct Bf16Pool {
  using T = __nv_bfloat16;
  static constexpr bool kScaled = false;
};
struct Int8Pool {
  using T = int8_t;
  static constexpr bool kScaled = true;
};

template <typename POOL, int D, int ROWS, int TILE>
struct Layout {
  static constexpr bool kSmall = ROWS <= 8;
  static_assert(kThreads % TILE == 0, "a tile has at most kThreads keys");
  static_assert(kSmall || (ROWS == 64 && TILE == 64), "64-row layout: 64 rows x 64 keys");
  static constexpr int kKvStride = D + 8;    // padded: conflict-free 16-byte reads
  static constexpr int kPStride = TILE + 4;  // padded, rows stay 16-byte aligned
  static constexpr size_t kQBytes = size_t(ROWS) * D * sizeof(float);
  static constexpr size_t kKvBytes = size_t(TILE) * kKvStride * sizeof(__nv_bfloat16);
  static constexpr size_t kPBytes = size_t(ROWS) * kPStride * sizeof(float);
  static constexpr size_t kStatBytes = 3 * ROWS * sizeof(float);
  // int8 pools: the tile's K and V scales
  static constexpr size_t kScaleBytes = POOL::kScaled ? 2 * TILE * sizeof(float) : 0;
  static constexpr size_t kTotal = kQBytes + 2 * kKvBytes + kPBytes + kStatBytes + kScaleBytes;
  static constexpr int kPerLoad = 16 / sizeof(typename POOL::T);  // pool values a 16-byte load
  static constexpr int kVecPerRow = D / kPerLoad;
  static constexpr int kLoads = TILE * kVecPerRow / kThreads;  // 16-byte loads per thread
  static_assert(TILE * kVecPerRow % kThreads == 0, "a tile is whole 16-byte loads a thread");
  static constexpr int kKeysPerLane = TILE / 32;                // softmax phase
  // Decode layout. Scores: thread (srg, st) scores key st against rows
  // srg, srg + kRowGroups, ... P.V: thread (kg, cp) owns columns 2cp, 2cp+1
  // of every row over kKeysPerGroup keys of each tile.
  static constexpr int kRowGroups = kThreads / TILE;
  static constexpr int kScoreRows = ROWS / kRowGroups;
  static constexpr int kColPairs = D / 2;
  static constexpr int kKeyGroups = kThreads / kColPairs;
  static constexpr int kKeysPerGroup = TILE / kKeyGroups;
  static_assert(!kSmall || (kKeysPerGroup % 4 == 0 &&
                            size_t(kKeyGroups) * ROWS * D * sizeof(float) <= kKvBytes),
                "decode layout: key groups of 4-key steps; partial sums fit the K tile");
  // 64-row layout: thread (tid / 16, tid % 16) scores rows 4*(tid/16) + i
  // against keys tid%16 + 16*j, and accumulates those rows over columns
  // kCols*(tid%16) + c.
  static constexpr int kCols = D / 16;
};

// One tile's K and V rows for this thread, into registers, and with int8
// pools the scales of key `tid` of the tile. Pages outside
// [first_page, last_page] (and table entries out of range) read as zeros;
// their keys are masked.
template <typename POOL, int D, int ROWS, int TILE>
__device__ __forceinline__ void load_tile(
    uint4 (&kreg)[Layout<POOL, D, ROWS, TILE>::kLoads],
    uint4 (&vreg)[Layout<POOL, D, ROWS, TILE>::kLoads], float& ksreg, float& vsreg,
    const typename POOL::T* __restrict__ k_cache, const float* __restrict__ k_scale,
    const typename POOL::T* __restrict__ v_cache, const float* __restrict__ v_scale,
    const int32_t* __restrict__ table_row, int tile, int tid, int first_page, int last_page,
    int NB, int BS, int KH, int h) {
  using L = Layout<POOL, D, ROWS, TILE>;
  auto block_of = [&](int kp) {  // the pool block of key position kp, or -1
    const int page = kp / BS;
    if (page < first_page || page > last_page) return -1;
    const int blk = table_row[page];
    return blk >= 0 && blk < NB ? blk : -1;
  };
#pragma unroll
  for (int i = 0; i < L::kLoads; ++i) {
    const int vec = tid + i * kThreads;
    const int kp = tile * TILE + vec / L::kVecPerRow;
    const int blk = block_of(kp);
    uint4 kz = make_uint4(0, 0, 0, 0);
    uint4 vz = kz;
    if (blk >= 0) {
      const size_t off =
          ((size_t(blk) * BS + kp % BS) * KH + h) * D + (vec % L::kVecPerRow) * L::kPerLoad;
      kz = __ldg(reinterpret_cast<const uint4*>(k_cache + off));
      vz = __ldg(reinterpret_cast<const uint4*>(v_cache + off));
    }
    kreg[i] = kz;
    vreg[i] = vz;
  }
  if constexpr (POOL::kScaled) {
    ksreg = vsreg = 0.f;
    const int kp = tile * TILE + tid;
    const int blk = tid < TILE ? block_of(kp) : -1;
    if (blk >= 0) {
      const size_t off = (size_t(blk) * KH + h) * BS + kp % BS;
      ksreg = __ldg(k_scale + off);
      vsreg = __ldg(v_scale + off);
    }
  }
}

// A tile's registers into shared memory: bf16 as loaded, int8 codes
// converted to bf16 (16 codes -> 32 bytes).
template <typename POOL, int D, int ROWS, int TILE>
__device__ __forceinline__ void store_tile(const uint4 (&reg)[Layout<POOL, D, ROWS, TILE>::kLoads],
                                           __nv_bfloat16* dst, int tid) {
  using L = Layout<POOL, D, ROWS, TILE>;
#pragma unroll
  for (int i = 0; i < L::kLoads; ++i) {
    const int vec = tid + i * kThreads;
    const int off = (vec / L::kVecPerRow) * L::kKvStride + (vec % L::kVecPerRow) * L::kPerLoad;
    if constexpr (POOL::kScaled) {
      const uint2 p0 = int8_gemv::int8x4_to_bf16x4(reg[i].x);
      const uint2 p1 = int8_gemv::int8x4_to_bf16x4(reg[i].y);
      const uint2 p2 = int8_gemv::int8x4_to_bf16x4(reg[i].z);
      const uint2 p3 = int8_gemv::int8x4_to_bf16x4(reg[i].w);
      reinterpret_cast<uint4*>(dst + off)[0] = make_uint4(p0.x, p0.y, p1.x, p1.y);
      reinterpret_cast<uint4*>(dst + off)[1] = make_uint4(p2.x, p2.y, p3.x, p3.y);
    } else {
      *reinterpret_cast<uint4*>(dst + off) = reg[i];
    }
  }
}

__device__ __forceinline__ void bf16x8_to_float(const uint4& raw, float (&f)[kVec]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int u = 0; u < kVec / 2; ++u) {
    const float2 x = __bfloat1622float2(p[u]);
    f[2 * u] = x.x;
    f[2 * u + 1] = x.y;
  }
}

// The kernels' body. SPLIT: a split of a decode block's keys (blockIdx.x =
// b * splits + s) writing its partials to `part`: acc [splits][B*C*H][D],
// then (m, l) [splits][B*C*H][2], all f32. Otherwise `part` and `splits`
// are unused.
template <typename POOL, int D, int ROWS, int TILE, bool SPLIT>
__device__ __forceinline__ void paged_attention_body(
    const __nv_bfloat16* __restrict__ q,          // [B, C, H, D]
    const typename POOL::T* __restrict__ k_cache,  // [NB, BS, KH, D]
    const float* __restrict__ k_scale,             // [NB, KH, BS] (int8 pools), or null
    const typename POOL::T* __restrict__ v_cache,  // [NB, BS, KH, D]
    const float* __restrict__ v_scale,             // [NB, KH, BS] (int8 pools), or null
    const int32_t* __restrict__ block_tables,      // [B, P]
    const int32_t* __restrict__ start_pos,      // [B]
    __nv_bfloat16* __restrict__ out,            // [B, C, H, D]
    float* __restrict__ part,                   // SPLIT: the partials
    int C, int H, int KH, int NB, int BS, int P, int window, float sm_scale,
    float logit_cap, int splits) {
  using L = Layout<POOL, D, ROWS, TILE>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::kQBytes);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::kQBytes + L::kKvBytes);
  float* ps = reinterpret_cast<float*>(smem + L::kQBytes + 2 * L::kKvBytes);
  float* m_s = ps + ROWS * L::kPStride;
  float* l_s = m_s + ROWS;
  float* a_s = l_s + ROWS;
  float* ks_s = a_s + ROWS;  // int8 pools: the tile's key scales, then value scales
  float* vs_s = ks_s + TILE;

  const int b = SPLIT ? blockIdx.x / splits : blockIdx.x;
  const int split = SPLIT ? blockIdx.x % splits : 0;
  const int h = blockIdx.y;
  const int G = H / KH;
  const int r0 = blockIdx.z * ROWS;
  const int nrows = min(ROWS, C * G - r0);
  const int tid = threadIdx.x;
  const int start = start_pos[b];
  const int32_t* table_row = block_tables + size_t(b) * P;
  // Element offset of query/output row rr of this block, a (c, g) pair.
  auto row_offset = [&](int rr) {
    const int r = r0 + rr;
    const int c = r / G;
    return (size_t(b * C + c) * H + h * G + (r - c * G)) * D;
  };

  if constexpr (!SPLIT) {
    for (int e = tid; e < ROWS * D; e += kThreads) {
      const int rr = e / D;
      qs[e] = rr < nrows ? __bfloat162float(q[row_offset(rr) + e % D]) : 0.f;
    }
  }
  for (int rr = tid; rr < ROWS; rr += kThreads) {
    m_s[rr] = kNegInf;
    l_s[rr] = 0.f;
  }

  // Pages this block needs: up to its last row's causal limit, and with a
  // window, none wholly before start - W + 1 (paged_attention.py:216-227).
  // Tiles are counted in keys, not pages: a page of BS > TILE keys spans
  // several tiles, and the walk runs from the tile of the first key any row
  // may see to the tile of the last one (load_tile finds each key's page).
  const int c_hi = (r0 + nrows - 1) / G;
  const int last_key = max(start + c_hi, 0);
  const int last_page = min(last_key / BS, P - 1);
  const int first_key = window > 0 ? max(start - window + 1, 0) : 0;
  const int first_page = first_key / BS;
  const int key_end = min((last_key / BS + 1) * BS, P * BS);  // keys >= this: not loaded
  int tile_first = first_key / TILE;
  int n_tiles =
      first_page <= last_page ? (min(last_key, key_end - 1)) / TILE - tile_first + 1 : 0;
  if constexpr (SPLIT) {  // this split's share of the tiles, whole tiles; may be empty
    const int lo = split * n_tiles / splits;
    const int hi = (split + 1) * n_tiles / splits;
    tile_first += lo;
    n_tiles = hi - lo;
  }

  auto score = [&](float s, int rr, int kp, int t) {  // scale, softcap, masks; t: key in tile
    s *= sm_scale;
    if constexpr (POOL::kScaled) s *= ks_s[t];
    if (logit_cap > 0.f) s = logit_cap * tanhf(s / logit_cap);
    const int limit = start + (r0 + rr) / G;
    const bool visible = kp <= limit && kp < key_end && (window <= 0 || kp > limit - window);
    return visible ? s : kNegInf;
  };

  const int warp = tid / 32;
  const int lane = tid % 32;
  // Decode layout: P.V key group and column pair; partial sums of every row.
  const int kg = tid / L::kColPairs;
  const int cp = tid % L::kColPairs;
  float2 pacc[L::kSmall ? ROWS : 1];
  // 64-row layout: row quad and key/column group; 4 rows x kCols sums.
  const int rq = tid / 16;
  const int cg = tid % 16;
  float acc[L::kSmall ? 1 : 4][L::kSmall ? 1 : L::kCols];
  if constexpr (L::kSmall) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) pacc[r] = make_float2(0.f, 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) acc[i][c] = 0.f;
  }

  uint4 kreg[L::kLoads];
  uint4 vreg[L::kLoads];
  float ksreg = 0.f, vsreg = 0.f;
  if (n_tiles > 0)
    load_tile<POOL, D, ROWS, TILE>(kreg, vreg, ksreg, vsreg, k_cache, k_scale, v_cache, v_scale,
                                   table_row, tile_first, tid, first_page, last_page, NB, BS, KH,
                                   h);
  if constexpr (SPLIT) {
    // q, staged once the first tile is in flight: in the decode layout as
    // bf16 rows of stride kKvStride (the score mma's A operand, in the f32
    // q area), in the 64-row layout as f32
    for (int e = tid; e < ROWS * D; e += kThreads) {
      const int rr = e / D;
      const __nv_bfloat16 v = rr < nrows ? q[row_offset(rr) + e % D] : __float2bfloat16(0.f);
      if constexpr (L::kSmall)
        reinterpret_cast<__nv_bfloat16*>(qs)[rr * L::kKvStride + e % D] = v;
      else
        qs[e] = __bfloat162float(v);
    }
  }
  __syncthreads();

  for (int it = 0; it < n_tiles; ++it) {
    const int tile = tile_first + it;
    __syncthreads();  // the previous tile's P.V is done with ks/vs/ps and the scales
    store_tile<POOL, D, ROWS, TILE>(kreg, ks, tid);
    store_tile<POOL, D, ROWS, TILE>(vreg, vs, tid);
    if constexpr (POOL::kScaled) {
      if (tid < TILE) {
        ks_s[tid] = ksreg;
        vs_s[tid] = vsreg;
      }
    }
    __syncthreads();
    if (it + 1 < n_tiles)  // in flight during this tile's math
      load_tile<POOL, D, ROWS, TILE>(kreg, vreg, ksreg, vsreg, k_cache, k_scale, v_cache, v_scale,
                                     table_row, tile + 1, tid, first_page, last_page, NB, BS,
                                     KH, h);

    // Scores into ps.
    if constexpr (L::kSmall && SPLIT) {
      // The split blocks score on the tensor cores: the 8 rows of q (bf16,
      // exact) are the top half of an m16 A tile, a tile's keys are n8 B
      // tiles read from K as staged ([key][d] is the B operand's "col"
      // layout: ldmatrix without .trans), f32 sums of exact products. Warp w
      // takes kNT of the tile's TILE / 8 key groups.
      constexpr int kNT = TILE / 8 / (kThreads / 32);
      const __nv_bfloat16* a_row = reinterpret_cast<const __nv_bfloat16*>(qs) +
                                   (lane % 8) * L::kKvStride + (lane / 8) * 8;
      const __nv_bfloat16* b_row = ks + (warp * kNT * 8 + lane % 8) * L::kKvStride + (lane / 8) * 8;
      float c[kNT][2][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][0][e] = c[j][1][e] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < D / 32; ++k2) {  // two 16-deep steps
        uint32_t a[4];
        int8_gemv::ldmatrix_x4(a, a_row + k2 * 32);  // rows 0-7: (k, k + 8) of both steps
        const uint32_t a0[4] = {a[0], 0u, a[1], 0u};
        const uint32_t a1[4] = {a[2], 0u, a[3], 0u};
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint32_t b[4];
          int8_gemv::ldmatrix_x4(b, b_row + j * 8 * L::kKvStride + k2 * 32);
          int8_gemv::mma_bf16(c[j][0], a0, b[0], b[1]);
          int8_gemv::mma_bf16(c[j][1], a1, b[2], b[3]);
        }
      }
      const int g = lane / 4;  // the accumulator's row; keys 2 (lane % 4) + {0, 1}
      if (g < nrows) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int t = (warp * kNT + j) * 8 + 2 * (lane % 4);
          ps[g * L::kPStride + t] = score(c[j][0][0] + c[j][1][0], g, tile * TILE + t, t);
          ps[g * L::kPStride + t + 1] =
              score(c[j][0][1] + c[j][1][1], g, tile * TILE + t + 1, t + 1);
        }
      }
    } else if constexpr (L::kSmall) {
      const int st = tid % TILE;
      const int srg = tid / TILE;
      float s_acc[L::kScoreRows];
#pragma unroll
      for (int j = 0; j < L::kScoreRows; ++j) s_acc[j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += kVec) {
        float kf[kVec];
        bf16x8_to_float(*reinterpret_cast<const uint4*>(ks + st * L::kKvStride + d), kf);
#pragma unroll
        for (int j = 0; j < L::kScoreRows; ++j) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + (srg + j * L::kRowGroups) * D + d);
          const float4 qb =
              *reinterpret_cast<const float4*>(qs + (srg + j * L::kRowGroups) * D + d + 4);
          s_acc[j] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                      qb.x * kf[4] + qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
        }
      }
#pragma unroll
      for (int j = 0; j < L::kScoreRows; ++j) {
        const int rr = srg + j * L::kRowGroups;
        if (rr < nrows) ps[rr * L::kPStride + st] = score(s_acc[j], rr, tile * TILE + st, st);
      }
    } else {
      float s4[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s4[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += kVec) {
        float kf[4][kVec];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bf16x8_to_float(
              *reinterpret_cast<const uint4*>(ks + (cg + 16 * j) * L::kKvStride + d), kf[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + (4 * rq + i) * D + d);
          const float4 qb = *reinterpret_cast<const float4*>(qs + (4 * rq + i) * D + d + 4);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s4[i][j] += qa.x * kf[j][0] + qa.y * kf[j][1] + qa.z * kf[j][2] + qa.w * kf[j][3] +
                        qb.x * kf[j][4] + qb.y * kf[j][5] + qb.z * kf[j][6] + qb.w * kf[j][7];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = 4 * rq + i;
        if (rr < nrows) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ps[rr * L::kPStride + cg + 16 * j] =
                score(s4[i][j], rr, tile * TILE + cg + 16 * j, cg + 16 * j);
        }
      }
    }
    __syncthreads();

    // Online softmax: one warp per row, TILE/32 keys per lane.
    for (int rr = warp; rr < nrows; rr += kThreads / 32) {
      float* prow = ps + rr * L::kPStride;
      float sv[L::kKeysPerLane];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < L::kKeysPerLane; ++i) {
        sv[i] = prow[lane + 32 * i];
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[rr];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < L::kKeysPerLane; ++i) {
        const float p = expf(sv[i] - m_new);
        sum += p;  // the row sum takes the unscaled probabilities
        if constexpr (POOL::kScaled)
          prow[lane + 32 * i] = p * vs_s[lane + 32 * i];
        else
          prow[lane + 32 * i] = p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[rr] = alpha;
        l_s[rr] = l_s[rr] * alpha + sum;
        m_s[rr] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V, reading P four keys at a time.
    if constexpr (L::kSmall) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float alpha = r < nrows ? a_s[r] : 0.f;
        pacc[r].x *= alpha;
        pacc[r].y *= alpha;
      }
      const int t0 = kg * L::kKeysPerGroup;
#pragma unroll 2
      for (int t = t0; t < t0 + L::kKeysPerGroup; t += 4) {
        float2 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vs + (t + u) * L::kKvStride + 2 * cp));
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (SPLIT && r >= nrows) continue;  // block-uniform
          const float4 p4 = *reinterpret_cast<const float4*>(ps + r * L::kPStride + t);
          pacc[r].x += p4.x * v[0].x + p4.y * v[1].x + p4.z * v[2].x + p4.w * v[3].x;
          pacc[r].y += p4.x * v[0].y + p4.y * v[1].y + p4.z * v[2].y + p4.w * v[3].y;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float alpha = 4 * rq + i < nrows ? a_s[4 * rq + i] : 0.f;
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) acc[i][c] *= alpha;
      }
#pragma unroll 2
      for (int t = 0; t < TILE; t += 4) {
        float p[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 p4 = *reinterpret_cast<const float4*>(ps + (4 * rq + i) * L::kPStride + t);
          p[i][0] = p4.x;
          p[i][1] = p4.y;
          p[i][2] = p4.z;
          p[i][3] = p4.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const __nv_bfloat162* v2 =
              reinterpret_cast<const __nv_bfloat162*>(vs + (t + u) * L::kKvStride + L::kCols * cg);
#pragma unroll
          for (int c2 = 0; c2 < L::kCols / 2; ++c2) {
            const float2 v = __bfloat1622float2(v2[c2]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][2 * c2] += p[i][u] * v.x;
              acc[i][2 * c2 + 1] += p[i][u] * v.y;
            }
          }
        }
      }
    }
  }

  // SPLIT: this split's slices of the partials; row_offset(rr) / D is the
  // row's index in [B*C*H].
  float* part_acc = nullptr;
  if constexpr (SPLIT) {
    const size_t n_out = size_t(gridDim.x / splits) * C * H * D;
    part_acc = part + size_t(split) * n_out;
    float* part_ml = part + size_t(splits) * n_out + size_t(split) * (n_out / D) * 2;
    for (int rr = tid; rr < nrows; rr += kThreads) {
      part_ml[row_offset(rr) / D * 2] = m_s[rr];
      part_ml[row_offset(rr) / D * 2 + 1] = l_s[rr];
    }
  }
  if constexpr (L::kSmall) {
    // Add the key groups' partial sums (in the K tile's shared memory).
    float* red = reinterpret_cast<float*>(ks);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      red[(kg * ROWS + r) * D + 2 * cp] = pacc[r].x;
      red[(kg * ROWS + r) * D + 2 * cp + 1] = pacc[r].y;
    }
    __syncthreads();
    for (int e = tid; e < nrows * D; e += kThreads) {
      const int rr = e / D;
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < L::kKeyGroups; ++g) sum += red[(g * ROWS + rr) * D + e % D];
      if constexpr (SPLIT)
        part_acc[row_offset(rr) + e % D] = sum;
      else
        out[row_offset(rr) + e % D] = __float2bfloat16(sum / fmaxf(l_s[rr], 1e-30f));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = 4 * rq + i;
      if (rr < nrows) {
        if constexpr (SPLIT) {
          float2* p2 = reinterpret_cast<float2*>(part_acc + row_offset(rr) + L::kCols * cg);
#pragma unroll
          for (int c2 = 0; c2 < L::kCols / 2; ++c2)
            p2[c2] = make_float2(acc[i][2 * c2], acc[i][2 * c2 + 1]);
        } else {
          const float inv = 1.f / fmaxf(l_s[rr], 1e-30f);
          __nv_bfloat162* o2 =
              reinterpret_cast<__nv_bfloat162*>(out + row_offset(rr) + L::kCols * cg);
#pragma unroll
          for (int c2 = 0; c2 < L::kCols / 2; ++c2)
            o2[c2] = __floats2bfloat162_rn(acc[i][2 * c2] * inv, acc[i][2 * c2 + 1] * inv);
        }
      }
    }
  }
}

// One pass: a block per (b, h, row block) writes its rows of out.
template <typename POOL, int D, int ROWS, int TILE>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const typename POOL::T* __restrict__ k_cache,
    const float* __restrict__ k_scale, const typename POOL::T* __restrict__ v_cache,
    const float* __restrict__ v_scale, const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ start_pos, __nv_bfloat16* __restrict__ out, int C, int H,
    int KH, int NB, int BS, int P, int window, float sm_scale, float logit_cap) {
  paged_attention_body<POOL, D, ROWS, TILE, false>(q, k_cache, k_scale, v_cache, v_scale,
                                                   block_tables, start_pos, out, nullptr, C, H,
                                                   KH, NB, BS, P, window, sm_scale, logit_cap, 1);
}

// A split of a decode block's keys, writing partials. Two blocks an SM (at
// most 128 registers a thread) in the decode layout and at D 64; the 64-row
// layout at D 128 and 256 needs more.
template <typename POOL, int D, int ROWS, int TILE>
__global__ void __launch_bounds__(kThreads, ROWS <= 8 || D <= 64 ? 2 : 1)
    paged_attention_split_kernel(
    const __nv_bfloat16* __restrict__ q, const typename POOL::T* __restrict__ k_cache,
    const float* __restrict__ k_scale, const typename POOL::T* __restrict__ v_cache,
    const float* __restrict__ v_scale, const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ start_pos, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int C, int H, int KH, int NB, int BS, int P, int window,
    float sm_scale, float logit_cap, int splits) {
  paged_attention_body<POOL, D, ROWS, TILE, true>(q, k_cache, k_scale, v_cache, v_scale,
                                                  block_tables, start_pos, out, part, C, H, KH,
                                                  NB, BS, P, window, sm_scale, logit_cap, splits);
}

// The splits' partials of a decode call into bf16 out [B, C, H, D] (`rows`
// = B*C*H), adding the splits in order 0, 1, ... (no atomics: runs repeat
// bit for bit). Templated on the pool type only so that a profile names it
// beside its pool's split kernel.
template <typename POOL>
__global__ void __launch_bounds__(kThreads)
    paged_attention_combine(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                            int rows, int D, int splits) {
  const size_t n_out = size_t(rows) * D;
  const size_t e = size_t(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_out) return;
  const float* ml = part + size_t(splits) * n_out + (e / D) * 2;
  // every split's loads issued before any is used: one memory latency
  float m[kMaxSplits], l[kMaxSplits], acc[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < splits) {
      m[s] = ml[size_t(s) * rows * 2];
      l[s] = ml[size_t(s) * rows * 2 + 1];
      acc[s] = part[size_t(s) * n_out + e];
    }
  }
  float mx = kNegInf;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < splits) mx = fmaxf(mx, m[s]);
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < splits) {
      const float w = expf(m[s] - mx);
      num += w * acc[s];
      den += w * l[s];
    }
  }
  out[e] = __float2bfloat16(num / fmaxf(den, 1e-30f));
}

template <typename POOL, int D, int ROWS, int TILE>
cudaError_t launch(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                   const void* tables, const void* start, void* out, float* part, int B, int C, int H, int KH, int NB, int BS, int P, int window,
                   float sm_scale, float logit_cap, int splits, cudaStream_t stream) {
  using T = typename POOL::T;
  const size_t smem = Layout<POOL, D, ROWS, TILE>::kTotal;
  const int row_blocks = (C * (H / KH) + ROWS - 1) / ROWS;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kc = static_cast<const T*>(k);
  const auto* vc = static_cast<const T*>(v);
  const auto* ksf = static_cast<const float*>(ks);
  const auto* vsf = static_cast<const float*>(vs);
  const auto* tb = static_cast<const int32_t*>(tables);
  const auto* sp = static_cast<const int32_t*>(start);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (splits == 1) {  // one pass, no combine
    err = cudaFuncSetAttribute(paged_attention_kernel<POOL, D, ROWS, TILE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    paged_attention_kernel<POOL, D, ROWS, TILE>
        <<<dim3(B, KH, row_blocks), kThreads, smem, stream>>>(
            qb, kc, ksf, vc, vsf, tb, sp, ob, C, H, KH, NB, BS, P, window, sm_scale, logit_cap);
    return cudaGetLastError();
  }
  // splits > 1 (decode only, one row block a (b, h)): the split kernel into
  // `part`, then the combine into out
  err = cudaFuncSetAttribute(paged_attention_split_kernel<POOL, D, ROWS, TILE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  paged_attention_split_kernel<POOL, D, ROWS, TILE>
      <<<dim3(B * splits, KH, row_blocks), kThreads, smem, stream>>>(
          qb, kc, ksf, vc, vsf, tb, sp, ob, part, C, H, KH, NB, BS, P, window, sm_scale,
          logit_cap, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = B * C * H;
  const int blocks = int((size_t(rows) * D + kThreads - 1) / kThreads);
  paged_attention_combine<POOL><<<blocks, kThreads, 0, stream>>>(part, ob, rows, D, splits);
  return cudaGetLastError();
}

// small: the decode layout (<= 8 rows); otherwise the 64-row layout.
template <typename POOL, int D>
cudaError_t launch_d(bool small, const void* q, const void* k, const void* ks, const void* v,
                     const void* vs, const void* tables, const void* start, void* out,
                     float* part, int B, int C, int H, int KH, int NB, int BS, int P, int window,
                     float sm_scale, float logit_cap, int splits, cudaStream_t s) {
  if (small)
    return launch<POOL, D, 8, 16384 / D>(q, k, ks, v, vs, tables, start, out, part, B, C, H, KH,
                                         NB, BS, P, window, sm_scale, logit_cap, splits, s);
  return launch<POOL, D, kMaxRows, 64>(q, k, ks, v, vs, tables, start, out, part, B, C, H, KH,
                                       NB, BS, P, window, sm_scale, logit_cap, splits, s);
}

// Blocks of the split decode kernel the card holds at once: SMs x blocks an
// SM at its registers and shared memory (0 if a query fails).
template <typename POOL, int D, int ROWS, int TILE>
int split_capacity() {
  const auto kernel = paged_attention_split_kernel<POOL, D, ROWS, TILE>;
  const int smem = int(Layout<POOL, D, ROWS, TILE>::kTotal);
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) ||
      cudaGetDevice(&dev) || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return 0;
  return per_sm * sms;
}

template <typename POOL>
int split_capacity_d(bool small, int D) {
  if (D == 64)
    return small ? split_capacity<POOL, 64, 8, 256>() : split_capacity<POOL, 64, 64, 64>();
  if (D == 128)
    return small ? split_capacity<POOL, 128, 8, 128>() : split_capacity<POOL, 128, 64, 64>();
  if (D == 256)
    return small ? split_capacity<POOL, 256, 8, 64>() : split_capacity<POOL, 256, 64, 64>();
  return 0;
}

template <typename POOL>
cudaError_t dispatch(bool small, const void* q, const void* k, const void* ks, const void* v,
                     const void* vs, const void* tables, const void* start, void* out, void* part, int B, int C, int H, int KH, int D, int NB, int BS,
                     int P, int window, float sm_scale, float logit_cap, int splits,
                     void* stream) {
  // Block sizes that divide 64, or multiples of 64 up to 256 (the tile walk
  // takes any size; these are the ones the wrappers admit and the tests hold).
  const bool bs_ok = BS > 0 && (64 % BS == 0 || (BS % 64 == 0 && BS <= 256));
  if (B <= 0 || C <= 0 || KH <= 0 || H % KH != 0 || !bs_ok || P <= 0)
    return cudaErrorInvalidValue;
  if (POOL::kScaled && (ks == nullptr || vs == nullptr)) return cudaErrorInvalidValue;
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  // Built for head_dim 64 (Qwen2.5-0.5B), 128 (Llama-3-8B) and 256
  // (Gemma-2-2B, Gemma-3-1B) over both pool types; other widths are
  // refused. At D = 128 the decode layout takes tiles of 128 keys, at
  // D = 256 tiles of 64. At D = 256 the 64-row layout holds 148 KB of
  // shared memory (q in f32 64 KB, K and V 33 KB each, P 17 KB; int8 pools
  // add the tile's 512 bytes of scales): one block an SM. An int8 tile
  // takes half the prefetch registers of a bf16 one (16 codes a 16-byte
  // load), so the int8 instantiations fit where the bf16 ones do.
  if (D == 64)
    return launch_d<POOL, 64>(small, q, k, ks, v, vs, tables, start, out, pf, B, C, H, KH,
                              NB, BS, P, window, sm_scale, logit_cap, splits, s);
  if (D == 128)
    return launch_d<POOL, 128>(small, q, k, ks, v, vs, tables, start, out, pf, B, C, H, KH,
                               NB, BS, P, window, sm_scale, logit_cap, splits, s);
  if (D == 256)
    return launch_d<POOL, 256>(small, q, k, ks, v, vs, tables, start, out, pf, B, C, H, KH,
                               NB, BS, P, window, sm_scale, logit_cap, splits, s);
  return cudaErrorInvalidValue;
}

// ---- The chunk kernel, on the tensor cores ------------------------------
//
// A block holds 64 query rows of one (b, h) — (c, g) pairs, c-major — and
// walks 64-key tiles. Warp (rw, cw) owns rows 16 rw .. 16 rw + 15 and, in
// P.V, columns cw * kDW .. + kDW (at D 256 two warps share a row group, each
// scoring the group's rows — the scores are computed twice — and taking half
// of the columns, so that no thread holds more than 64 accumulators).
template <typename POOL, int D>
struct ChunkLayout {
  static constexpr int kRowWarps = 4;
  static constexpr int kColWarps = D >= 256 ? 2 : 1;
  static constexpr int kThreads = 32 * kRowWarps * kColWarps;
  static constexpr int kRows = 16 * kRowWarps;  // 64
  static constexpr int kTile = 64;              // keys a tile
  static constexpr int kDW = D / kColWarps;     // P.V columns a warp
  static constexpr int kStride = D + 8;         // bf16 a staged row: conflict-free ldmatrix
  static constexpr size_t kTileBytes = size_t(kTile) * kStride * 2;  // a bf16 K or V tile
  static constexpr size_t kQBytes = size_t(kRows) * kStride * 2;
  static constexpr size_t kCodeBytes = size_t(kTile) * D;  // int8 pools: a tile's codes
  // A stage: bf16 pools, the K and V tiles as staged; int8 pools, their codes
  // and the tile's K and V scales. Two stages; int8 pools add one bf16 K
  // and V tile that the codes are converted into.
  static constexpr size_t kStageBytes =
      POOL::kScaled ? 2 * kCodeBytes + 2 * kTile * sizeof(float) : 2 * kTileBytes;
  static constexpr size_t kConvBytes = POOL::kScaled ? 2 * kTileBytes : 0;
  static constexpr size_t kTotal = kQBytes + 2 * kStageBytes + kConvBytes;
  static constexpr int kMinBlocks = D >= 256 ? 1 : 2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-filled, src is not read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Issue the copies of one tile's K and V rows (and with int8 pools their
// scales) into a stage. Keys on pages outside [first_page, last_page], or
// whose table entry is out of range, are zero-filled; they are masked.
template <typename POOL, int D>
__device__ __forceinline__ void chunk_issue_tile(
    unsigned char* stage, const typename POOL::T* __restrict__ k_cache,
    const float* __restrict__ k_scale, const typename POOL::T* __restrict__ v_cache,
    const float* __restrict__ v_scale, const int32_t* __restrict__ table_row, int tile,
    int first_page, int last_page, int NB, int BS, int KH, int h) {
  using L = ChunkLayout<POOL, D>;
  constexpr int kPer = 16 / sizeof(typename POOL::T);  // pool values a 16-byte copy
  constexpr int kVecRow = D / kPer;
  auto block_of = [&](int kp) {
    const int page = kp / BS;
    if (page < first_page || page > last_page) return -1;
    const int blk = table_row[page];
    return blk >= 0 && blk < NB ? blk : -1;
  };
  constexpr int kIters = L::kTile * kVecRow / L::kThreads;
  static_assert(kIters * L::kThreads == L::kTile * kVecRow, "a tile is whole copies a thread");
  // every table entry first, so that their loads overlap, then the copies
  int blks[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i)
    blks[i] = block_of(tile * L::kTile + (threadIdx.x + i * L::kThreads) / kVecRow);
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int p = threadIdx.x + i * L::kThreads;
    const int key = p / kVecRow, vec = p % kVecRow;
    const int kp = tile * L::kTile + key;
    const int blk = blks[i];
    const size_t off = blk >= 0 ? ((size_t(blk) * BS + kp % BS) * KH + h) * D + vec * kPer : 0;
    unsigned char* kd;
    unsigned char* vd;
    if constexpr (POOL::kScaled) {
      kd = stage + key * D + vec * 16;
      vd = kd + L::kCodeBytes;
    } else {
      kd = stage + (key * L::kStride + vec * 8) * 2;
      vd = kd + L::kTileBytes;
    }
    cp_async16(kd, k_cache + off, blk >= 0);
    cp_async16(vd, v_cache + off, blk >= 0);
  }
  if constexpr (POOL::kScaled) {
    float* ss = reinterpret_cast<float*>(stage + 2 * L::kCodeBytes);
    for (int key = threadIdx.x; key < L::kTile; key += L::kThreads) {
      const int kp = tile * L::kTile + key;
      const int blk = block_of(kp);
      const size_t off = blk >= 0 ? (size_t(blk) * KH + h) * BS + kp % BS : 0;
      cp_async4(ss + key, k_scale + off, blk >= 0);
      cp_async4(ss + L::kTile + key, v_scale + off, blk >= 0);
    }
  }
}

template <typename POOL, int D>
__global__ void __launch_bounds__(ChunkLayout<POOL, D>::kThreads, ChunkLayout<POOL, D>::kMinBlocks)
    paged_attention_chunk_kernel(
        const __nv_bfloat16* __restrict__ q,          // [B, C, H, D]
        const typename POOL::T* __restrict__ k_cache,  // [NB, BS, KH, D]
        const float* __restrict__ k_scale,             // [NB, KH, BS] (int8 pools), or null
        const typename POOL::T* __restrict__ v_cache,
        const float* __restrict__ v_scale,
        const int32_t* __restrict__ block_tables,      // [B, P]
        const int32_t* __restrict__ start_pos,         // [B]
        const int32_t* __restrict__ chunk_lens,        // [B]
        __nv_bfloat16* __restrict__ out,               // [B, C, H, D]
        int C, int H, int KH, int NB, int BS, int P, int window, float sm_scale,
        float logit_cap) {
  using L = ChunkLayout<POOL, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* stages = smem + L::kQBytes;
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(stages + 2 * L::kStageBytes);

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / KH;
  // the last row blocks, whose rows see the most keys, are scheduled first
  const int r0 = (gridDim.z - 1 - blockIdx.z) * L::kRows;
  const int nrows = min(L::kRows, C * G - r0);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int rw = warp % L::kRowWarps;  // row group
  const int cw = warp / L::kRowWarps;  // column half (D 256)
  const int start = start_pos[b];
  const int clen = chunk_lens[b];
  const int32_t* table_row = block_tables + size_t(b) * P;
  auto row_offset = [&](int rr) {  // element offset of row rr of this block, a (c, g) pair
    const int r = r0 + rr;
    const int c = r / G;
    return (size_t(b * C + c) * H + h * G + (r - c * G)) * D;
  };

  if (r0 / G >= clen) {  // every row of this block is chunk padding
    for (int e = tid; e < nrows * D; e += L::kThreads)
      out[row_offset(e / D) + e % D] = __float2bfloat16(0.f);
    return;
  }

  // The keys this block needs: up to its last valid row's causal limit and,
  // with a window, none before its first row's first visible key
  // (start + c_lo - W + 1); tiles counted in keys from that key's tile.
  const int c_lo = r0 / G;
  const int c_hi = min((r0 + nrows - 1) / G, clen - 1);
  const int last_key = max(start + c_hi, 0);
  const int last_page = min(last_key / BS, P - 1);
  const int first_key = window > 0 ? max(start + c_lo - window + 1, 0) : 0;
  const int first_page = first_key / BS;
  const int key_end = min((last_key / BS + 1) * BS, P * BS);  // keys >= this: not loaded
  const int tile_first = first_key / L::kTile;
  const int n_tiles =
      first_page <= last_page ? min(last_key, key_end - 1) / L::kTile - tile_first + 1 : 0;

  auto issue = [&](int it) {
    chunk_issue_tile<POOL, D>(stages + (it & 1) * L::kStageBytes, k_cache, k_scale, v_cache,
                              v_scale, table_row, tile_first + it, first_page, last_page, NB, BS,
                              KH, h);
  };
  if (n_tiles > 0) issue(0);
  // q as bf16 rows (exact: q arrives in bf16), rows past nrows zero
  for (int p = tid; p < L::kRows * (D / 8); p += L::kThreads) {
    const int rr = p / (D / 8), d = (p % (D / 8)) * 8;
    cp_async16(qs + rr * L::kStride + d, rr < nrows ? q + row_offset(rr) + d : q, rr < nrows);
  }
  cp_async_commit();

  // Per thread: rows g = lane / 4 and g + 8 of the warp's group; the running
  // max m, the thread's part of the row sum l (its keys 2 (lane % 4) + {0, 1}
  // of each n8 tile), and the P.V accumulators of its kDW / 8 n8 tiles.
  const int g = lane / 4, t4 = lane % 4;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float acc[L::kDW / 8][4];
#pragma unroll
  for (int n = 0; n < L::kDW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  int limit[2];  // the causal limit of rows g and g + 8
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) limit[hf] = start + (r0 + rw * 16 + g + 8 * hf) / G;
  const int warp_lo = start + (r0 + rw * 16) / G;       // the warp's smallest limit
  const int warp_hi = start + (r0 + rw * 16 + 15) / G;  // and its largest

  // ldmatrix addresses. q (A): rows lane % 16 of the group at d 8 (lane / 16).
  // K (B, [key][d] as staged, no .trans): lanes 0-7 keys 0-7 at d 0, 8-15 the
  // same keys at d 8, 16-31 keys 8-15: r[0], r[1] the first n8 tile's
  // fragment, r[2], r[3] the second's. V (B, .trans): lanes 0-7 keys 0-7,
  // 8-15 keys 8-15, at columns 0 (lanes 0-15) and 8 (16-31) of a column pair.
  const int q_off = (rw * 16 + lane % 16) * L::kStride + (lane / 16) * 8;
  const int k_off = (lane % 8 + (lane / 16) * 8) * L::kStride + ((lane / 8) % 2) * 8;
  const int v_off = (lane % 8 + ((lane / 8) % 2) * 8) * L::kStride + cw * L::kDW + (lane / 16) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile it (and q) have landed
    __syncthreads();     // everyone's have
    const unsigned char* stage = stages + (it & 1) * L::kStageBytes;
    const __nv_bfloat16* ks;
    const __nv_bfloat16* vs;
    const float* kscale = nullptr;
    const float* vscale = nullptr;
    if constexpr (POOL::kScaled) {
      // codes -> bf16, exactly, 16 at a time, into the conversion tiles
      for (int p = tid; p < 2 * L::kTile * (D / 16); p += L::kThreads) {
        const int kv = p / (L::kTile * (D / 16));
        const int e = p % (L::kTile * (D / 16));
        const int key = e / (D / 16), col = (e % (D / 16)) * 16;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(stage + kv * L::kCodeBytes + key * D + col);
        const uint2 p0 = int8_gemv::int8x4_to_bf16x4(raw.x);
        const uint2 p1 = int8_gemv::int8x4_to_bf16x4(raw.y);
        const uint2 p2 = int8_gemv::int8x4_to_bf16x4(raw.z);
        const uint2 p3 = int8_gemv::int8x4_to_bf16x4(raw.w);
        uint4* dst = reinterpret_cast<uint4*>(conv + kv * (L::kTileBytes / 2) + key * L::kStride + col);
        dst[0] = make_uint4(p0.x, p0.y, p1.x, p1.y);
        dst[1] = make_uint4(p2.x, p2.y, p3.x, p3.y);
      }
      kscale = reinterpret_cast<const float*>(stage + 2 * L::kCodeBytes);
      vscale = kscale + L::kTile;
      ks = conv;
      vs = conv + L::kTileBytes / 2;
      __syncthreads();
    } else {
      ks = reinterpret_cast<const __nv_bfloat16*>(stage);
      vs = reinterpret_cast<const __nv_bfloat16*>(stage + L::kTileBytes);
    }

    // S = Q K^T: the group's 16 rows x the tile's 64 keys, f32 sums of exact
    // bf16 products.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      int8_gemv::ldmatrix_x4(a, qs + q_off + kk * 16);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bk[4];
        int8_gemv::ldmatrix_x4(bk, ks + k_off + jp * 16 * L::kStride + kk * 16);
        int8_gemv::mma_bf16(s[2 * jp], a, bk[0], bk[1]);
        int8_gemv::mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }

    // sm_scale, the key scale (int8 pools), the softcap, the masks — per
    // element, in that order; then the online softmax over the row, its max
    // and sum reduced over the 4 lanes that share it.
    const int key0 = (tile_first + it) * L::kTile;
    // every key of the tile visible to every row of the warp: no mask to apply
    const bool unmasked = key0 + L::kTile - 1 <= warp_lo && key0 + L::kTile <= key_end &&
                          (window <= 0 || key0 > warp_hi - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 8 * j + 2 * t4 + (e & 1);
        const int hf = e / 2;
        float v = s[j][e] * sm_scale;
        if constexpr (POOL::kScaled) v *= kscale[t];
        if (logit_cap > 0.f) v = logit_cap * tanhf(v / logit_cap);
        if (!unmasked) {
          const int kp = key0 + t;
          const bool visible =
              kp <= limit[hf] && kp < key_end && (window <= 0 || kp > limit[hf] - window);
          v = visible ? v : kNegInf;
        }
        s[j][e] = v;
        mx[hf] = fmaxf(mx[hf], v);
      }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m_run[hf], mx[hf]);
      alpha[hf] = exp2f((m_run[hf] - m_new) * kLog2e);
      m_run[hf] = m_new;
      l_run[hf] *= alpha[hf];
    }
#pragma unroll
    for (int n = 0; n < L::kDW / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[j][e] - m_run[e / 2]) * kLog2e);
        l_run[e / 2] += p;  // the row sum takes the unscaled probabilities
        if constexpr (POOL::kScaled)
          s[j][e] = p * vscale[8 * j + 2 * t4 + (e & 1)];
        else
          s[j][e] = p;
      }

    // acc += P V on the tensor cores. The accumulators of S are the A
    // fragments of P (n8 tiles 2kk and 2kk + 1 make the 16 keys of k-step
    // kk). P keeps f32 accuracy as two bf16 halves, hi = bf16(p) and lo =
    // bf16(p - hi), both multiplied into the same f32 sums:
    // |p - (hi + lo)| <= 2^-16 p.
#pragma unroll
    for (int kk = 0; kk < L::kTile / 16; ++kk) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float x0 = s[2 * kk + u / 2][2 * (u % 2)];
        const float x1 = s[2 * kk + u / 2][2 * (u % 2) + 1];
        ahi[u] = pack_bf16(x0, x1);
        const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&ahi[u]);
        alo[u] = pack_bf16(x0 - __low2float(hb), x1 - __high2float(hb));
      }
#pragma unroll
      for (int np = 0; np < L::kDW / 16; ++np) {
        uint32_t bv[4];
        int8_gemv::ldmatrix_x4_trans(bv, vs + v_off + kk * 16 * L::kStride + np * 16);
        int8_gemv::mma_bf16(acc[2 * np], ahi, bv[0], bv[1]);
        int8_gemv::mma_bf16(acc[2 * np], alo, bv[0], bv[1]);
        int8_gemv::mma_bf16(acc[2 * np + 1], ahi, bv[2], bv[3]);
        int8_gemv::mma_bf16(acc[2 * np + 1], alo, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the stage (refilled at it + 2) and the conversion tiles are free
  }
  cp_async_wait<0>();

  // out = acc / l, rows g and g + 8, columns 8n + 2 (lane % 4) + {0, 1}
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_run[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int rr = rw * 16 + g + 8 * hf;
    if (rr < nrows) {
      __nv_bfloat16* o = out + row_offset(rr) + cw * L::kDW + 2 * t4;
#pragma unroll
      for (int n = 0; n < L::kDW / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) =
            __floats2bfloat162_rn(acc[n][2 * hf] * inv, acc[n][2 * hf + 1] * inv);
    }
  }
}

template <typename POOL, int D>
cudaError_t chunk_launch(const void* q, const void* k, const void* ks, const void* v,
                         const void* vs, const void* tables, const void* start,
                         const void* clens, void* out, int B, int C, int H, int KH, int NB,
                         int BS, int P, int window, float sm_scale, float logit_cap,
                         cudaStream_t stream) {
  using L = ChunkLayout<POOL, D>;
  using T = typename POOL::T;
  const auto kernel = paged_attention_chunk_kernel<POOL, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::kTotal));
  if (err != cudaSuccess) return err;
  const int row_blocks = (C * (H / KH) + L::kRows - 1) / L::kRows;
  kernel<<<dim3(B, KH, row_blocks), L::kThreads, L::kTotal, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const float*>(ks), static_cast<const T*>(v), static_cast<const float*>(vs),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(clens), static_cast<__nv_bfloat16*>(out), C, H, KH, NB, BS, P,
      window, sm_scale, logit_cap);
  return cudaGetLastError();
}

template <typename POOL>
cudaError_t chunk_dispatch(const void* q, const void* k, const void* ks, const void* v,
                           const void* vs, const void* tables, const void* start,
                           const void* clens, void* out, int B, int C, int H, int KH, int D,
                           int NB, int BS, int P, int window, float sm_scale, float logit_cap,
                           void* stream) {
  const bool bs_ok = BS > 0 && (64 % BS == 0 || (BS % 64 == 0 && BS <= 256));
  if (B <= 0 || C <= 0 || KH <= 0 || H % KH != 0 || !bs_ok || P <= 0 || clens == nullptr)
    return cudaErrorInvalidValue;
  if (POOL::kScaled && (ks == nullptr || vs == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return chunk_launch<POOL, 64>(q, k, ks, v, vs, tables, start, clens, out, B, C, H, KH, NB, BS,
                                  P, window, sm_scale, logit_cap, s);
  if (D == 128)
    return chunk_launch<POOL, 128>(q, k, ks, v, vs, tables, start, clens, out, B, C, H, KH, NB,
                                   BS, P, window, sm_scale, logit_cap, s);
  if (D == 256)
    return chunk_launch<POOL, 256>(q, k, ks, v, vs, tables, start, clens, out, B, C, H, KH, NB,
                                   BS, P, window, sm_scale, logit_cap, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The split decode kernel's capacity (blocks resident at once) for the
// caller's split count: int8 pools or bf16, the decode layout (C*G <= 8) or
// the 64-row one, head_dim D.
extern "C" int paged_attention_decode_capacity(int int8, int small, int D) {
  return int8 ? split_capacity_d<Int8Pool>(small, D) : split_capacity_d<Bf16Pool>(small, D);
}

// Each launcher returns cudaGetLastError() after its launches (0 = launched).
// The decode launchers take `splits` (1: one pass, no workspace) and, for
// splits > 1, `part`: a float32 workspace of splits * B*C*H * (D + 2)
// values (ops/cuda/paged_attention.py allocates it).
extern "C" int paged_attention_decode_bf16(const void* q, const void* k, const void* v,
                                           const void* tables, const void* start, void* out,
                                           void* part, int B, int C, int H, int KH, int D,
                                           int NB, int BS, int P, int window, float sm_scale,
                                           float logit_cap, int splits, void* stream) {
  if (KH <= 0 || C * (H / KH) > kMaxRows) return cudaErrorInvalidValue;
  return dispatch<Bf16Pool>(C * (H / KH) <= 8, q, k, nullptr, v, nullptr, tables, start, out,
                            part, B, C, H, KH, D, NB, BS, P, window, sm_scale, logit_cap, splits,
                            stream);
}

extern "C" int paged_attention_chunk_bf16(const void* q, const void* k, const void* v,
                                          const void* tables, const void* start,
                                          const void* chunk_lens, void* out, int B, int C,
                                          int H, int KH, int D, int NB, int BS, int P,
                                          int window, float sm_scale, float logit_cap,
                                          void* stream) {
  if (KH <= 0) return cudaErrorInvalidValue;
  return chunk_dispatch<Bf16Pool>(q, k, nullptr, v, nullptr, tables, start, chunk_lens, out, B, C,
                                  H, KH, D, NB, BS, P, window, sm_scale, logit_cap, stream);
}

// int8 pools: k8/v8 int8 [NB, BS, KH, D], ks/vs float32 [NB, KH, BS].
extern "C" int paged_attention_decode_int8(const void* q, const void* k8, const void* ks,
                                           const void* v8, const void* vs, const void* tables,
                                           const void* start, void* out, void* part, int B, int C,
                                           int H, int KH, int D, int NB, int BS, int P,
                                           int window, float sm_scale, float logit_cap,
                                           int splits, void* stream) {
  if (KH <= 0 || C * (H / KH) > kMaxRows) return cudaErrorInvalidValue;
  return dispatch<Int8Pool>(C * (H / KH) <= 8, q, k8, ks, v8, vs, tables, start, out, part, B, C,
                            H, KH, D, NB, BS, P, window, sm_scale, logit_cap, splits, stream);
}

extern "C" int paged_attention_chunk_int8(const void* q, const void* k8, const void* ks,
                                          const void* v8, const void* vs, const void* tables,
                                          const void* start, const void* chunk_lens, void* out,
                                          int B, int C, int H, int KH, int D, int NB, int BS,
                                          int P, int window, float sm_scale, float logit_cap,
                                          void* stream) {
  if (KH <= 0) return cudaErrorInvalidValue;
  return chunk_dispatch<Int8Pool>(q, k8, ks, v8, vs, tables, start, chunk_lens, out, B, C, H, KH,
                                  D, NB, BS, P, window, sm_scale, logit_cap, stream);
}
