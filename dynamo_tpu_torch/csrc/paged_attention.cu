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
// Both share one device function. Semantics are the JAX oracle's
// (ops/attention.py::_paged_attention_xla_impl): key t is visible to row
// (c, g) iff t <= start + c and, with a window W > 0, t > start + c - W;
// optional softcap cap*tanh(s/cap) after sm_scale; the finite -1e30
// sentinel (never -inf, so an all-masked padding row stays finite); f32
// online max / normaliser / accumulator; output in q's dtype (bf16).
//
// What bounds it on the card: at decode it reads every live K/V byte once
// (2 * tokens * KH * D * 2 bytes per sequence) and does ~4 flops per
// byte per query row — far below the ~295 flop/byte of the H100's bf16
// ridge — so the floor is memory bandwidth (3.35 TB/s). The chunk kernel
// at C = 512 does 4*C*G*D flops per key for the same key bytes and sits
// on the compute side, where only tensor cores reach the card's peak.
//
// Block sizes: any that divides 64 (a tile holds whole pages) or is a
// multiple of 64 up to 256 (a page spans whole tiles, e.g. 128 for the
// recipes and _prof_8b.py); the tile walk counts keys, not pages.
//
// This simple design: a block walks its pages in tiles of TILE keys. Each
// thread holds its share of the next tile in registers (16-byte loads: one
// token's [D] row lies at stride KH*D in the pool) while the current tile
// is scored, so one tile's global loads overlap the previous tile's math.
// Scores, the softmax update and P.V run on CUDA cores in f32 from shared
// memory, with each thread computing a small block of outputs so that one
// shared-memory read feeds several FMAs:
//   * decode layout (C*G <= 8 rows, e.g. 7 for Qwen2.5-0.5B, 2 for
//     Gemma-2-2B and 4 for Gemma-3-1B, the rest padding): 8-row blocks
//     over tiles of 16384/D keys (32 KB each of K and V). A thread scores
//     one key against every row; in P.V it accumulates two columns of every
//     row over its own group of keys, and the groups' partial sums are added
//     once at the end.
//   * 64-row layout (chunks, and decode with 8 < C*G <= 64): 64-key tiles;
//     a thread scores 4 rows x 4 keys and accumulates 4 rows x D/16 columns.
//
// Decode split over the keys (flash-decoding). A block's tiles run in
// series, so B x KH one-pass blocks (32 at Gemma-3-1B's 32 sequences and
// one KV head, 64 at Gemma-2-2B's 16 x 4) leave most of the 132 SMs idle
// while each walks thousands of keys (on an H100, 0.52 ms for Gemma-3's
// global layers against a bound of 0.025). The decode entry points take a
// split count, chosen by the caller from the shapes and this kernel's
// occupancy alone (never from start_pos, which lives on the card): with
// splits > 1 a second kernel, paged_attention_split_kernel, runs a grid of
// (B * splits, KH, 1) blocks, and split s walks an equal share, in whole
// tiles, of its (b, h)'s own tile range (the range the window and the
// causal limit leave), writing its unnormalised f32 accumulator and its
// running max m and sum l to a workspace; an empty share writes m = -1e30,
// l = 0, acc = 0. paged_attention_combine then adds the splits in a fixed
// order: out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30),
// M the largest m_s; a split whose keys are all masked for a row carries
// the weight e^(-1e30 - M) = 0 there. The split blocks, two an SM, do more
// per tile than the one-pass ones, with the same rounding points:
//   * decode layout: scores on the tensor cores (mma.sync m16n8k16, bf16 q
//     and K, both exact, f32 sums), q's 8 rows the top half of the A tile
//     and the staged K tile the B operand as it lies ([key][d]);
//   * P.V skips the padding rows.
// With splits == 1 the one-pass kernel above runs as before and no combine.
//
// int8 pools (the `quantized` branch of both TPU kernels; layout of
// ops/kv_quant.py): codes int8 [NB, BS, KH, D] and one float32 scale per
// (block, head, slot), [NB, KH, BS]. The pool type is a template
// parameter of the one kernel. A tile's codes are loaded as int8 (16 to a
// 16-byte load: half the bytes of a bf16 tile) and converted once, exactly,
// to bf16 as they are stored in shared memory, so the math below reads the
// same staged tile as for bf16 pools; the tile's scales come by a second,
// strided load (one key a thread: the scales run [KH, BS] within a block,
// not along the codes). The scales are folded in the TPU kernel's order:
// scores x= s_k[t] after sm_scale and before the softcap; probabilities
// x= s_v[t] after the row sum l and before P.V (paged_attention.py:139-150).
// The split's combine is linear in acc and l, so that order holds.
//
// Left for later PRs: tensor cores in the one-pass and chunk kernels,
// wgmma, TMA/cp.async page streaming, a decode layout narrower than 8
// rows.

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
    const int32_t* __restrict__ chunk_lens,     // [B], or null: every row valid
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
  const int clen = chunk_lens != nullptr ? chunk_lens[b] : C;
  const int32_t* table_row = block_tables + size_t(b) * P;
  // Element offset of query/output row rr of this block, a (c, g) pair.
  auto row_offset = [&](int rr) {
    const int r = r0 + rr;
    const int c = r / G;
    return (size_t(b * C + c) * H + h * G + (r - c * G)) * D;
  };

  if (r0 / G >= clen) {  // every row of this block is chunk padding
    for (int e = tid; e < nrows * D; e += kThreads)
      out[row_offset(e / D) + e % D] = __float2bfloat16(0.f);
    return;
  }

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

  // Pages this block needs: up to its last valid row's causal limit, and
  // with a window, none wholly before start - W + 1 (paged_attention.py
  // :216-227, with the chunk bound taken per row block, not per sequence).
  // Tiles are counted in keys, not pages: a page of BS > TILE keys spans
  // several tiles, and the walk runs from the tile of the first key any row
  // may see to the tile of the last one (load_tile finds each key's page).
  const int c_hi = min((r0 + nrows - 1) / G, clen - 1);
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
    const int32_t* __restrict__ start_pos, const int32_t* __restrict__ chunk_lens,
    __nv_bfloat16* __restrict__ out, int C, int H, int KH, int NB, int BS, int P, int window,
    float sm_scale, float logit_cap) {
  paged_attention_body<POOL, D, ROWS, TILE, false>(q, k_cache, k_scale, v_cache, v_scale,
                                                   block_tables, start_pos, chunk_lens, out,
                                                   nullptr, C, H, KH, NB, BS, P, window,
                                                   sm_scale, logit_cap, 1);
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
                                                  block_tables, start_pos, nullptr, out, part, C,
                                                  H, KH, NB, BS, P, window, sm_scale, logit_cap,
                                                  splits);
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
                   const void* tables, const void* start, const void* clens, void* out,
                   float* part, int B, int C, int H, int KH, int NB, int BS, int P, int window,
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
            qb, kc, ksf, vc, vsf, tb, sp, static_cast<const int32_t*>(clens), ob, C, H, KH, NB,
            BS, P, window, sm_scale, logit_cap);
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
                     const void* vs, const void* tables, const void* start, const void* clens,
                     void* out, float* part, int B, int C, int H, int KH, int NB, int BS, int P,
                     int window, float sm_scale, float logit_cap, int splits, cudaStream_t s) {
  if (small)
    return launch<POOL, D, 8, 16384 / D>(q, k, ks, v, vs, tables, start, clens, out, part, B, C,
                                         H, KH, NB, BS, P, window, sm_scale, logit_cap, splits, s);
  return launch<POOL, D, kMaxRows, 64>(q, k, ks, v, vs, tables, start, clens, out, part, B, C, H,
                                       KH, NB, BS, P, window, sm_scale, logit_cap, splits, s);
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
                     const void* vs, const void* tables, const void* start, const void* clens,
                     void* out, void* part, int B, int C, int H, int KH, int D, int NB, int BS,
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
    return launch_d<POOL, 64>(small, q, k, ks, v, vs, tables, start, clens, out, pf, B, C, H, KH,
                              NB, BS, P, window, sm_scale, logit_cap, splits, s);
  if (D == 128)
    return launch_d<POOL, 128>(small, q, k, ks, v, vs, tables, start, clens, out, pf, B, C, H, KH,
                               NB, BS, P, window, sm_scale, logit_cap, splits, s);
  if (D == 256)
    return launch_d<POOL, 256>(small, q, k, ks, v, vs, tables, start, clens, out, pf, B, C, H, KH,
                               NB, BS, P, window, sm_scale, logit_cap, splits, s);
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
  return dispatch<Bf16Pool>(C * (H / KH) <= 8, q, k, nullptr, v, nullptr, tables, start, nullptr,
                            out, part, B, C, H, KH, D, NB, BS, P, window, sm_scale, logit_cap,
                            splits, stream);
}

extern "C" int paged_attention_chunk_bf16(const void* q, const void* k, const void* v,
                                          const void* tables, const void* start,
                                          const void* chunk_lens, void* out, int B, int C,
                                          int H, int KH, int D, int NB, int BS, int P,
                                          int window, float sm_scale, float logit_cap,
                                          void* stream) {
  if (KH <= 0 || chunk_lens == nullptr) return cudaErrorInvalidValue;
  return dispatch<Bf16Pool>(false, q, k, nullptr, v, nullptr, tables, start, chunk_lens, out,
                            nullptr, B, C, H, KH, D, NB, BS, P, window, sm_scale, logit_cap, 1,
                            stream);
}

// int8 pools: k8/v8 int8 [NB, BS, KH, D], ks/vs float32 [NB, KH, BS].
extern "C" int paged_attention_decode_int8(const void* q, const void* k8, const void* ks,
                                           const void* v8, const void* vs, const void* tables,
                                           const void* start, void* out, void* part, int B, int C,
                                           int H, int KH, int D, int NB, int BS, int P,
                                           int window, float sm_scale, float logit_cap,
                                           int splits, void* stream) {
  if (KH <= 0 || C * (H / KH) > kMaxRows) return cudaErrorInvalidValue;
  return dispatch<Int8Pool>(C * (H / KH) <= 8, q, k8, ks, v8, vs, tables, start, nullptr, out,
                            part, B, C, H, KH, D, NB, BS, P, window, sm_scale, logit_cap, splits,
                            stream);
}

extern "C" int paged_attention_chunk_int8(const void* q, const void* k8, const void* ks,
                                          const void* v8, const void* vs, const void* tables,
                                          const void* start, const void* chunk_lens, void* out,
                                          int B, int C, int H, int KH, int D, int NB, int BS,
                                          int P, int window, float sm_scale, float logit_cap,
                                          void* stream) {
  if (KH <= 0 || chunk_lens == nullptr) return cudaErrorInvalidValue;
  return dispatch<Int8Pool>(false, q, k8, ks, v8, vs, tables, start, chunk_lens, out, nullptr, B,
                            C, H, KH, D, NB, BS, P, window, sm_scale, logit_cap, 1, stream);
}
