// Decode attention with bf16 operands and bf16 probabilities over a bf16
// block pool, for Hopper (sm_90a): the two TPU prototypes of _prof_attn.py,
// which compute one function in two work splits.
//
//   * decode_packed  <- decode_packed (_prof_attn.py:113, body
//     _decode_kernel_packed :22). A thread block holds all R = KH*G query
//     rows of one sequence (and one split of its keys); each staged key row
//     carries every KV head. The TPU kernel packs the rows block-diagonally
//     so that a page's scores are one MXU product [bs, KH*D] x [KH*D, R];
//     that packing multiplies by zero blocks to suit the MXU and is not
//     copied: here each head's keys meet that head's G rows only.
//   * decode_bf16    <- decode_bf16 (_prof_attn.py:312, body
//     _decode_kernel_bf16 :244). A thread block holds the G rows of one
//     (sequence, KV head), and one split of its keys.
//
// Both keep the prototypes' rounding points (the serving kernels of
// csrc/paged_attention.cu keep f32 probabilities instead): q and K/V are
// bf16 and every product is exact in f32; scores are f32, times sm_scale,
// then the optional softcap cap*tanh(s/cap), then key t is visible iff
// t <= start (and t > start - W with a window W > 0), else -1e30 (finite:
// an all-masked step stays finite and is wiped by the next alpha = 0). An
// online softmax over steps of 16 keys: m, alpha = exp(m_old - m_new),
// probabilities exp(s - m_new) rounded to bf16, the row sum l taken over the
// ROUNDED probabilities, acc = acc*alpha + P.V with the bf16 probabilities;
// out = bf16(acc / max(l, 1e-30)). The plain version is
// ops/attention.decode_attention_bf16_ref (one global max, so the bf16
// roundings of the probabilities fall at other points: the two agree within
// a bf16 step of the output); ops/attention.decode_attention_bf16_split_ref
// emulates this kernel's walk, shares and combines on the CPU.
//
// What bounds it on the card: each live K/V byte is read once (2 * keys *
// KH * D * 2 bytes a sequence) for ~2 flops a byte a query row, far under
// the H100's ~295 bf16 flops a byte: the floor is the memory rate (3.35
// TB/s, ~25 GB/s an SM). At ~1 us of memory latency an SM needs ~25-32 KB
// in flight, so the design is about bytes in flight.
//
// Design.
//   * Work: warp w of a block owns head w % NH of its NH heads (NH = KH for
//     decode_packed, 1 for decode_bf16) and key group w / NH of KG; a tile
//     of the walk is SK = 16*KG keys, group kg its keys 16kg .. 16kg+15.
//     KG = max(1, 4 / NH): 8 warps a block at Llama-3-8B's KH 8 (packed), 4
//     at Gemma-2's KH 4 and for decode_bf16 (64-key tiles).
//   * Both products on the tensor cores, mma.sync m16n8k16, bf16 operands,
//     f32 sums, keys on the M side (the TPU kernel's key-major [bs, R]):
//       scores  S^T[16 keys, 8] = K[16 keys, D] . Q^T[D, 8]: the staged key
//               rows are the A operand as they lie (ldmatrix), the head's G
//               query rows (padded with zeros to 8) the B operand, held in
//               registers for the whole walk (loaded once from global);
//       P.V     acc^T[D, 8] += V^T[D, 16 keys] . P^T[16 keys, 8]: V as it
//               lies ([key][d], by ldmatrix.trans) is the A operand, the
//               bf16 probabilities the B operand. The score accumulator's
//               8x8 halves (keys x rows) are the transposes of P's B
//               fragments, so each is moved by one movmatrix.trans in
//               registers: no shared tile of P.
//     acc^T's columns are the score accumulator's (rows 2(lane%4) + {0, 1}),
//     so the online softmax (max reduced over the 8 lanes sharing a row, l
//     kept per lane and reduced once at the end) and alpha stay in
//     registers.
//   * Staging: a ring of kSlots = 3 shared-memory slots, each the K or the
//     V rows of one tile (SK keys x NH*D values), filled by the copy engine
//     through a 2-D tensor map over the pool as [NB*BS key rows, KH*D]:
//     boxes of 16 keys (the block size, if smaller; a box never crosses a
//     page) x 64 values, one a (key run, 128-byte chunk of the block's
//     heads), 128-byte swizzled so that ldmatrix over 8 keys at one column
//     reads 8 banks. A box with no visible key, or on a page whose table
//     entry is out of range, is given a row past the tensor and reads as
//     zeros, so no stale or uninitialised value meets a zero probability in
//     P.V; rows of masked keys inside a visible box are read as they are.
//     Warp 0 issues a slot's boxes, counted on its mbarrier; the ring runs
//     K0, V0, K1, V1, ..., and a slot is refilled as soon as every warp has
//     read it (one __syncthreads a slot), so two slots are in flight: 32 KB
//     each at Llama-3-8B's packed rows (2 KB a key, two blocks an SM), 16 KB
//     for decode_bf16 at D 128 (64 keys x 256 bytes, four blocks an SM).
//   * Key split (flash-decoding): the block's tile range, from the tile of
//     its first visible key (start - W + 1 with a window) to that of
//     `start`, is cut into `splits` equal shares of whole tiles, split s of
//     (sequence, head set) taking blockIdx.x = b*splits + s. The caller
//     chooses `splits` from the shapes and this kernel's occupancy alone
//     (decode_attention_proto_capacity), never from start_pos. In the
//     block, the KG key groups of a head are added in order through shared
//     memory (with one group a head, each warp writes from its registers).
//     With splits > 1 the block writes f32 (m, l, acc) partials to a
//     workspace and decode_attention_proto_combine adds the splits in
//     order 0, 1, ... (8 rows a block: the rows' weights once, then float4
//     pieces; no atomics: runs repeat bit for bit). An empty share
//     carries (m = -1e30, l = 0, acc = 0), and a share whose keys are all
//     masked for a row the weight e^(-1e30 - M) = 0.
//
// The tensor maps need 16-byte aligned pools (checked) and rows of KH*D*2
// bytes, a multiple of 16; D a multiple of 64 keeps a head's chunks whole.

#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <tuple>
#include <unordered_map>

#include "int8_gemv.cuh"  // ldmatrix_x4, ldmatrix_x4_trans, mma_bf16

namespace {

using int8_gemv::ldmatrix_x4;
using int8_gemv::ldmatrix_x4_trans;
using int8_gemv::mma_bf16;

constexpr int kMaxG = 8;         // query rows of a KV head: the mma's N
constexpr int kMaxRows = 64;     // query rows of one decode_packed block
constexpr int kMaxWidth = 2048;  // heads a block x D
constexpr int kStep = 16;        // keys a warp takes at a time: the mma's M and P.V's k
constexpr int kSlots = 3;        // the ring: K and V of a tile, and the next tile's K
constexpr int kBoxKeys = 16;     // keys a box of the copy engine, at most
constexpr int kChunk = 64;       // values a box row: 128 bytes, the swizzle's span
constexpr int kAlign = 1024;     // the 128-byte swizzle's period: slots start on it
constexpr int kMaxSplits = 16;
constexpr float kNegInf = -1e30f;

// A block's geometry: heads, key groups, warps, tile keys, 128-byte chunks
// of a key's row, keys a box and its bytes, and a slot's bytes.
struct Geometry {
  int NH, KG, NW, SK, NCH, box_keys, box_bytes, slot_bytes;
  __host__ __device__ Geometry(bool packed, int KH, int D, int BS) {
    NH = packed ? KH : 1;
    KG = NH >= 4 ? 1 : 4 / NH;
    NW = NH * KG;
    SK = kStep * KG;
    NCH = NH * D / kChunk;
    box_keys = BS < kBoxKeys ? BS : kBoxKeys;
    box_bytes = box_keys * 128;
    slot_bytes = SK * NH * D * 2;
  }
  __host__ __device__ size_t smem() const { return size_t(kAlign) + size_t(kSlots) * slot_bytes; }
  // Byte offset in a slot of value `col` (a multiple of 8) of the slot's key
  // row r, given line0(r): box (r / box_keys, col / 64) holds box_keys lines
  // of 128 bytes, and the 16-byte piece u of a line sits at u ^ (line % 8)
  // (the 128-byte swizzle of the shared-memory address; slots start on
  // 1,024 bytes).
  __device__ __forceinline__ int line0(int r) const {
    return (r / box_keys) * NCH * box_keys + r % box_keys;
  }
  __device__ __forceinline__ int offset(int line0_r, int col) const {
    const int line = line0_r + (col / kChunk) * box_keys;
    return line * 128 + ((((col / 8) % 8) ^ (line % 8)) << 4);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// Arrive on `bar`, announcing `bytes` that copies will bring.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Box (x0, y0) of a tensor map into `dst` by the copy engine (rows past
// the tensor read as zeros), counted on `bar`.
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, int x0, int y0,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(y0), "r"(smem_addr(bar))
      : "memory");
}
// The transpose of an 8x8 b16 matrix held as mma fragments (lane l: row
// l/4, columns 2(l%4), 2(l%4)+1).
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// Warp 0: the K (or V) rows of tile `tile` of the block's heads into
// `slot`, one box a (key run, chunk), all counted on `bar`. A box holding
// no visible key, or on a page whose table entry is out of range, reads the
// row past the tensor: zeros.
__device__ __forceinline__ void issue_slot(unsigned char* slot, uint64_t* bar,
                                           const CUtensorMap* map,
                                           const int32_t* __restrict__ table_row, int tile,
                                           const Geometry& L, int first_key, int last_key, int NB,
                                           int BS, int h0, int D, int lane) {
  const int k0 = tile * L.SK;
  if (lane == 0) mbar_arrive_expect(bar, uint32_t(L.slot_bytes));
  __syncwarp();
  for (int i = lane; i < (L.SK / L.box_keys) * L.NCH; i += 32) {
    const int kp = k0 + (i / L.NCH) * L.box_keys;  // the box's first key
    int row = NB * BS;
    if (kp + L.box_keys - 1 >= first_key && kp <= last_key) {
      const int blk = table_row[kp / BS];
      if (blk >= 0 && blk < NB) row = blk * BS + kp % BS;
    }
    load_box(slot + i * L.box_bytes, map, h0 * D + kChunk * (i % L.NCH), row, bar);
  }
}

// Grid (B * splits, KH / NH), 32 * NW threads. With splits == 1 the block
// writes its rows of out; otherwise its partials into `part`: acc
// [splits][B*H][D], then (m, l) [splits][B*H][2], f32. Launch bounds:
// decode_packed up to 16 warps at D 128 and 8 at D 256 (KH x D <= 2,048);
// decode_bf16 four warps, four blocks an SM at D 128 (at most 128
// registers: B 64 x KH 8's 512 blocks in one wave), two at D 256.
template <int D, bool PACKED>
__global__ void __launch_bounds__(PACKED ? 32 * (kMaxWidth / D) : 128,
                                  PACKED ? 1 : (D == 128 ? 4 : 2))
    decode_attention_proto_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, 1, H, D]
    const __grid_constant__ CUtensorMap kmap,  // k_cache [NB, BS, KH, D] as [NB*BS, KH*D]
    const __grid_constant__ CUtensorMap vmap,  // v_cache, the same
    const int32_t* __restrict__ block_tables,  // [B, P]
    const int32_t* __restrict__ start_pos,     // [B]
    __nv_bfloat16* __restrict__ out,           // [B, 1, H, D]
    float* __restrict__ part, int H, int KH, int NB, int BS, int P, int window,
    float sm_scale, float logit_cap, int splits) {
  constexpr int kSteps = D / 16;  // 16-deep k-steps of a score, 16-row m-tiles of P.V
  const Geometry L(PACKED, KH, D, BS);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t full[kSlots];
  unsigned char* ring = smem_raw + (kAlign - smem_addr(smem_raw) % kAlign) % kAlign;

  const int G = H / KH;
  const int b = blockIdx.x / splits;
  const int split = blockIdx.x % splits;
  const int h0 = blockIdx.y * L.NH;  // the block's first KV head
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int hh = warp % L.NH;  // the warp's head in the block
  const int kg = warp / L.NH;  // its key group in a tile
  const int start = start_pos[b];
  const int32_t* table_row = block_tables + size_t(b) * P;
  const size_t row0 = (size_t(b) * H + size_t(h0) * G) * D;  // q/out offset of the block's row 0

  // The walk: tiles from the first visible key's to the last's; this
  // split's equal share of them, whole tiles (may be empty).
  const int first_key = window > 0 ? max(start - window + 1, 0) : 0;
  const int last_key = min(start, P * BS - 1);
  const int tile_first = first_key / L.SK;
  const int n_all = last_key >= first_key ? last_key / L.SK - tile_first + 1 : 0;
  const int t0 = tile_first + split * n_all / splits;
  const int n_tiles = tile_first + (split + 1) * n_all / splits - t0;
  const int n_half = 2 * n_tiles;  // ring entries: K and V of each tile

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&kmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&vmap)) : "memory");
    for (int s = 0; s < kSlots; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int h) {
    issue_slot(ring + size_t(h % kSlots) * L.slot_bytes, full + h % kSlots,
               h & 1 ? &vmap : &kmap, table_row, t0 + h / 2, L, first_key, last_key, NB, BS, h0,
               D, lane);
  };
  if (warp == 0)
    for (int h = 0; h < min(kSlots, n_half); ++h) issue(h);

  // q's B fragments for the whole walk: row g = lane/4 of the warp's head
  // (zero past G), d = 16 ks + 2 (lane % 4) + {0, 1} and + 8.
  uint32_t qf[kSteps][2];
  {
    const int g = lane / 4;
    const __nv_bfloat16* qrow = q + row0 + size_t(hh * G + min(g, G - 1)) * D + 2 * (lane % 4);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      qf[ks][0] = g < G ? __ldg(reinterpret_cast<const uint32_t*>(qrow + 16 * ks)) : 0u;
      qf[ks][1] = g < G ? __ldg(reinterpret_cast<const uint32_t*>(qrow + 16 * ks + 8)) : 0u;
    }
  }
  // The warp's state for rows 2 (lane % 4) and 2 (lane % 4) + 1: max m,
  // this lane's part of the sum l, acc^T [D, 8] as kSteps m-tiles.
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[kSteps][4];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // ldmatrix rows of the warp's 16 keys: K (A, as it lies) key lane%8 +
  // 8 ((lane/8)%2) at d 8 (lane/16); V (A by .trans) key lane%8 + 8 (lane/16)
  // at d 8 ((lane/8)%2); both in the warp's head's columns.
  const int k_line = L.line0(kg * kStep + lane % 8 + 8 * ((lane / 8) % 2));
  const int k_col = hh * D + 8 * (lane / 16);
  const int v_line = L.line0(kg * kStep + lane % 8 + 8 * (lane / 16));
  const int v_col = hh * D + 8 * ((lane / 8) % 2);

  for (int it = 0; it < n_tiles; ++it) {
    const int hk = 2 * it;
    mbar_wait(full + hk % kSlots, (hk / kSlots) & 1);
    const unsigned char* kslot = ring + size_t(hk % kSlots) * L.slot_bytes;
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < kSteps; ks += 2) {  // two chains of sums: half the latency
      uint32_t a[4];
      ldmatrix_x4(a, kslot + L.offset(k_line, k_col + 16 * ks));
      mma_bf16(c0, a, qf[ks][0], qf[ks][1]);
      ldmatrix_x4(a, kslot + L.offset(k_line, k_col + 16 * ks + 16));
      mma_bf16(c1, a, qf[ks + 1][0], qf[ks + 1][1]);
    }
    // c[e]: key (it's tile) 16 kg + lane/4 (+ 8 for e >= 2), row 2 (lane%4) + e%2
    const int key = (t0 + it) * L.SK + kg * kStep + lane / 4;
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = (c0[e] + c1[e]) * sm_scale;
      if (logit_cap > 0.f) x = logit_cap * tanhf(x / logit_cap);
      const int kp = key + (e >= 2 ? 8 : 0);
      s[e] = kp >= first_key && kp <= last_key ? x : kNegInf;
    }
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
    __nv_bfloat16 p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = __float2bfloat16(expf(s[e] - m[e % 2]));
#pragma unroll
    for (int j = 0; j < 2; ++j)
      l[j] = l[j] * alpha[j] + __bfloat162float(p[j]) + __bfloat162float(p[j + 2]);
    const uint32_t pb0 = movmatrix_trans(pack_bf16(p[0], p[1]));  // keys 0-7
    const uint32_t pb1 = movmatrix_trans(pack_bf16(p[2], p[3]));  // keys 8-15
    __syncthreads();  // every warp has read this K slot
    if (warp == 0 && hk + kSlots < n_half) issue(hk + kSlots);

    const int hv = hk + 1;
    mbar_wait(full + hv % kSlots, (hv / kSlots) & 1);
    const unsigned char* vslot = ring + size_t(hv % kSlots) * L.slot_bytes;
#pragma unroll
    for (int mt = 0; mt < kSteps; ++mt) {
      acc[mt][0] *= alpha[0];
      acc[mt][1] *= alpha[1];
      acc[mt][2] *= alpha[0];
      acc[mt][3] *= alpha[1];
      uint32_t a[4];
      ldmatrix_x4_trans(a, vslot + L.offset(v_line, v_col + 16 * mt));
      mma_bf16(acc[mt], a, pb0, pb1);
    }
    __syncthreads();  // every warp has read this V slot
    if (warp == 0 && hv + kSlots < n_half) issue(hv + kSlots);
  }

#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], o);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], o);
  }
  const size_t n_out = size_t(gridDim.x / splits) * H * D;  // B*H*D
  float* part_acc = part + size_t(split) * n_out;         // this split's partials
  float* part_ml = part + size_t(splits) * n_out + size_t(split) * (n_out / D) * 2;
  if (L.KG == 1) {
    // One key group a head: the warp's rows as they are, from registers —
    // out, or this split's partials.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int g = 2 * (lane % 4) + j;
      if (g >= G) continue;
      const size_t row = row0 + size_t(hh * G + g) * D;  // element offset of the row
#pragma unroll
      for (int mt = 0; mt < kSteps; ++mt) {
        const int d = 16 * mt + lane / 4;
        if (splits == 1) {
          const float den = fmaxf(l[j], 1e-30f);
          out[row + d] = __float2bfloat16(acc[mt][j] / den);
          out[row + d + 8] = __float2bfloat16(acc[mt][j + 2] / den);
        } else {
          part_acc[row + d] = acc[mt][j];
          part_acc[row + d + 8] = acc[mt][j + 2];
        }
      }
      if (splits > 1 && lane < 4) {
        part_ml[row / D * 2] = m[j];
        part_ml[row / D * 2 + 1] = l[j];
      }
    }
  } else {
    // The warp's state into the idle ring (every copy has landed and been
    // read): acc^T as [8 rows][D + 4] (padded: conflict-free stores), then m
    // [8] and l [8]; then each (head, row, d) of the block adds its key
    // groups in order kg = 0, 1, ...
    constexpr int kAccStride = D + 4;
    constexpr int kWarpFloats = 8 * kAccStride + 16;
    float* states = reinterpret_cast<float*>(ring);
    __syncthreads();
    {
      float* st = states + warp * kWarpFloats;
      const int r = 2 * (lane % 4);
#pragma unroll
      for (int mt = 0; mt < kSteps; ++mt) {
        const int d = 16 * mt + lane / 4;
        st[r * kAccStride + d] = acc[mt][0];
        st[(r + 1) * kAccStride + d] = acc[mt][1];
        st[r * kAccStride + d + 8] = acc[mt][2];
        st[(r + 1) * kAccStride + d + 8] = acc[mt][3];
      }
      if (lane < 4) {
        st[8 * kAccStride + r] = m[0];
        st[8 * kAccStride + r + 1] = m[1];
        st[8 * kAccStride + 8 + r] = l[0];
        st[8 * kAccStride + 8 + r + 1] = l[1];
      }
    }
    __syncthreads();
    for (int e = tid; e < L.NH * G * D; e += blockDim.x) {
      const int hd = e / (G * D);
      const int g = (e / D) % G;
      const int d = e % D;
      float M = kNegInf;
      for (int j = 0; j < L.KG; ++j)
        M = fmaxf(M, states[(j * L.NH + hd) * kWarpFloats + 8 * kAccStride + g]);
      float A = 0.f, Lsum = 0.f;
      for (int j = 0; j < L.KG; ++j) {
        const float* sj = states + (j * L.NH + hd) * kWarpFloats;
        const float w = expf(sj[8 * kAccStride + g] - M);
        A += w * sj[g * kAccStride + d];
        Lsum += w * sj[8 * kAccStride + 8 + g];
      }
      if (splits == 1) {
        out[row0 + e] = __float2bfloat16(A / fmaxf(Lsum, 1e-30f));
      } else {
        part_acc[row0 + e] = A;
        if (d == 0) {
          part_ml[(row0 + e) / D * 2] = M;
          part_ml[(row0 + e) / D * 2 + 1] = Lsum;
        }
      }
    }
  }
}

// The splits' partials into bf16 out [B, 1, H, D] (`rows` = B*H), kRowsPB
// rows a block: each row's split weights e^(m_s - M) and sum once, then
// float4 pieces of the rows adding the splits in order 0, 1, ... (no
// atomics: runs repeat bit for bit).
constexpr int kRowsPB = 8;
__global__ void __launch_bounds__(256)
    decode_attention_proto_combine(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                                   int rows, int D, int splits) {
  __shared__ float w[kMaxSplits][kRowsPB];
  __shared__ float den[kRowsPB];
  const size_t n_out = size_t(rows) * D;
  const int r0 = blockIdx.x * kRowsPB;
  if (threadIdx.x < kRowsPB && r0 + int(threadIdx.x) < rows) {
    const float* ml = part + size_t(splits) * n_out + size_t(r0 + threadIdx.x) * 2;
    float m[kMaxSplits], l[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < splits) {
        m[s] = ml[size_t(s) * rows * 2];
        l[s] = ml[size_t(s) * rows * 2 + 1];
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits) mx = fmaxf(mx, m[s]);
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < splits) {
        w[s][threadIdx.x] = expf(m[s] - mx);
        sum += w[s][threadIdx.x] * l[s];
      }
    }
    den[threadIdx.x] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  const int per_row = D / 4;
  for (int it = threadIdx.x; it < kRowsPB * per_row; it += blockDim.x) {
    const int rr = it / per_row;
    if (r0 + rr >= rows) break;
    const size_t e = size_t(r0 + rr) * D + (it % per_row) * 4;
    float4 a[kMaxSplits];  // every split's loads issued before any is used
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits) a[s] = *reinterpret_cast<const float4*>(part + size_t(s) * n_out + e);
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < splits) {
        const float ws = w[s][rr];
        num.x += ws * a[s].x;
        num.y += ws * a[s].y;
        num.z += ws * a[s].z;
        num.w += ws * a[s].w;
      }
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + e);
    o[0] = __floats2bfloat162_rn(num.x / den[rr], num.y / den[rr]);
    o[1] = __floats2bfloat162_rn(num.z / den[rr], num.w / den[rr]);
  }
}

// The copy engine's view of a pool [NB, BS, KH, D]: a 2-D tensor of
// NB*BS rows x KH*D values, boxes of box_keys rows x 64 values, 128-byte
// swizzle, zeros past its edges. The encoder is the driver's, fetched at
// run time; maps are kept by (address, shape, box), so a pool's is made
// once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t pool_map(const void* base, int rows, int cols, int box_keys, CUtensorMap* out) {
  using Key = std::tuple<const void*, int, int, int>;
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(std::get<0>(k)) ^ (size_t(std::get<1>(k)) << 1) ^
             (size_t(std::get<2>(k)) << 33) ^ (size_t(std::get<3>(k)) << 50);
    }
  };
  static std::mutex mu;
  static EncodeTiled encode = nullptr;
  static std::unordered_map<Key, CUtensorMap, Hash> maps;
  std::lock_guard<std::mutex> lock(mu);
  const Key key(base, rows, cols, box_keys);
  auto it = maps.find(key);
  if (it != maps.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 2};  // bytes between key rows
  const cuuint32_t box[2] = {cuuint32_t(kChunk), cuuint32_t(box_keys)};
  const cuuint32_t unit[2] = {1, 1};
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (maps.size() >= 4096) maps.clear();
  maps.emplace(key, map);
  *out = map;
  return cudaSuccess;
}

template <int D, bool PACKED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tables,
                   const void* start, void* out, void* part, int B, int H, int KH, int NB,
                   int BS, int P, int window, float sm_scale, float logit_cap, int splits,
                   cudaStream_t stream) {
  const Geometry L(PACKED, KH, D, BS);
  CUtensorMap kmap, vmap;
  cudaError_t err = pool_map(k, NB * BS, KH * D, L.box_keys, &kmap);
  if (err == cudaSuccess) err = pool_map(v, NB * BS, KH * D, L.box_keys, &vmap);
  if (err != cudaSuccess) return err;
  const auto kernel = decode_attention_proto_kernel<D, PACKED>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.smem()));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * splits, KH / L.NH), 32 * L.NW, L.smem(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), kmap, vmap, static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(start), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), H, KH, NB, BS, P, window, sm_scale, logit_cap, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int rows = B * H;
  decode_attention_proto_combine<<<(rows + kRowsPB - 1) / kRowsPB, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), rows, D, splits);
  return cudaGetLastError();
}

// Blocks of one instantiation the card holds at once for KH heads: SMs x
// blocks an SM at its registers and shared memory (0 if a query fails).
template <int D, bool PACKED>
int capacity(int KH) {
  const Geometry L(PACKED, KH, D, kBoxKeys);
  const auto kernel = decode_attention_proto_kernel<D, PACKED>;
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.smem())) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * L.NW, L.smem()) ||
      cudaGetDevice(&dev) || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return 0;
  return per_sm * sms;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool PACKED>
int dispatch(const void* q, const void* k, const void* v, const void* tables, const void* start,
             void* out, void* part, int B, int H, int KH, int D, int NB, int BS, int P,
             int window, float sm_scale, float logit_cap, int splits, void* stream) {
  const bool bs_ok = BS > 0 && (64 % BS == 0 || (BS % 64 == 0 && BS <= 256));
  if (B <= 0 || KH <= 0 || H % KH != 0 || !bs_ok || P <= 0 || NB <= 0)
    return cudaErrorInvalidValue;
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v)) return cudaErrorInvalidValue;
  const int G = H / KH;
  const int NH = PACKED ? KH : 1;
  if (G > kMaxG || NH * G > kMaxRows || NH * D > kMaxWidth) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Built for head_dim 128 (Llama-3-8B) and 256 (Gemma-2-2B, Gemma-3-1B).
  if (D == 128)
    return launch<128, PACKED>(q, k, v, tables, start, out, part, B, H, KH, NB, BS, P, window,
                               sm_scale, logit_cap, splits, s);
  if (D == 256)
    return launch<256, PACKED>(q, k, v, tables, start, out, part, B, H, KH, NB, BS, P, window,
                               sm_scale, logit_cap, splits, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Blocks of decode_packed (packed = 1) or decode_bf16 resident at once on
// the current card for KH heads at head_dim D: the capacity the caller's
// split count assumes (0 if the card cannot be asked).
extern "C" int decode_attention_proto_capacity(int packed, int KH, int D) {
  if (KH <= 0 || (packed && KH * D > kMaxWidth)) return 0;
  if (D == 128) return packed ? capacity<128, true>(KH) : capacity<128, false>(KH);
  if (D == 256) return packed ? capacity<256, true>(KH) : capacity<256, false>(KH);
  return 0;
}

// q [B, 1, H, D] bf16; pools [NB, BS, KH, D] bf16; tables [B, P] and
// start [B] int32; out [B, 1, H, D] bf16; `splits` key splits (1..16) and,
// for splits > 1, `part`: a float32 workspace of splits * B*H * (D + 2)
// values. Each returns cudaGetLastError() after its launches (0 = launched).
extern "C" int decode_packed(const void* q, const void* k, const void* v, const void* tables,
                             const void* start, void* out, void* part, int B, int H, int KH,
                             int D, int NB, int BS, int P, int window, float sm_scale,
                             float logit_cap, int splits, void* stream) {
  return dispatch<true>(q, k, v, tables, start, out, part, B, H, KH, D, NB, BS, P, window,
                        sm_scale, logit_cap, splits, stream);
}

extern "C" int decode_bf16(const void* q, const void* k, const void* v, const void* tables,
                           const void* start, void* out, void* part, int B, int H, int KH, int D,
                           int NB, int BS, int P, int window, float sm_scale, float logit_cap,
                           int splits, void* stream) {
  return dispatch<false>(q, k, v, tables, start, out, part, B, H, KH, D, NB, BS, P, window,
                         sm_scale, logit_cap, splits, stream);
}
