// The int8 weight-streaming core that the int8 product (int8_matmul.cu),
// the prototype int8 FFN (ffn_int8.cu) and the fused decoder layer
// (fused_layer.cu) share, for Hopper (sm_90a):
//
//   * mbarriers and 2-D tensor copies (cp.async.bulk.tensor) from device
//     memory into shared memory, counted on a stage's mbarrier;
//   * a ring of stages shared by one producer thread, which issues a
//     stage's copies once the consumer warps have released it, and the
//     consumer warps, which wait for a stage to land (Ring);
//   * the B fragments of mma.sync m16n8k16 built from staged int8 codes on
//     the way to the tensor cores (codes_to_bf16x2, kstep), every product
//     of a bf16 activation and a code exact, summed in f32;
//   * the host's tensor maps (encoder fetched from the driver at run time,
//     maps kept by address and shape: a weight's is made once);
//   * stream_kernel, the streaming product itself: 128-column tiles, a
//     ring of four 128-deep chunks of codes filled by tensor copies from a
//     producer warp, x staged once a block, K split over the blocks of one
//     thread block cluster and summed through distributed shared memory in
//     split order. Its epilogues: the f32 sums; qeinsum's bf16(bf16(sum) *
//     s); bf16(sum * s); and, with two weight matrices side by side in each
//     stage, bf16(silu(g * sg) * (u * su)).
//
// A staged chunk of codes is one box of 128 k rows x 128 columns (128
// bytes), 128-byte swizzled: the 16-byte piece j of row r lies at j ^ (r %
// 8). Thread (g, t) = (lane / 4, lane % 4) of a warp that owns the 32
// columns cq .. cq + 31 reads 4-byte words (four columns of one k row):
// rows 2t + {0, 1, 8, 9} of a k-step, columns cq + 4g .. + 3. One byte
// permute pairs the k rows (2t, 2t + 1) a fragment register wants, and two
// logic ops and a bf16x2 subtraction make the pair exact bf16. The n8 tile
// i's column g is the tile's column 4g + i, so a thread's accumulators hold
// 8 consecutive output columns of a row: tile i's c0/c2 at column 8t + i,
// its c1/c3 at 8t + 4 + i (rows g and g + 8).

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <tuple>
#include <unordered_map>

namespace int8_stream {

namespace cg = cooperative_groups;

constexpr int kRows = 16;                // rows a group: the mma's M
constexpr int kMaxGroups = 4;            // 64 rows a block
constexpr int kTileN = 128;              // output columns a block
constexpr int kChunkK = 128;             // k rows a stage
constexpr int kCodeBytes = kChunkK * kTileN;  // one matrix's codes of a chunk: 16 KB
constexpr int kAlign = 1024;             // the 128-byte swizzle's period
constexpr int kMaxSplits = 8;            // a cluster's blocks, at most (the portable size)

// -- shared memory, mbarriers, tensor copies ----------------------------------

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
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Arrive on `bar`, announcing `bytes` that copies will bring.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// One box of a tensor map at coordinates (x0 along the contiguous axis, y0
// along rows) into `dst` by the copy engine (out of bounds reads as zero),
// counted on `bar`.
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, int x0, int y0,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(y0), "r"(smem_addr(bar))
      : "memory");
}
// Shared memory written by threads is next written by the copy engine: order
// the two (before a stage that threads wrote or read is refilled).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- the ring -------------------------------------------------------------------

// S stages between one producer thread and `consumers` warps. Position c
// (the c-th stage filled since init) uses stage c % S in round c / S; the
// producer and the consumers count positions the same way. full[s] takes
// one arrival with the stage's bytes; empty[s] one arrival a consumer warp.
template <int S>
struct Ring {
  uint64_t full[S];
  uint64_t empty[S];
  __device__ __forceinline__ void init(int consumers) {  // one thread, then a block barrier
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The producer: position c's stage is free (its round-earlier use released).
  __device__ __forceinline__ void acquire(int c) {
    if (c >= S) mbar_wait(empty + c % S, (c / S - 1) & 1);
  }
  __device__ __forceinline__ uint64_t* bar(int c) { return full + c % S; }
  // A consumer warp: position c's copies have landed.
  __device__ __forceinline__ void wait(int c) { mbar_wait(full + c % S, (c / S) & 1); }
  // A consumer warp is done with position c's stage.
  __device__ __forceinline__ void release(int c, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + c % S);
  }
};

// -- codes to fragments ---------------------------------------------------------

// Two int8 codes, the low bytes of the halves of t, -> bf16x2, exactly. A
// code c = L - 128 s (L its low 7 bits, s its sign bit) is the difference
// of two bf16 values whose bits are made by one logic op each:
// X = 0x4300 | L (128 + L) and Y = 0x4300 | (s << 7) (128, or 256 where
// c < 0); X - Y is exact (|c| <= 127), so a pair takes a byte permute, two
// logic ops and one bf16x2 subtraction.
__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t t) {
  const uint32_t xb = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t yb = (t & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&xb),
                                   *reinterpret_cast<const __nv_bfloat162*>(&yb));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// Thread (g, t)'s offsets into a staged chunk for a warp owning the
// columns cq .. cq + 31, and into x's 128B-swizzled slice (ldmatrix rows
// lane % 16 of a group at k offset 8 (lane / 16) of a k-step: the 16-byte
// piece j of row r at j ^ (r % 8)).
struct Frags {
  int sw0, sw1, a_row, a_swz, t, hi;
  __device__ __forceinline__ Frags(int cq, int lane) {
    const int g = lane / 4;
    t = lane % 4;
    const int piece = cq / 16 + g / 4;
    sw0 = ((piece ^ ((2 * t) & 7)) << 4) + (g % 4) * 4;      // rows 2t, 2t + 8
    sw1 = ((piece ^ ((2 * t + 1) & 7)) << 4) + (g % 4) * 4;  // rows 2t + 1, 2t + 9
    a_row = (lane % 16) * 128;
    a_swz = lane & 7;
    hi = lane / 16;
  }
};

// k-step ks (0..7) of a staged chunk: the B fragments of the warp's four n8
// tiles from its codes, times every 16-row group of x's slice (two halves
// of `x_half` bytes: k 0-63 and 64-127), into acc[group][tile].
template <int RG>
__device__ __forceinline__ void kstep(float (&acc)[RG][4][4], const unsigned char* codes,
                                      const unsigned char* xc, int x_half, int ks,
                                      const Frags& f) {
  // B fragments of the four n8 tiles: rows 2t, 2t + 1 (b0) and 2t + 8,
  // 2t + 9 (b1) of the k-step, columns cq + 4g .. cq + 4g + 3
  const unsigned char* wr = codes + (ks * 16 + 2 * f.t) * kTileN;
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr + f.sw0);
  const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + kTileN + f.sw1);
  const uint32_t w8 = *reinterpret_cast<const uint32_t*>(wr + 8 * kTileN + f.sw0);
  const uint32_t w9 = *reinterpret_cast<const uint32_t*>(wr + 9 * kTileN + f.sw1);
  // tile i's fragment pairs byte i of rows 2t and 2t + 1 (b0), of rows
  // 2t + 8 and 2t + 9 (b1)
  uint32_t b0[4], b1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t sel = i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12);
    b0[i] = codes_to_bf16x2(__byte_perm(w0, w1, sel));
    b1[i] = codes_to_bf16x2(__byte_perm(w8, w9, sel));
  }
  // k-step ks: half ks / 4 of the slice, piece (2 ks + lane / 16) % 8
  const unsigned char* xk = xc + (ks / 4) * x_half + f.a_row +
                            ((((2 * ks + f.hi) & 7) ^ f.a_swz) << 4);
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    uint32_t a[4];
    ldmatrix_x4(a, xk + r * kRows * 128);
#pragma unroll
    for (int i = 0; i < 4; ++i) mma_bf16(acc[r][i], a, b0[i], b1[i]);
  }
}

// Rows g + 8 half of group r of a warp's sums, 8 consecutive columns
// (cq + 8t .. + 7).
template <int RG>
__device__ __forceinline__ void row_sums(const float (&acc)[RG][4][4], int r, int half,
                                         float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = acc[r][i][2 * half];
    v[4 + i] = acc[r][i][2 * half + 1];
  }
}

// -- tensor maps (host) ------------------------------------------------------------

// A row-major 2-D array of `rows` x `cols` elements for the copy engine:
// boxes of box_rows x box_cols, 128-byte swizzle (box_cols x elem_bytes =
// 128; `swizzle` false: none, for boxes of fewer than 8 rows, which the
// swizzle's 1,024-byte period does not fit), zeros out of bounds. The
// encoder is the driver's, fetched at run time; maps are kept by (address,
// shape, box, type), so a weight's is made once and an activation buffer's
// once per address it is given at.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t tensor_map(const void* base, CUtensorMapDataType type, int elem_bytes,
                              int rows, int cols, int box_rows, int box_cols, CUtensorMap* out,
                              bool swizzle = true) {
  using Key = std::tuple<const void*, int, int, int, int, int>;
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(std::get<0>(k)) ^ (size_t(std::get<1>(k)) << 1) ^
             (size_t(std::get<2>(k)) << 21) ^ (size_t(std::get<3>(k)) << 41) ^
             (size_t(std::get<4>(k)) << 49) ^ (size_t(std::get<5>(k)) << 57);
    }
  };
  static std::mutex mu;
  static EncodeTiled encode = nullptr;
  static std::unordered_map<Key, CUtensorMap, Hash> maps;
  std::lock_guard<std::mutex> lock(mu);
  const Key key(base, rows, cols, box_rows, box_cols, int(type) * 2 + int(swizzle));
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
  const cuuint64_t strides[1] = {cuuint64_t(cols) * elem_bytes};  // bytes between rows
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  CUtensorMap map;
  if (encode(&map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (maps.size() >= 4096) maps.clear();  // activation buffers come and go
  maps.emplace(key, map);
  *out = map;
  return cudaSuccess;
}

// The map of int8 codes [K, N] in 128 x 128 boxes (a staged chunk).
inline cudaError_t codes_map(const void* w, int K, int N, CUtensorMap* out) {
  return tensor_map(w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kChunkK, kTileN, out);
}
// The map of bf16 activations [M, K] in boxes of `rows` rows x 64 k
// (half a chunk's slice).
inline cudaError_t rows_map(const void* x, int M, int K, int rows, CUtensorMap* out) {
  return tensor_map(x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, rows, kChunkK / 2, out);
}

// -- the streaming product -----------------------------------------------------

enum Epilogue : int {
  kRaw = 0,      // out f32 = sum
  kQeinsum = 1,  // out bf16 = bf16(bf16(sum) * s0[n])   (quant.qeinsum's rounding points)
  kScaled = 2,   // out bf16 = bf16(sum * s0[n])
  kSwiGLU = 3,   // NMAT 2: out bf16 = bf16(silu(g * s0[n]) * (u * s1[n]))
};

constexpr int kStages = 4;
constexpr int kConsumers = 8;                    // warps that multiply
constexpr int kThreads = 32 * (kConsumers + 1);  // and one that issues the copies
constexpr int kPartOffset = 32768;               // NMAT 1: the split's sums, after the k-parts' exchange

// The ring of NMAT matrices' chunks, and the most of x beside it.
__host__ __device__ constexpr int ring_bytes(int nmat) { return kStages * nmat * kCodeBytes; }
__host__ __device__ constexpr int max_x_bytes(int nmat) { return nmat == 1 ? 163840 : 98304; }
// x of a block's K range sits in shared memory: whole when its rows fit
// max_x_bytes, else in two windows of `xw` chunks that take turns (chunk c's
// slice lands in window (c / xw) % 2; with four stages a window is refilled
// only after its chunks' products). Either way each x value is staged once.
// A chunk's slice is two 128B-swizzled boxes, k 0-63 and 64-127, of rows x
// 128 bytes each.
__host__ __device__ constexpr size_t x_chunk_bytes(int rows) { return size_t(rows) * kChunkK * 2; }
__host__ __device__ constexpr size_t x_window_bytes(int rows, int xw) {
  return x_chunk_bytes(rows) * xw;
}
// (chunks a window holds, windows) for a block of `rows` rows and `chunks`
// chunks.
__host__ __device__ inline int2 x_windows(int rows, int chunks, int nmat) {
  if (x_window_bytes(rows, chunks) <= size_t(max_x_bytes(nmat))) return make_int2(chunks, 1);
  return make_int2(int(max_x_bytes(nmat) / 2 / x_chunk_bytes(rows)), 2);
}
// Shared memory of a launch: the code ring (aligned), then x's window(s).
__host__ __device__ inline size_t smem_bytes(int rows, int chunks, int nmat) {
  const int2 w = x_windows(rows, chunks, nmat);
  return size_t(kAlign) + ring_bytes(nmat) + w.y * x_window_bytes(rows, w.x);
}
static_assert(kAlign + ring_bytes(1) + max_x_bytes(1) <= 232448, "one matrix: fits a block");
static_assert(kAlign + ring_bytes(2) + max_x_bytes(2) <= 232448, "two matrices: fits a block");
static_assert(max_x_bytes(1) / 2 / x_chunk_bytes(64) >= kStages - 1 &&
                  max_x_bytes(2) / 2 / x_chunk_bytes(64) >= kStages - 1,
              "a window outlasts the chunks in flight");
static_assert(kPartOffset + kMaxGroups * kRows * kTileN * 4 <= ring_bytes(1),
              "both exchanges fit the idle ring");
static_assert(2 * kMaxGroups * kRows * kTileN * 4 <= ring_bytes(2),
              "both matrices' sums fit the idle ring");

// Chunk c's copies, issued by one thread: its codes (of each matrix), and
// its slice of the block's rows of x into x's window, all counted on `bar`
// (rows past M and k past K read as zero).
template <int RG, int NMAT>
__device__ __forceinline__ void issue_chunk(unsigned char* stage, unsigned char* xs,
                                            const CUtensorMap* wmap0, const CUtensorMap* wmap1,
                                            const CUtensorMap* xmap, int n0, int m0, int k_begin,
                                            int c, int xw, uint64_t* bar) {
  constexpr int kHalf = int(x_chunk_bytes(RG * kRows) / 2);
  const int kc = k_begin + c * kChunkK;
  unsigned char* dst = xs + ((c / xw) % 2) * x_window_bytes(RG * kRows, xw) +
                       (c % xw) * x_chunk_bytes(RG * kRows);
  mbar_arrive_expect(bar, NMAT * kCodeBytes + 2 * kHalf);
  fence_async_shared();  // after the generic reads
  load_box(stage, wmap0, n0, kc, bar);
  if constexpr (NMAT == 2) load_box(stage + kCodeBytes, wmap1, n0, kc, bar);
  load_box(dst, xmap, kc, m0, bar);
  load_box(dst + kHalf, xmap, kc + kChunkK / 2, m0, bar);
}

// Grid (column tiles, K splits, row groups of RG x 16 rows); with splits > 1
// the splits of a tile form one thread block cluster (1, splits, 1).
//
// NMAT 1: the 8 consumer warps are 4 column quarters (32 columns each) x 2
// halves of every chunk's 8 k-steps; the halves' sums are added through
// shared memory in a fixed order at the end. NMAT 2: each stage holds the
// same chunk of two matrices side by side (the FFN's gate and up); the
// warps are 4 column quarters x the 2 matrices, each taking all 8 k-steps,
// and one block holds both sums of its columns for the epilogue.
//
// K split: each block leaves its float32 sums in its own shared memory;
// after a cluster barrier each adds 1/S of the tile's outputs over the S
// buffers, read through distributed shared memory in split order (the same
// bits on every run, no float atomics), and writes them; a second barrier
// keeps every buffer alive until all its readers are done.
template <int RG, int NMAT, int EPI>
__global__ void __launch_bounds__(kThreads, 1) stream_kernel(
    const __grid_constant__ CUtensorMap wmap0,  // codes [K, N]: 128 x 128 boxes, 128B swizzle
    const __grid_constant__ CUtensorMap wmap1,  // NMAT 2: the second matrix's codes
    const __grid_constant__ CUtensorMap xmap,   // x bf16 [M, K]: 64 x RG*16 boxes, 128B swizzle
    const float* __restrict__ s0,          // [N] column scales (EPI != kRaw), else null
    const float* __restrict__ s1,          // [N] the second matrix's (kSwiGLU)
    float* __restrict__ out_f32,           // [M, N] (kRaw)
    __nv_bfloat16* __restrict__ out_bf16,  // [M, N] (the others)
    int M, int K, int N, int splits, int split_k) {
  static_assert(NMAT == 1 || NMAT == 2, "one or two matrices a stage");
  static_assert((NMAT == 2) == (EPI == kSwiGLU), "two matrices: the SwiGLU epilogue");
  constexpr int kKParts = NMAT == 1 ? 2 : 1;    // warps that share a column quarter's k-steps
  constexpr int kSteps = kChunkK / 16 / kKParts;  // k-steps a warp takes of each chunk
  constexpr int kStageBytes = NMAT * kCodeBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Ring<kStages> ring;
  unsigned char* smem = smem_raw + ((kAlign - smem_addr(smem_raw) % kAlign) % kAlign);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int kq = warp / 4;           // NMAT 1: which half of a chunk's k-steps; NMAT 2: which matrix
  const int cq = (warp % 4) * 32;    // the warp's 32 columns of the tile
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kTileN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * RG * kRows;
  const int n_rows = min(RG * kRows, M - m0);
  const int k_begin = split * split_k;
  const int k_end = min(K, k_begin + split_k);
  const int n_chunks = (k_end - k_begin + kChunkK - 1) / kChunkK;
  const int xw = x_windows(RG * kRows, (split_k + kChunkK - 1) / kChunkK, NMAT).x;
  constexpr int kXHalf = int(x_chunk_bytes(RG * kRows) / 2);
  unsigned char* xs = smem + ring_bytes(NMAT);
  if (tid == 0) ring.init(kConsumers);
  float acc[RG][4][4];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][i][e] = 0.f;
  __syncthreads();
  const Frags f(cq, lane);

  if (warp == kConsumers) {  // the producer: a chunk's copies once its stage is free
    if (lane == 0) {
      for (int c = 0; c < n_chunks; ++c) {
        ring.acquire(c);
        issue_chunk<RG, NMAT>(smem + (c % kStages) * kStageBytes, xs, &wmap0, &wmap1, &xmap, n0,
                              m0, k_begin, c, xw, ring.bar(c));
      }
    }
  } else {
    for (int c = 0; c < n_chunks; ++c) {
      ring.wait(c);  // chunk c's codes and x have landed
      const unsigned char* codes =
          smem + (c % kStages) * kStageBytes + (NMAT == 2 ? kq * kCodeBytes : 0);
      const unsigned char* xc = xs + ((c / xw) % 2) * x_window_bytes(RG * kRows, xw) +
                                (c % xw) * x_chunk_bytes(RG * kRows);
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        kstep<RG>(acc, codes, xc, kXHalf, (NMAT == 1 ? kq * kSteps : 0) + s, f);
      ring.release(c, lane);  // the warp is done with the stage
    }
  }

  const int ncol = n0 + cq + 8 * t;  // N % 16 == 0: the 8 columns are all in range or none
  if constexpr (NMAT == 2) {
    // Both matrices' sums, [matrix][row][128 columns], in the (now idle)
    // ring; then each block adds its share of the tile's outputs over the
    // splits and applies the epilogue.
    float* part = reinterpret_cast<float*>(smem);
    __syncthreads();  // every consumer is done with the ring
    if (warp < kConsumers) {
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v[8];
          row_sums<RG>(acc, r, half, v);
          float4* dst = reinterpret_cast<float4*>(
              part + (kq * RG * kRows + r * kRows + g + 8 * half) * kTileN + cq + 8 * t);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
    }
    cg::cluster_group cluster = cg::this_cluster();
    if (splits == 1)
      __syncthreads();
    else
      cluster.sync();
    constexpr int kQuads = RG * kRows * kTileN / 4;  // float4s of one matrix's sums
    const int lo = split * kQuads / splits, hi = (split + 1) * kQuads / splits;
    for (int e = lo + tid; e < hi; e += kThreads) {
      const int row = e / (kTileN / 4), n = n0 + (e % (kTileN / 4)) * 4;
      float4 gs = make_float4(0.f, 0.f, 0.f, 0.f), us = gs;
      for (int r = 0; r < splits; ++r) {
        const float4* src =
            reinterpret_cast<const float4*>(splits == 1 ? part : cluster.map_shared_rank(part, r));
        const float4 a = src[e], b = src[kQuads + e];
        gs.x += a.x, gs.y += a.y, gs.z += a.z, gs.w += a.w;
        us.x += b.x, us.y += b.y, us.z += b.z, us.w += b.w;
      }
      if (row < n_rows && n < N) {
        const float gv[4] = {gs.x, gs.y, gs.z, gs.w}, uv[4] = {us.x, us.y, us.z, us.w};
        float h[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float gg = gv[j] * s0[n + j];
          const float uu = uv[j] * s1[n + j];
          h[j] = (gg * (1.f / (1.f + expf(-gg)))) * uu;
        }
        const __nv_bfloat162 p0 = __floats2bfloat162_rn(h[0], h[1]);
        const __nv_bfloat162 p1 = __floats2bfloat162_rn(h[2], h[3]);
        *reinterpret_cast<uint2*>(out_bf16 + size_t(m0 + row) * N + n) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&p0),
                       *reinterpret_cast<const uint32_t*>(&p1));
      }
    }
    if (splits > 1) cluster.sync();
    return;
  } else {
    // The second k-part's sums onto the first's, through the (now idle)
    // ring: red[e][128 threads], e = the accumulator's index.
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll 1
    for (int part = 1; part < kKParts; ++part) {
      __syncthreads();
      if (kq == part) {
#pragma unroll
        for (int r = 0; r < RG; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              red[((r * 4 + i) * 4 + e) * 128 + tid % 128] = acc[r][i][e];
      }
      __syncthreads();
      if (kq == 0) {
#pragma unroll
        for (int r = 0; r < RG; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][i][e] += red[((r * 4 + i) * 4 + e) * 128 + tid];
      }
    }

    auto emit = [&](int m, int n, const float* v, int count) {  // count: 8, or 4
      if constexpr (EPI == kRaw) {
        float4* dst = reinterpret_cast<float4*>(out_f32 + size_t(m) * N + n);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        if (count == 8) dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        uint32_t o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (2 * j >= count) break;
          float a0, a1;
          if constexpr (EPI == kQeinsum) {
            a0 = __bfloat162float(__float2bfloat16(v[2 * j])) * s0[n + 2 * j];
            a1 = __bfloat162float(__float2bfloat16(v[2 * j + 1])) * s0[n + 2 * j + 1];
          } else {
            a0 = v[2 * j] * s0[n + 2 * j];
            a1 = v[2 * j + 1] * s0[n + 2 * j + 1];
          }
          const __nv_bfloat162 p = __floats2bfloat162_rn(a0, a1);
          o[j] = *reinterpret_cast<const uint32_t*>(&p);
        }
        if (count == 8)
          *reinterpret_cast<uint4*>(out_bf16 + size_t(m) * N + n) =
              make_uint4(o[0], o[1], o[2], o[3]);
        else
          *reinterpret_cast<uint2*>(out_bf16 + size_t(m) * N + n) = make_uint2(o[0], o[1]);
      }
    };

    if (splits == 1) {
      if (kq == 0 && ncol < N) {
#pragma unroll
        for (int r = 0; r < RG; ++r)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = r * kRows + g + 8 * half;
            float v[8];
            row_sums<RG>(acc, r, half, v);
            if (row < n_rows) emit(m0 + row, ncol, v, 8);
          }
      }
      return;
    }

    // K split: part[row][128 columns] of each block, added in split order.
    float* part = reinterpret_cast<float*>(smem + kPartOffset);
    if (kq == 0) {
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v[8];
          row_sums<RG>(acc, r, half, v);
          float4* dst =
              reinterpret_cast<float4*>(part + (r * kRows + g + 8 * half) * kTileN + cq + 8 * t);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    constexpr int kQuads = RG * kRows * kTileN / 4;  // float4s of a buffer
    const int lo = split * kQuads / splits, hi = (split + 1) * kQuads / splits;
    for (int e = lo + tid; e < hi; e += kThreads) {
      const int row = e / (kTileN / 4), n = n0 + (e % (kTileN / 4)) * 4;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < splits; ++r) {
        const float4 p = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r))[e];
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
      if (row < n_rows && n < N) emit(m0 + row, n, v, 4);
    }
    cluster.sync();
  }
}

// Allow the variant its largest shared memory, once per device.
template <int RG, int NMAT, int EPI>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(stream_kernel<RG, NMAT, EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kAlign + ring_bytes(NMAT) + max_x_bytes(NMAT)));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// One launch of the streaming product: x [M, K] bf16 against the codes w0
// (and w1, NMAT 2) [K, N] with the scales s0 (and s1) into out; `splits`
// (one cluster, at most kMaxSplits) K ranges of `split_k`.
template <int RG, int NMAT, int EPI>
cudaError_t launch_stream(const void* x, const void* w0, const void* w1, const void* s0,
                          const void* s1, void* out, int M, int K, int N, int splits, int split_k,
                          cudaStream_t stream) {
  CUtensorMap wmap0, wmap1, xmap;
  cudaError_t err = codes_map(w0, K, N, &wmap0);
  if (err == cudaSuccess) err = NMAT == 2 ? codes_map(w1, K, N, &wmap1) : codes_map(w0, K, N, &wmap1);
  if (err == cudaSuccess) err = rows_map(x, M, K, RG * kRows, &xmap);
  if (err != cudaSuccess) return err;
  err = allow_smem<RG, NMAT, EPI>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTileN - 1) / kTileN, splits, (M + RG * kRows - 1) / (RG * kRows));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(RG * kRows, (split_k + kChunkK - 1) / kChunkK, NMAT);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = splits;  // the tile's splits: one cluster
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  float* of = EPI == kRaw ? static_cast<float*>(out) : nullptr;
  __nv_bfloat16* ob = EPI == kRaw ? nullptr : static_cast<__nv_bfloat16*>(out);
  err = cudaLaunchKernelEx(&cfg, stream_kernel<RG, NMAT, EPI>, wmap0, wmap1, xmap,
                           static_cast<const float*>(s0), static_cast<const float*>(s1), of, ob, M,
                           K, N, splits, split_k);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// launch_stream at a block of `rg` 16-row groups (1..4).
template <int NMAT, int EPI>
cudaError_t launch_rows(int rg, const void* x, const void* w0, const void* w1, const void* s0,
                        const void* s1, void* out, int M, int K, int N, int splits, int split_k,
                        cudaStream_t s) {
  switch (rg) {
    case 1: return launch_stream<1, NMAT, EPI>(x, w0, w1, s0, s1, out, M, K, N, splits, split_k, s);
    case 2: return launch_stream<2, NMAT, EPI>(x, w0, w1, s0, s1, out, M, K, N, splits, split_k, s);
    case 3: return launch_stream<3, NMAT, EPI>(x, w0, w1, s0, s1, out, M, K, N, splits, split_k, s);
    default: return launch_stream<4, NMAT, EPI>(x, w0, w1, s0, s1, out, M, K, N, splits, split_k, s);
  }
}

// A K split the kernel takes: `splits` (1..kMaxSplits) ranges of `split_k`
// (a multiple of 128) that together cover K, each non-empty.
inline bool split_ok(int K, int splits, int split_k) {
  return splits > 0 && splits <= kMaxSplits && split_k > 0 && split_k % kChunkK == 0 &&
         (long long)splits * split_k >= K && (long long)(splits - 1) * split_k < K;
}

}  // namespace int8_stream
