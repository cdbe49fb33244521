// Weight-streaming product of bf16 activations with an int8 weight matrix,
// for Hopper (sm_90a):
//
//   out[m][n] = sum_k x[m][k] * w[k][n]      x bf16 [M, K], w int8 [K, N]
//
// Replaces the TPU prototype mk_pallas(BN) -> one (_prof_stream.py:56,
// pallas_call at :74), which streams pre-tiled int8 weights [NT, K, BN]
// against 128 activation rows into float32 [128, N] with no scale. Here the
// weights keep the serving layout [K, N] (N contiguous) and M is any count.
// On the serving path it runs quant.qeinsum's int8 products of decode-sized
// row counts (the 7 products of each unfused decoder layer: q, k, v, o,
// gate, up, down), with an optional epilogue that applies qeinsum's
// rounding points in the same pass: the f32 sum rounded to bf16, times the
// f32 per-column scale, rounded to bf16 (dynamo_tpu/ops/quant.py:82-89).
// Without the epilogue the output is the f32 sum (the prototype's function).
//
// What bounds it on the card: at decode (M <= 64) it does 2*M flops per
// weight byte, under the H100's ~295 bf16 flops/byte ridge, so the floor is
// the weight bytes over 3.35 TB/s, and for the small products of a 1B model
// (0.3-8 MB of codes) the fixed costs of a launch: the first chunk's
// latency and, where K is split, the partial sums' reduction.
//
// The design streams each code byte once per launch for up to 64 rows:
//   * Wide tiles. A block owns 128 output columns, so every 128-deep chunk
//     reads whole 128-byte lines of 128 code rows (16 KB a chunk).
//   * Codes straight into shared memory, by the copy engine. A ring of four
//     stages takes each 128 x 128 chunk by one 2-D tensor copy (a tensor map
//     of W made once per weight, 128-byte swizzle, zeros past K and N),
//     counted on the stage's mbarrier. A producer warp issues the copies of
//     a stage once the 8 consumer warps have released it (a second mbarrier
//     a stage): no thread holds staging registers, and no block-wide
//     barrier stands between one chunk's products and the next chunk's
//     copies.
//   * x staged once. The block's rows of x for its K range sit in shared
//     memory (whole, or in two windows that take turns when they do not
//     fit); each chunk's slice comes by two more tensor copies beside the
//     chunk's codes, so x is read once per block and never from registers.
//     (16-byte cp.async copies of x, and one bulk copy a row of x, held a
//     block back on an H100; the tensor copies keep up. PERF.md, "what
//     paces #8".)
//   * Conversion on the way to the mma. Each thread reads 4-byte words of
//     codes (four columns of one k row) from the staged chunk and builds the
//     B fragments of four n8 tiles from them: one byte permute pairs the k
//     rows (2t, 2t + 1) a fragment register wants, and two logic ops and a
//     bf16x2 subtraction make the pair exact bf16 (codes_to_bf16x2). The n8
//     tile i's column g is the tile's column 4g + i, so a thread's
//     accumulators hold 8 consecutive output columns of a row.
//   * Products: mma.sync m16n8k16 (bf16 in, f32 accumulate; every product of
//     a bf16 activation and a code is exact). The 8 consumer warps are 4
//     column quarters (32 columns each) x 2 halves of every chunk's 8
//     k-steps; the halves' sums are added through shared memory in a fixed
//     order at the end. Two blocks share an SM where their registers (up to
//     32 rows) and shared memory allow.
//
// K split. N/128 column tiles alone leave most of the 132 SMs idle at N =
// 1,024 or 4,096, and one block alone takes ~0.64 us a chunk (its
// conversions and products; tools/int8_stream_probe.py's lone_block line,
// H100), so K is split: the S <= 8 blocks of a tile each sum a contiguous
// K range, and they run as one thread block cluster. Each leaves its float32 sums in its own shared
// memory; after a cluster barrier each adds 1/S of the tile's outputs over
// the S buffers, read through distributed shared memory in split order
// (the same bits on every run, no float atomics), and writes them. No
// partial sums go through device memory and no block waits on a counter:
// the tail is two cluster barriers and the reads of 8 KB a 16-row group.
// The caller picks S and the K range from the shapes, the card's SM count
// and how many clusters of each size it holds at one and at two blocks an
// SM (ops/cuda/int8_matmul.plan, int8_matmul_capacity).

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <tuple>
#include <unordered_map>

namespace cg = cooperative_groups;

namespace {

constexpr int kKParts = 2;                 // warps a column quarter: each 4 k-steps a chunk
constexpr int kConsumers = 4 * kKParts;    // warps that multiply
constexpr int kThreads = 32 * (kConsumers + 1);  // and one that issues the copies
constexpr int kRows = 16;                  // rows a group: the mma's M
constexpr int kMaxGroups = 4;              // 64 rows a block
constexpr int kTileN = 128;                // output columns a block
constexpr int kChunkK = 128;               // k rows a stage
constexpr int kStages = 4;
constexpr int kStageBytes = kChunkK * kTileN;     // a chunk of codes, 128B-swizzled
constexpr int kRingBytes = kStages * kStageBytes;  // 65,536
constexpr int kAlign = 1024;               // the ring's alignment (128-byte swizzle)
constexpr int kMaxXBytes = 163840;         // x of a block's K range, at most
constexpr int kMaxSplits = 8;              // a cluster's blocks, at most (the portable size)
constexpr int kPartOffset = 32768;         // the split's sums, after the k-parts' exchange
static_assert(kConsumers == 8, "4 column quarters x 2 k-parts");
static_assert(kPartOffset + kMaxGroups * kRows * kTileN * 4 <= kRingBytes,
              "both exchanges fit the idle ring");

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
// One box of a tensor map at coordinates (x0, y0) into `dst` by the copy
// engine (out of bounds reads as zero), counted on `bar`: the codes of a
// chunk (128 columns x 128 k rows of W), or half a chunk's slice of x (64
// k x the block's rows).
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, int x0, int y0,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(y0), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
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

// x of a block's K range sits in shared memory: whole when its rows fit
// kMaxXBytes, else in two windows of `xw` chunks that take turns (chunk c's
// slice lands in window (c / xw) % 2; with four stages a window is refilled
// only after its chunks' products). Either way each x value is staged once.
// A chunk's slice is two 128B-swizzled boxes, k 0-63 and 64-127, of
// rows x 128 bytes each.
__host__ __device__ constexpr size_t x_chunk_bytes(int rows) { return size_t(rows) * kChunkK * 2; }
__host__ __device__ constexpr size_t x_window_bytes(int rows, int xw) {
  return x_chunk_bytes(rows) * xw;
}
// (chunks a window holds, windows) for a block of `rows` rows and `chunks`
// chunks.
__host__ __device__ inline int2 x_windows(int rows, int chunks) {
  if (x_window_bytes(rows, chunks) <= size_t(kMaxXBytes)) return make_int2(chunks, 1);
  return make_int2(int(kMaxXBytes / 2 / x_chunk_bytes(rows)), 2);
}
// Shared memory of a launch: the code ring (aligned), then x's window(s).
__host__ __device__ inline size_t smem_bytes(int rows, int chunks) {
  const int2 w = x_windows(rows, chunks);
  return size_t(kAlign) + kRingBytes + w.y * x_window_bytes(rows, w.x);
}
static_assert(kMaxXBytes / 2 / x_chunk_bytes(64) >= kStages - 1,
              "a window outlasts the chunks in flight");

// Chunk c's copies, issued by one thread: its codes, and its slice of the
// block's rows of x into x's window, all counted on `bar` (rows past M and
// k past K read as zero).
template <int RG>
__device__ __forceinline__ void issue_chunk(unsigned char* stage, unsigned char* xs,
                                            const CUtensorMap* wmap, const CUtensorMap* xmap,
                                            int n0, int m0, int k_begin, int c, int xw,
                                            uint64_t* bar) {
  constexpr int kHalf = int(x_chunk_bytes(RG * kRows) / 2);
  const int kc = k_begin + c * kChunkK;
  unsigned char* dst = xs + ((c / xw) % 2) * x_window_bytes(RG * kRows, xw) +
                       (c % xw) * x_chunk_bytes(RG * kRows);
  mbar_arrive_expect(bar, kStageBytes + 2 * kHalf);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the generic reads
  load_box(stage, wmap, n0, kc, bar);
  load_box(dst, xmap, kc, m0, bar);
  load_box(dst + kHalf, xmap, kc + kChunkK / 2, m0, bar);
}

// Grid (column tiles, K splits, row groups of RG x 16 rows); with splits > 1
// the splits of a tile form one thread block cluster (1, splits, 1).
template <int RG, bool SCALED>
__global__ void __launch_bounds__(kThreads, 1) int8_matmul_kernel(
    const __grid_constant__ CUtensorMap wmap,  // w int8 [K, N]: 128 x 128 boxes, 128B swizzle
    const __grid_constant__ CUtensorMap xmap,  // x bf16 [M, K]: 64 x RG*16 boxes, 128B swizzle
    const float* __restrict__ scale,      // [N] (SCALED), else null
    float* __restrict__ out_f32,          // [M, N] (not SCALED)
    __nv_bfloat16* __restrict__ out_bf16, // [M, N] (SCALED)
    int M, int K, int N, int splits, int split_k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t full[kStages];   // a chunk's codes and x have landed
  __shared__ uint64_t empty[kStages];  // every consumer warp is done with a stage
  unsigned char* smem = smem_raw + ((kAlign - smem_addr(smem_raw) % kAlign) % kAlign);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int kq = warp / 4;           // which quarter of a chunk's k-steps
  const int cq = (warp % 4) * 32;    // the warp's 32 columns of the tile
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kTileN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * RG * kRows;
  const int n_rows = min(RG * kRows, M - m0);
  const int k_begin = split * split_k;
  const int k_end = min(K, k_begin + split_k);
  const int n_chunks = (k_end - k_begin + kChunkK - 1) / kChunkK;
  const int xw = x_windows(RG * kRows, (split_k + kChunkK - 1) / kChunkK).x;
  unsigned char* xs = smem + kRingBytes;
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float acc[RG][4][4];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][i][e] = 0.f;

  // ldmatrix rows of x: rows lane % 16 of a group at k offset 8 (lane / 16)
  // of a k-step, 128B-swizzled: the 16-byte piece j of row r at j ^ (r % 8)
  const int a_row = (lane % 16) * 128;
  const int a_swz = lane & 7;
  __syncthreads();
  // Thread (g, t) reads 4-byte words of codes: rows 2t + {0, 1, 8, 9} of a
  // k-step, columns cq + 4g .. + 3, at their 128B-swizzled places (the
  // 16-byte piece of a row XOR the row's index mod 8).
  const int piece = cq / 16 + g / 4;
  const int sw0 = ((piece ^ ((2 * t) & 7)) << 4) + (g % 4) * 4;      // rows 2t, 2t + 8
  const int sw1 = ((piece ^ ((2 * t + 1) & 7)) << 4) + (g % 4) * 4;  // rows 2t + 1, 2t + 9

  if (warp == kConsumers) {  // the producer: a chunk's copies once its stage is free
    if (lane == 0) {
      for (int c = 0; c < n_chunks; ++c) {
        if (c >= kStages) mbar_wait(empty + c % kStages, (c / kStages - 1) & 1);
        issue_chunk<RG>(smem + (c % kStages) * kStageBytes, xs, &wmap, &xmap, n0, m0, k_begin, c,
                        xw, full + c % kStages);
      }
    }
  } else {
  for (int c = 0; c < n_chunks; ++c) {
    mbar_wait(full + c % kStages, (c / kStages) & 1);  // chunk c's codes and x have landed
    const unsigned char* stage = smem + (c % kStages) * kStageBytes;
    const unsigned char* xc = xs + ((c / xw) % 2) * x_window_bytes(RG * kRows, xw) +
                              (c % xw) * x_chunk_bytes(RG * kRows);
#pragma unroll
    for (int s = 0; s < kChunkK / 16 / kKParts; ++s) {
      const int ks = kq * (kChunkK / 16 / kKParts) + s;  // this warp's k-step of the chunk
      // B fragments of the four n8 tiles: rows 2t, 2t + 1 (b0) and 2t + 8,
      // 2t + 9 (b1) of the k-step, columns cq + 4g .. cq + 4g + 3
      const unsigned char* wr = stage + (ks * 16 + 2 * t) * kTileN;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr + sw0);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + kTileN + sw1);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(wr + 8 * kTileN + sw0);
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(wr + 9 * kTileN + sw1);
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
      const unsigned char* xk = xc + (ks / 4) * (x_chunk_bytes(RG * kRows) / 2) + a_row +
                                ((((2 * ks + lane / 16) & 7) ^ a_swz) << 4);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        uint32_t a[4];
        ldmatrix_x4(a, xk + r * kRows * 128);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16(acc[r][i], a, b0[i], b1[i]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + c % kStages);  // the warp is done with the stage
  }

  }  // the consumers

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

  // Thread (g, t) of a first-part warp holds rows g and g + 8 of each group
  // at columns n0 + cq + 8t .. + 7: tile i's c0/c2 at column 8t + i, its
  // c1/c3 at 8t + 4 + i.
  const int ncol = n0 + cq + 8 * t;  // N % 16 == 0: the 8 columns are all in range or none
  auto row_sums = [&](int r, int half, float (&v)[8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = acc[r][i][2 * half];
      v[4 + i] = acc[r][i][2 * half + 1];
    }
  };
  auto emit = [&](int m, int n, const float* v, int count) {  // count: 8, or 4
    if constexpr (SCALED) {
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (2 * j >= count) break;
        const float a0 = __bfloat162float(__float2bfloat16(v[2 * j])) * scale[n + 2 * j];
        const float a1 = __bfloat162float(__float2bfloat16(v[2 * j + 1])) * scale[n + 2 * j + 1];
        const __nv_bfloat162 p = __floats2bfloat162_rn(a0, a1);
        o[j] = *reinterpret_cast<const uint32_t*>(&p);
      }
      if (count == 8)
        *reinterpret_cast<uint4*>(out_bf16 + size_t(m) * N + n) = make_uint4(o[0], o[1], o[2], o[3]);
      else
        *reinterpret_cast<uint2*>(out_bf16 + size_t(m) * N + n) = make_uint2(o[0], o[1]);
    } else {
      float4* dst = reinterpret_cast<float4*>(out_f32 + size_t(m) * N + n);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      if (count == 8) dst[1] = make_float4(v[4], v[5], v[6], v[7]);
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
          row_sums(r, half, v);
          if (row < n_rows) emit(m0 + row, ncol, v, 8);
        }
    }
    return;
  }

  // K split: the tile's splits are one cluster. Each block leaves its sums
  // in its own shared memory, part[row][128 columns]; after a cluster
  // barrier block `split` adds its share of the tile's outputs over the
  // splits' buffers, read through distributed shared memory in split order
  // 0, 1, ... (the same bits on every run), and writes them. A second
  // barrier keeps every buffer alive until all its readers are done.
  float* part = reinterpret_cast<float*>(smem + kPartOffset);
  if (kq == 0) {
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[8];
        row_sums(r, half, v);
        float4* dst = reinterpret_cast<float4*>(part + (r * kRows + g + 8 * half) * kTileN + cq + 8 * t);
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

// Allow the variant its largest shared memory, once per device.
template <int RG, bool SCALED>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(int8_matmul_kernel<RG, SCALED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kAlign + kRingBytes + kMaxXBytes));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// Tensor maps for the copy engine: a row-major 2-D array of `rows` x `cols`
// elements, boxes of box_rows x box_cols, 128-byte swizzle, zeros out of
// bounds. The encoder is the driver's, fetched at run time; maps are kept
// by (address, shape, box), so a weight's is made once and an activation
// buffer's once per address it is given at.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t tensor_map(const void* base, CUtensorMapDataType type, int elem_bytes, int rows,
                       int cols, int box_rows, int box_cols, CUtensorMap* out) {
  using Key = std::tuple<const void*, int, int, int, int>;
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(std::get<0>(k)) ^ (size_t(std::get<1>(k)) << 1) ^
             (size_t(std::get<2>(k)) << 21) ^ (size_t(std::get<3>(k)) << 41) ^
             (size_t(std::get<4>(k)) << 51);
    }
  };
  static std::mutex mu;
  static EncodeTiled encode = nullptr;
  static std::unordered_map<Key, CUtensorMap, Hash> maps;
  std::lock_guard<std::mutex> lock(mu);
  const Key key(base, rows, cols, box_rows, int(type));
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
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (maps.size() >= 4096) maps.clear();  // activation buffers come and go
  maps.emplace(key, map);
  *out = map;
  return cudaSuccess;
}

template <int RG, bool SCALED>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, int M, int K,
                   int N, int splits, int split_k, cudaStream_t stream) {
  CUtensorMap wmap, xmap;
  cudaError_t map_err = tensor_map(w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kChunkK, kTileN,
                                   &wmap);
  if (map_err != cudaSuccess) return map_err;
  map_err = tensor_map(x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, RG * kRows, kChunkK / 2,
                       &xmap);
  if (map_err != cudaSuccess) return map_err;
  const auto kernel = int8_matmul_kernel<RG, SCALED>;
  cudaError_t err = allow_smem<RG, SCALED>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTileN - 1) / kTileN, splits, (M + RG * kRows - 1) / (RG * kRows));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(RG * kRows, (split_k + kChunkK - 1) / kChunkK);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = splits;  // the tile's splits: one cluster
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  float* of = SCALED ? nullptr : static_cast<float*>(out);
  __nv_bfloat16* ob = SCALED ? static_cast<__nv_bfloat16*>(out) : nullptr;
  err = cudaLaunchKernelEx(&cfg, kernel, wmap, xmap, static_cast<const float*>(scale), of, ob, M,
                           K, N, splits, split_k);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool SCALED>
cudaError_t launch_rows(int rg, const void* x, const void* w, const void* scale, void* out,
                        int M, int K, int N, int splits, int split_k, cudaStream_t s) {
  switch (rg) {
    case 1: return launch<1, SCALED>(x, w, scale, out, M, K, N, splits, split_k, s);
    case 2: return launch<2, SCALED>(x, w, scale, out, M, K, N, splits, split_k, s);
    case 3: return launch<3, SCALED>(x, w, scale, out, M, K, N, splits, split_k, s);
    default: return launch<4, SCALED>(x, w, scale, out, M, K, N, splits, split_k, s);
  }
}


}  // namespace

// How many clusters of `splits` blocks (blocks, for splits 1) of the kernel
// the card holds at once, with two blocks an SM (their registers allow it
// up to 32 rows, and a small x: `two_per_sm`) or one (a large x), into *n.
// A cluster's blocks share a GPC, so fewer than SMs / splits are held where
// a GPC's SMs are not a multiple of splits.
extern "C" int int8_matmul_capacity(int splits, int two_per_sm, int* n) {
  if (splits < 1 || splits > kMaxSplits || n == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<2, true>();
  if (err != cudaSuccess) return err;
  const size_t smem = two_per_sm ? smem_bytes(2 * kRows, 1) : size_t(kAlign) + kRingBytes + kMaxXBytes;
  if (splits == 1) {
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int8_matmul_kernel<2, true>,
                                                        kThreads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    *n = per_sm * sms;
    return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, splits, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = splits;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, int8_matmul_kernel<2, true>, &cfg);
}

// out = x[M, K] @ w[K, N]: float32 [M, N] when scale is null; else bf16
// [M, N] = bf16(bf16(sum) * scale[n]). A block takes block_rows (16, 32,
// 48 or 64) rows of x; K splits: `splits` (at most kMaxSplits, one
// cluster) ranges of `split_k` (a multiple of 128) that together cover K,
// each non-empty. Returns
// the launch's error (0 = launched).
extern "C" int int8_matmul(const void* x, const void* w, const void* scale, void* out, int M,
                           int K, int N, int splits, int split_k, int block_rows, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 16 != 0) return cudaErrorInvalidValue;
  if (block_rows <= 0 || block_rows % kRows != 0 || block_rows > kMaxGroups * kRows)
    return cudaErrorInvalidValue;
  if (splits <= 0 || splits > kMaxSplits || split_k <= 0 || split_k % kChunkK != 0 ||
      (long long)splits * split_k < K || (long long)(splits - 1) * split_k >= K)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rg = block_rows / kRows;
  if (scale != nullptr)
    return launch_rows<true>(rg, x, w, scale, out, M, K, N, splits, split_k, s);
  return launch_rows<false>(rg, x, w, scale, out, M, K, N, splits, split_k, s);
}
