// Weight-streaming product of a few bf16 activation rows with an int8
// weight matrix, on the tensor cores: the device function that the fused
// decoder layer (fused_layer.cu) and the int8 lm-head (lm_head_int8.cu)
// share.
//
// One thread block computes the float32 sums of one output tile of
// kRows rows x kTileN columns over a range of the contracted axis K:
//
//   out[r][n] = sum_k A[r][k] * W[k][n0 + n]     (A bf16, W int8 [K, ldw])
//
// Every int8 code is exact in bf16, so each product of a bf16 activation
// and a code is exact, and the sums are taken in f32 by mma.sync
// (m16n8k16, bf16 in, f32 accumulate) in a fixed order: the same inputs
// give the same bits on every run. The 16 activation rows are the mma's M.
//
// Per 128-deep chunk of K: the block's 256 threads load the chunk's int8
// weights (16-byte loads, two a thread) and activations (one 16-byte load
// a thread) into registers three chunks ahead, convert the codes to bf16 and
// store both in shared memory; each of the 8 warps then owns 8 of the 64
// columns and runs the chunk's 8 k-steps: ldmatrix for the activations,
// ldmatrix.trans for the [k][n] weights, one mma each. A warp's columns are
// its own over the whole K range, so no sums cross warps.
//
// int8 -> float without a conversion instruction: the code biased to an
// unsigned byte is placed in the low mantissa bits of 2^23 (one byte
// permute) and 2^23 + 128 is subtracted (one add), which is exact; pairs are
// then packed to bf16x2 (exact: |code| <= 127).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace int8_gemv {

constexpr int kThreads = 256;
constexpr int kRows = 16;     // activation rows per pass (the mma's M)
constexpr int kTileN = 64;    // output columns per tile: 8 warps x 8
constexpr int kChunkK = 128;  // contracted values per staged chunk
constexpr int kOutPerThread = kRows * kTileN / kThreads;
constexpr int kActStride = kChunkK + 8;  // bf16; padded rows: conflict-free ldmatrix
constexpr int kWStride = kTileN + 8;     // bf16
constexpr int kActBytes = kRows * kActStride * 2;
// Shared memory of one tile: staged activations, then staged weights.
constexpr int kSmemBytes = kActBytes + kChunkK * kWStride * 2;
static_assert(kThreads / 32 * 8 == kTileN, "a warp owns 8 columns");
static_assert(kRows * kChunkK / 8 == kThreads, "one 16-byte activation load a thread");
static_assert(kChunkK * kTileN / 16 == 2 * kThreads, "two 16-byte weight loads a thread");

__device__ __forceinline__ float bf16_bits(unsigned short u) {
  return __uint_as_float(uint32_t(u) << 16);
}

// Four int8 codes packed in a word -> four exact floats.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* f) {
  const uint32_t b = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7543)) - 8388736.f;
}

// Four int8 codes -> two bf16x2 words (low half = lower address).
__device__ __forceinline__ uint2 int8x4_to_bf16x4(uint32_t w) {
  float f[4];
  int8x4_to_float(w, f);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

// Row r and column n of out[i] in tile_sums: the mma accumulator layout
// (c0, c1: row lane/4, columns 2*(lane%4) + {0, 1}; c2, c3: row + 8), in
// the warp's 8 columns.
__device__ __forceinline__ int out_row(int i) { return (threadIdx.x % 32) / 4 + (i >= 2 ? 8 : 0); }
__device__ __forceinline__ int out_col(int i) {
  return (threadIdx.x / 32) * 8 + (threadIdx.x % 4) * 2 + (i & 1);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

struct Chunk {
  uint4 w[2];  // 16 codes each: row k, columns nq .. nq + 15
  uint4 a;     // 8 bf16: row r, k .. k + 7
};

// A: bf16 rows of stride lda (rows >= n_rows read as zero), read through
// L2 (__ldcg): in the fused layer they were written by other blocks of the
// same launch. W: int8 [K, ldw], read-only; columns are taken in groups of
// 16 and a group at or past n_valid reads as zero. lda, k_begin and k_end
// are multiples of 8, ldw and n0 of 16, and A and W 16-byte aligned.
__device__ __forceinline__ void load_chunk(Chunk& c, const __nv_bfloat16* A, int lda, int n_rows,
                                           const int8_t* W, int ldw, int n0, int n_valid,
                                           int kc, int k_end) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = tid + j * kThreads;
    const int k = kc + q / (kTileN / 16);
    const int col = n0 + (q % (kTileN / 16)) * 16;
    c.w[j] = (k < k_end && col < n_valid)
                 ? __ldg(reinterpret_cast<const uint4*>(W + size_t(k) * ldw + col))
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  const int r = tid / (kChunkK / 8);
  const int k = kc + (tid % (kChunkK / 8)) * 8;
  c.a = (r < n_rows && k < k_end)
            ? __ldcg(reinterpret_cast<const uint4*>(A + size_t(r) * lda + k))
            : make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void store_chunk(const Chunk& c, unsigned char* smem) {
  const int tid = threadIdx.x;
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wts = reinterpret_cast<__nv_bfloat16*>(smem + kActBytes);
  *reinterpret_cast<uint4*>(act + (tid / (kChunkK / 8)) * kActStride + (tid % (kChunkK / 8)) * 8) =
      c.a;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = tid + j * kThreads;
    __nv_bfloat16* dst = wts + (q / (kTileN / 16)) * kWStride + (q % (kTileN / 16)) * 16;
    const uint2 p0 = int8x4_to_bf16x4(c.w[j].x);
    const uint2 p1 = int8x4_to_bf16x4(c.w[j].y);
    const uint2 p2 = int8x4_to_bf16x4(c.w[j].z);
    const uint2 p3 = int8x4_to_bf16x4(c.w[j].w);
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(p0.x, p0.y, p1.x, p1.y);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(p2.x, p2.y, p3.x, p3.y);
  }
}

// The float32 sums of one tile over k in [k_begin, k_end) into out (see
// out_row/out_col). smem holds kSmemBytes, 16-byte aligned; the function
// starts with a barrier before it writes smem.
__device__ __forceinline__ void tile_sums(const __nv_bfloat16* A, int lda, int n_rows,
                                          const int8_t* W, int ldw, int n0, int n_valid,
                                          int k_begin, int k_end, void* smem_v,
                                          float (&out)[kOutPerThread]) {
  unsigned char* smem = static_cast<unsigned char*>(smem_v);
  const __nv_bfloat16* act = reinterpret_cast<const __nv_bfloat16*>(smem);
  const __nv_bfloat16* wts = reinterpret_cast<const __nv_bfloat16*>(smem + kActBytes);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  // two accumulators (even and odd k-steps) halve the mma dependency chain
  float c0[4] = {0.f, 0.f, 0.f, 0.f};
  float c1[4] = {0.f, 0.f, 0.f, 0.f};
  // ldmatrix row addresses: A rows lane % 16 at k offset 8 * (lane / 16);
  // W rows (k) lane of the 32-deep pair of k-steps, the warp's 8 columns.
  const __nv_bfloat16* a_row = act + (lane % 16) * kActStride + (lane / 16) * 8;
  const __nv_bfloat16* w_row = wts + lane * kWStride + warp * 8;

  // Three register buffers, each refilled with the chunk three ahead right
  // after it is stored, so three chunks are in flight while one is
  // multiplied. The loop is unrolled by three so that no buffer is ever
  // copied (a copy would wait for its loads to land).
  Chunk b0, b1, b2;
  auto step = [&](Chunk& c, int kc) {
    __syncthreads();  // the previous chunk's (or tile's) ldmatrix reads are done
    store_chunk(c, smem);
    __syncthreads();
    if (kc + 3 * kChunkK < k_end)
      load_chunk(c, A, lda, n_rows, W, ldw, n0, n_valid, kc + 3 * kChunkK, k_end);
#pragma unroll
    for (int ks = 0; ks < kChunkK / 16; ks += 2) {
      uint32_t a0[4], a1[4], b[4];
      ldmatrix_x4(a0, a_row + ks * 16);
      ldmatrix_x4(a1, a_row + (ks + 1) * 16);
      ldmatrix_x4_trans(b, w_row + ks * 16 * kWStride);  // k-steps ks and ks + 1
      mma_bf16(c0, a0, b[0], b[1]);
      mma_bf16(c1, a1, b[2], b[3]);
    }
  };
  if (k_begin < k_end) load_chunk(b0, A, lda, n_rows, W, ldw, n0, n_valid, k_begin, k_end);
  if (k_begin + kChunkK < k_end)
    load_chunk(b1, A, lda, n_rows, W, ldw, n0, n_valid, k_begin + kChunkK, k_end);
  if (k_begin + 2 * kChunkK < k_end)
    load_chunk(b2, A, lda, n_rows, W, ldw, n0, n_valid, k_begin + 2 * kChunkK, k_end);
  for (int kc = k_begin; kc < k_end; kc += 3 * kChunkK) {
    step(b0, kc);
    if (kc + kChunkK < k_end) step(b1, kc + kChunkK);
    if (kc + 2 * kChunkK < k_end) step(b2, kc + 2 * kChunkK);
  }
#pragma unroll
  for (int i = 0; i < kOutPerThread; ++i) out[i] = c0[i] + c1[i];
}

}  // namespace int8_gemv
