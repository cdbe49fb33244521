// Int8 lm-head for Hopper (sm_90a): float32 logits [M, V] from bf16 hidden
// states x [M, K] and the int8 head, the counterpart of the TPU prototype
// head_fused (_prof_head.py:33, pallas_call at :34) on the serving path's
// int8 quant.lm_head.
//
//   untied: codes [K, V] (lm_head), scales [1, V]
//   tied:   codes [V, K] (the embedding table), scales [V, 1]
//
//   logits[m, v] = float(bf16(sum_k x[m, k] * q[., .])) * s[v]
//
// The rounding points are those of quant.lm_head, which this kernel
// replaces: an f32 sum of exact bf16 x int8 products, rounded to bf16 (the
// dtype of the product of x and the upcast codes), then times the f32
// scale. The TPU prototype keeps the f32 sum and skips that rounding.
//
// What bounds it on the card: the codes. At Gemma-3-1B's tied head (V
// 262,144 x K 1,152) they are 302 MB, 0.09 ms at 3.35 TB/s; the f32
// logits of 32 rows add 34 MB. The 2·M·K·V products (19 GFLOP at M 32)
// take 0.02 ms on the bf16 tensor cores, so every code byte has to be read
// from device memory once and the products have to run on the tensor cores.
// Both heads are weight-streaming kernels on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate; every code is exact in bf16):
//   * untied: int8_gemv.cuh's tile (64 vocab columns, all of K, 16 rows of
//     x; M > 16 takes more row groups on the grid's second axis), then the
//     epilogue;
//   * tied: a block owns 256 vocab rows and up to 64 rows of x (four m16
//     tiles; only M > 64 takes more row groups), so each code byte is read
//     once. A vocab row's codes run along K, which is the mma's B operand
//     in its "col" layout, so no transpose is needed: 64-deep chunks of the
//     codes and of x are staged by 16-byte cp.async (8-byte when K is not a
//     multiple of 16) three chunks deep, the codes are converted exactly to
//     bf16 as they are stored in a second shared tile, and each of the 8
//     warps takes 32 vocab rows: ldmatrix (no .trans) for both operands and
//     4·MT mmas a 16-deep step. x is read through L2 by every block (74 KB
//     at M 32, K 1,152), not from device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_gemv.cuh"

namespace {

using int8_gemv::kRows;
using int8_gemv::kThreads;

__global__ void __launch_bounds__(kThreads, 1)
    lm_head_untied_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                          const float* __restrict__ s, float* __restrict__ out, int M, int K,
                          int V) {
  using namespace int8_gemv;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * kTileN;
  const int row0 = blockIdx.y * kRows;
  float sums[kOutPerThread];
  tile_sums(x + size_t(row0) * K, K, min(kRows, M - row0), q, V, n0, V, 0, K, smem, sums);
#pragma unroll
  for (int i = 0; i < kOutPerThread; ++i) {
    const int m = row0 + out_row(i);
    const int v = n0 + out_col(i);
    if (m < M && v < V)
      out[size_t(m) * V + v] = __bfloat162float(__float2bfloat16_rn(sums[i])) * s[v];
  }
}

// -- tied: codes [V, K] ------------------------------------------------------

constexpr int kTiedN = 256;        // vocab rows a block: 8 warps x 32
constexpr int kTiedRows = 64;      // rows of x a block, at most: four m16 tiles
constexpr int kTiedKC = 64;        // k a staged chunk
constexpr int kTiedStages = 3;     // chunks in shared memory: two in flight
constexpr int kTiedStride = kTiedKC + 8;  // bf16; padded rows: conflict-free ldmatrix

// Shared memory of a tied block with MT m16 tiles of x: kTiedStages stages
// (the chunk's int8 codes [256][64], then its x rows [16·MT][72] bf16), then
// the chunk's codes as bf16 [256][72]. MT 4: 111 KB, two blocks an SM.
template <int MT>
struct TiedSmem {
  static constexpr int kCodeBytes = kTiedN * kTiedKC;
  static constexpr int kXBytes = MT * 16 * kTiedStride * 2;
  static constexpr int kStageBytes = kCodeBytes + kXBytes;
  static constexpr int kWtOffset = kTiedStages * kStageBytes;
  static constexpr int kTotal = kWtOffset + kTiedN * kTiedStride * 2;
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;  // 0: zero-filled, src is not read
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of chunk `kc` (k = kc .. kc + 63) into a stage: the
// block's vocab rows' codes in CODE_BYTES pieces (16, or 8 when K is not a
// multiple of 16 and rows are only 8-byte aligned), and its rows of x.
// Rows past V or M and k past K are zero-filled.
template <int MT, int CODE_BYTES>
__device__ __forceinline__ void tied_load_chunk(unsigned char* stage, const __nv_bfloat16* x,
                                                const int8_t* q, int M, int K, int V, int v0,
                                                int row0, int kc) {
  constexpr int kPieces = kTiedKC / CODE_BYTES;  // a vocab row's pieces of a chunk
  for (int p = threadIdx.x; p < kTiedN * kPieces; p += kThreads) {
    const int r = p / kPieces, k = kc + (p % kPieces) * CODE_BYTES;
    const bool valid = v0 + r < V && k < K;
    cp_async<CODE_BYTES>(stage + r * kTiedKC + (p % kPieces) * CODE_BYTES,
                         valid ? q + size_t(v0 + r) * K + k : q, valid);
  }
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage + TiedSmem<MT>::kCodeBytes);
  for (int p = threadIdx.x; p < MT * 16 * (kTiedKC / 8); p += kThreads) {
    const int r = p / (kTiedKC / 8), k = kc + (p % (kTiedKC / 8)) * 8;
    const bool valid = row0 + r < M && k < K;
    cp_async<16>(xs + r * kTiedStride + (p % (kTiedKC / 8)) * 8,
                 valid ? x + size_t(row0 + r) * K + k : x, valid);
  }
}

template <int MT, int CODE_BYTES>
__global__ void __launch_bounds__(kThreads, 2)
    lm_head_tied_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                        const float* __restrict__ s, float* __restrict__ out, int M, int K,
                        int V) {
  using Smem = TiedSmem<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem + Smem::kWtOffset);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int v0 = blockIdx.x * kTiedN;
  const int row0 = blockIdx.y * kTiedRows;
  const int n_chunks = (K + kTiedKC - 1) / kTiedKC;

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix row addresses. x: rows lane % 16 of an m16 tile at k offset
  // 8·(lane / 16). Codes: the four 8 x 8 matrices of a pair of n8 tiles
  // (lanes 0-7: rows n .. n+7 at k 0; 8-15: the same rows at k 8; 16-23
  // and 24-31: rows n+8 .. n+15), so r[0], r[1] are the B fragment of the
  // first n8 tile and r[2], r[3] that of the second.
  const int x_off = (lane % 16) * kTiedStride + (lane / 16) * 8;
  const __nv_bfloat16* w_row =
      wt + (warp * 32 + lane % 8 + (lane / 16) * 8) * kTiedStride + ((lane / 8) % 2) * 8;

#pragma unroll
  for (int c = 0; c < kTiedStages - 1; ++c) {
    if (c < n_chunks)
      tied_load_chunk<MT, CODE_BYTES>(smem + c * Smem::kStageBytes, x, q, M, K, V, v0, row0,
                                      c * kTiedKC);
    cp_async_commit();  // one group a chunk, empty past the end: counts stay uniform
  }
  for (int c = 0; c < n_chunks; ++c) {
    unsigned char* stage = smem + (c % kTiedStages) * Smem::kStageBytes;
    cp_async_wait<kTiedStages - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();  // everyone's have; the previous chunk's ldmatrix reads of wt are done
    // codes -> bf16, exactly, 16 at a time
    for (int p = threadIdx.x; p < kTiedN * kTiedKC / 16; p += kThreads) {
      const int r = p / (kTiedKC / 16), col = (p % (kTiedKC / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(stage + r * kTiedKC + col);
      const uint2 p0 = int8_gemv::int8x4_to_bf16x4(raw.x);
      const uint2 p1 = int8_gemv::int8x4_to_bf16x4(raw.y);
      const uint2 p2 = int8_gemv::int8x4_to_bf16x4(raw.z);
      const uint2 p3 = int8_gemv::int8x4_to_bf16x4(raw.w);
      uint4* dst = reinterpret_cast<uint4*>(wt + r * kTiedStride + col);
      dst[0] = make_uint4(p0.x, p0.y, p1.x, p1.y);
      dst[1] = make_uint4(p2.x, p2.y, p3.x, p3.y);
    }
    // the stage read last by chunk c - 1's products takes chunk c + 2
    const int next = c + kTiedStages - 1;
    if (next < n_chunks)
      tied_load_chunk<MT, CODE_BYTES>(smem + (next % kTiedStages) * Smem::kStageBytes, x, q, M,
                                      K, V, v0, row0, next * kTiedKC);
    cp_async_commit();
    __syncthreads();  // wt holds chunk c
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(stage + Smem::kCodeBytes);
#pragma unroll
    for (int ks = 0; ks < kTiedKC / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        int8_gemv::ldmatrix_x4(a[i], xs + i * 16 * kTiedStride + x_off + ks * 16);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t b[4];
        int8_gemv::ldmatrix_x4(b, w_row + jp * 16 * kTiedStride + ks * 16);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          int8_gemv::mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
          int8_gemv::mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  // Epilogue: acc[i][j] holds rows 16i + lane/4 (+8) and vocab rows
  // v0 + 32·warp + 8j + 2·(lane % 4) (+1).
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = v0 + warp * 32 + j * 8 + 2 * (lane % 4);
    const float s0 = v < V ? s[v] : 0.f;
    const float s1 = v + 1 < V ? s[v + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + i * 16 + lane / 4 + 8 * h;
        if (m >= M) continue;
        const float o0 = __bfloat162float(__float2bfloat16_rn(acc[i][j][2 * h])) * s0;
        const float o1 = __bfloat162float(__float2bfloat16_rn(acc[i][j][2 * h + 1])) * s1;
        float* dst = out + size_t(m) * V + v;
        if (V % 2 == 0 && v + 1 < V) {
          *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
        } else {
          if (v < V) dst[0] = o0;
          if (v + 1 < V) dst[1] = o1;
        }
      }
  }
}

template <int MT, int CODE_BYTES>
cudaError_t launch_tied(const __nv_bfloat16* x, const int8_t* q, const float* s, float* out,
                        int M, int K, int V, cudaStream_t st) {
  const int smem = TiedSmem<MT>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(lm_head_tied_kernel<MT, CODE_BYTES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((V + kTiedN - 1) / kTiedN, (M + kTiedRows - 1) / kTiedRows);
  lm_head_tied_kernel<MT, CODE_BYTES><<<grid, kThreads, smem, st>>>(x, q, s, out, M, K, V);
  return cudaGetLastError();
}

// The m16 tiles of x a block holds: enough for min(M, 64) rows.
template <int CODE_BYTES>
cudaError_t dispatch_tied(const __nv_bfloat16* x, const int8_t* q, const float* s, float* out,
                          int M, int K, int V, cudaStream_t st) {
  if (M <= 16) return launch_tied<1, CODE_BYTES>(x, q, s, out, M, K, V, st);
  if (M <= 32) return launch_tied<2, CODE_BYTES>(x, q, s, out, M, K, V, st);
  return launch_tied<4, CODE_BYTES>(x, q, s, out, M, K, V, st);
}

}  // namespace

// Launches on `stream`; returns the CUDA error (0 = launched).
extern "C" int lm_head_int8(const void* x, const void* q, const void* s, void* out, int M, int K,
                            int V, int tied, void* stream) {
  if (M <= 0 || K <= 0 || V <= 0 || K % 8 || (!tied && V % 16)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sb = static_cast<const float*>(s);
  auto* ob = static_cast<float*>(out);
  if (tied)
    return K % 16 == 0 ? dispatch_tied<16>(xb, qb, sb, ob, M, K, V, st)
                       : dispatch_tied<8>(xb, qb, sb, ob, M, K, V, st);
  const size_t smem = int8_gemv::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      lm_head_untied_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((V + int8_gemv::kTileN - 1) / int8_gemv::kTileN, (M + kRows - 1) / kRows);
  lm_head_untied_kernel<<<grid, kThreads, smem, st>>>(xb, qb, sb, ob, M, K, V);
  return cudaGetLastError();
}
