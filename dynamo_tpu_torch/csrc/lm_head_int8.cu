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
// Weight-streaming: every column tile (untied) or vocab row (tied) of the
// head is read once for a group of 16 rows of x; M > 16 takes more row
// groups on the grid's second axis:
//   * untied: int8_gemv.cuh's tile on the tensor cores (64 vocab columns,
//     all of K), then the epilogue;
//   * tied: on CUDA cores, a warp takes 4 vocab rows, each lane 8
//     consecutive k of every 256-wide chunk (one 8-byte load per row), x
//     staged in shared memory; the lanes' sums are added by warp shuffles.

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

constexpr int kTiedChunk = 256;  // k per staged chunk: 32 lanes x 8
constexpr int kTiedRowsPerWarp = 4;
constexpr int kTiedVocabPerBlock = kTiedRowsPerWarp * kThreads / 32;

__global__ void __launch_bounds__(kThreads, 1)
    lm_head_tied_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                        const float* __restrict__ s, float* __restrict__ out, int M, int K,
                        int V) {
  // xs[m][half][lane][4]: lane l's k = 8l .. 8l+7 of a chunk sit at
  // [m][0][l] (first four) and [m][1][l] (last four), so a warp's 16-byte
  // reads are contiguous.
  __shared__ __align__(16) float xs[kRows * kTiedChunk];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int v0 = blockIdx.x * kTiedVocabPerBlock + warp * kTiedRowsPerWarp;
  const int row0 = blockIdx.y * kRows;
  const int n_rows = min(kRows, M - row0);
  float acc[kTiedRowsPerWarp][kRows];
#pragma unroll
  for (int i = 0; i < kTiedRowsPerWarp; ++i)
#pragma unroll
    for (int m = 0; m < kRows; ++m) acc[i][m] = 0.f;

  for (int kc = 0; kc < K; kc += kTiedChunk) {
    __syncthreads();
    for (int e = threadIdx.x; e < kRows * kTiedChunk; e += kThreads) {
      const int m = e / kTiedChunk, kk = e % kTiedChunk;
      const int k = kc + kk;
      const float v = (m < n_rows && k < K) ? __bfloat162float(x[size_t(row0 + m) * K + k]) : 0.f;
      const int l = kk / 8, j = kk % 8;
      xs[m * kTiedChunk + (j / 4) * 128 + l * 4 + j % 4] = v;
    }
    __syncthreads();
    const int k = kc + lane * 8;
    float w[kTiedRowsPerWarp][8];
#pragma unroll
    for (int i = 0; i < kTiedRowsPerWarp; ++i) {
      const int v = v0 + i;
      const uint2 raw = (v < V && k < K)
                            ? __ldg(reinterpret_cast<const uint2*>(q + size_t(v) * K + k))
                            : make_uint2(0u, 0u);
      int8_gemv::int8x4_to_float(raw.x, &w[i][0]);
      int8_gemv::int8x4_to_float(raw.y, &w[i][4]);
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const float4 a = *reinterpret_cast<const float4*>(xs + m * kTiedChunk + lane * 4);
      const float4 b = *reinterpret_cast<const float4*>(xs + m * kTiedChunk + 128 + lane * 4);
#pragma unroll
      for (int i = 0; i < kTiedRowsPerWarp; ++i)
        acc[i][m] += a.x * w[i][0] + a.y * w[i][1] + a.z * w[i][2] + a.w * w[i][3] +
                     b.x * w[i][4] + b.y * w[i][5] + b.z * w[i][6] + b.w * w[i][7];
    }
  }
#pragma unroll
  for (int i = 0; i < kTiedRowsPerWarp; ++i) {
    const int v = v0 + i;
    float mine = 0.f;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      float t = acc[i][m];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
      if (lane == m) mine = t;
    }
    if (lane < n_rows && v < V)
      out[size_t(row0 + lane) * V + v] = __bfloat162float(__float2bfloat16_rn(mine)) * s[v];
  }
}

}  // namespace

// Launches on `stream`; returns the CUDA error (0 = launched).
extern "C" int lm_head_int8(const void* x, const void* q, const void* s, void* out, int M, int K,
                            int V, int tied, void* stream) {
  if (M <= 0 || K <= 0 || V <= 0 || K % 8 || (!tied && V % 16)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (M + kRows - 1) / kRows;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sb = static_cast<const float*>(s);
  auto* ob = static_cast<float*>(out);
  if (tied) {
    const dim3 grid((V + kTiedVocabPerBlock - 1) / kTiedVocabPerBlock, groups);
    lm_head_tied_kernel<<<grid, kThreads, 0, st>>>(xb, qb, sb, ob, M, K, V);
  } else {
    const size_t smem = int8_gemv::kSmemBytes;
    cudaError_t err = cudaFuncSetAttribute(
        lm_head_untied_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((V + int8_gemv::kTileN - 1) / int8_gemv::kTileN, groups);
    lm_head_untied_kernel<<<grid, kThreads, smem, st>>>(xb, qb, sb, ob, M, K, V);
  }
  return cudaGetLastError();
}
