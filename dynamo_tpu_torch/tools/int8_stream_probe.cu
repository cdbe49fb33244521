// Measurement kernels for the int8 weight-streaming product (not on any
// serving path; built and run by tools/int8_stream_probe.py on the card):
//
//   * stream_copy<SEG>: reads [K, N] int8 codes in SEG-byte segments of each
//     row (SEG 64, 128 or 256), a block a column segment and a K range, with
//     16-byte loads, four in flight a thread, and folds them into one word a
//     block: the rate at which the card streams codes at that segment width,
//     with no products and no staging.
//   * old_int8_matmul: the 64-column product kernel that csrc/int8_matmul.cu
//     replaced (a block owns 64 columns; codes and x staged through three
//     register buffers, two barriers a chunk, x reloaded for every chunk;
//     the K split's tail as today's), kept so that the probe can time it
//     beside the wide-tile kernel on the same card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace probe {

template <int SEG>
__global__ void __launch_bounds__(256) stream_copy(const int8_t* __restrict__ w,
                                                   unsigned* __restrict__ sink, int K, int N,
                                                   int rows_per_block) {
  constexpr int kLanes = SEG / 16;         // 16-byte loads a row segment
  constexpr int kRowsAtOnce = 256 / kLanes;
  const int col = blockIdx.x * SEG + (threadIdx.x % kLanes) * 16;
  const int k0 = blockIdx.y * rows_per_block;
  const int k1 = min(K, k0 + rows_per_block);
  uint32_t acc = 0;
  int k = k0 + threadIdx.x / kLanes;
  for (; k + 3 * kRowsAtOnce < k1; k += 4 * kRowsAtOnce) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = __ldg(reinterpret_cast<const uint4*>(w + size_t(k + u * kRowsAtOnce) * N + col));
#pragma unroll
    for (int u = 0; u < 4; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  for (; k < k1; k += kRowsAtOnce) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(w + size_t(k) * N + col));
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, o);
  if (threadIdx.x % 32 == 0) atomicXor(sink + blockIdx.y * gridDim.x + blockIdx.x, acc);
}

}  // namespace probe

// Streams w [K, N] (N a multiple of seg) in seg-byte segments: grid (N / seg,
// ceil(K / rows_per_block)); sink holds a word a block.
extern "C" int stream_copy(const void* w, void* sink, int K, int N, int seg, int rows_per_block,
                           void* stream) {
  if (N % seg || rows_per_block <= 0) return cudaErrorInvalidValue;
  const dim3 grid(N / seg, (K + rows_per_block - 1) / rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const int8_t*>(w);
  auto* sp = static_cast<unsigned*>(sink);
  if (seg == 64) probe::stream_copy<64><<<grid, 256, 0, s>>>(wp, sp, K, N, rows_per_block);
  else if (seg == 128) probe::stream_copy<128><<<grid, 256, 0, s>>>(wp, sp, K, N, rows_per_block);
  else if (seg == 256) probe::stream_copy<256><<<grid, 256, 0, s>>>(wp, sp, K, N, rows_per_block);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_gemv.cuh"  // the tile helpers the parent kernel used

namespace {

using int8_gemv::kActStride;
using int8_gemv::kChunkK;
using int8_gemv::kRows;
using int8_gemv::kThreads;
using int8_gemv::kTileN;
using int8_gemv::kWStride;

constexpr int kMaxGroups = 4;  // 16-row groups a block holds: 64 rows

template <int RG>
struct Layout {
  static constexpr int kActBytes = RG * kRows * kActStride * 2;
  static constexpr int kSmemBytes = kActBytes + kChunkK * kWStride * 2;
};

// One 128-deep chunk in registers: two 16-byte loads of codes (row k,
// columns nq .. nq + 15) and one 16-byte load of 8 activations per group.
template <int RG>
struct Chunk {
  uint4 w[2];
  uint4 a[RG];
};

template <int RG>
__device__ __forceinline__ void load_chunk(Chunk<RG>& c, const __nv_bfloat16* __restrict__ x,
                                           int K, int n_rows, const int8_t* __restrict__ w, int N,
                                           int n0, int kc, int k_end) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = tid + j * kThreads;
    const int k = kc + q / (kTileN / 16);
    const int col = n0 + (q % (kTileN / 16)) * 16;
    c.w[j] = (k < k_end && col < N)
                 ? __ldg(reinterpret_cast<const uint4*>(w + size_t(k) * N + col))
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  const int k = kc + (tid % (kChunkK / 8)) * 8;
#pragma unroll
  for (int g = 0; g < RG; ++g) {
    const int r = g * kRows + tid / (kChunkK / 8);
    c.a[g] = (r < n_rows && k < k_end)
                 ? __ldg(reinterpret_cast<const uint4*>(x + size_t(r) * K + k))
                 : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int RG>
__device__ __forceinline__ void store_chunk(const Chunk<RG>& c, unsigned char* smem) {
  const int tid = threadIdx.x;
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wts = reinterpret_cast<__nv_bfloat16*>(smem + Layout<RG>::kActBytes);
#pragma unroll
  for (int g = 0; g < RG; ++g)
    *reinterpret_cast<uint4*>(act + (g * kRows + tid / (kChunkK / 8)) * kActStride +
                              (tid % (kChunkK / 8)) * 8) = c.a[g];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = tid + j * kThreads;
    __nv_bfloat16* dst = wts + (q / (kTileN / 16)) * kWStride + (q % (kTileN / 16)) * 16;
    const uint2 p0 = int8_gemv::int8x4_to_bf16x4(c.w[j].x);
    const uint2 p1 = int8_gemv::int8x4_to_bf16x4(c.w[j].y);
    const uint2 p2 = int8_gemv::int8x4_to_bf16x4(c.w[j].z);
    const uint2 p3 = int8_gemv::int8x4_to_bf16x4(c.w[j].w);
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(p0.x, p0.y, p1.x, p1.y);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(p2.x, p2.y, p3.x, p3.y);
  }
}

// Grid (column tiles, K splits, 64-row groups). Each thread ends holding
// the sums of RG x 4 outputs in the mma accumulator layout
// (int8_gemv::out_row / out_col of its warp's 8 columns).
template <int RG, bool SCALED>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(
    const __nv_bfloat16* __restrict__ x,  // [M, K]
    const int8_t* __restrict__ w,         // [K, N]
    const float* __restrict__ scale,      // [N] (SCALED), else null
    float* __restrict__ out_f32,          // [M, N] (not SCALED)
    __nv_bfloat16* __restrict__ out_bf16, // [M, N] (SCALED)
    float* __restrict__ partial,          // [splits, M, N] (splits > 1)
    unsigned* __restrict__ counters,      // [tiles x row groups], zero between launches
    int M, int K, int N, int splits, int split_k) {
  __shared__ __align__(16) unsigned char smem[Layout<RG>::kSmemBytes];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * kTileN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kMaxGroups * kRows;
  const int n_rows = min(RG * kRows, M - m0);
  const int k_begin = split * split_k;
  const int k_end = min(K, k_begin + split_k);
  const __nv_bfloat16* xb = x + size_t(m0) * K;

  const __nv_bfloat16* act = reinterpret_cast<const __nv_bfloat16*>(smem);
  const __nv_bfloat16* wts = reinterpret_cast<const __nv_bfloat16*>(smem + Layout<RG>::kActBytes);
  const __nv_bfloat16* a_row = act + (lane % 16) * kActStride + (lane / 16) * 8;
  const __nv_bfloat16* w_row = wts + lane * kWStride + warp * 8;
  // two accumulators a group (even and odd k-steps) halve the mma chains
  float c0[RG][4], c1[RG][4];
#pragma unroll
  for (int g = 0; g < RG; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) c0[g][i] = c1[g][i] = 0.f;

  // Three register buffers, each refilled with the chunk three ahead right
  // after it is stored (as int8_gemv::tile_sums), unrolled by three so no
  // buffer is copied.
  Chunk<RG> b0, b1, b2;
  auto step = [&](Chunk<RG>& c, int kc) {
    __syncthreads();  // the previous chunk's ldmatrix reads are done
    store_chunk<RG>(c, smem);
    __syncthreads();
    if (kc + 3 * kChunkK < k_end) load_chunk<RG>(c, xb, K, n_rows, w, N, n0, kc + 3 * kChunkK, k_end);
#pragma unroll
    for (int ks = 0; ks < kChunkK / 16; ks += 2) {
      uint32_t b[4];
      int8_gemv::ldmatrix_x4_trans(b, w_row + ks * 16 * kWStride);  // k-steps ks, ks + 1
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        uint32_t a0[4], a1[4];
        int8_gemv::ldmatrix_x4(a0, a_row + g * kRows * kActStride + ks * 16);
        int8_gemv::ldmatrix_x4(a1, a_row + g * kRows * kActStride + (ks + 1) * 16);
        int8_gemv::mma_bf16(c0[g], a0, b[0], b[1]);
        int8_gemv::mma_bf16(c1[g], a1, b[2], b[3]);
      }
    }
  };
  if (k_begin < k_end) load_chunk<RG>(b0, xb, K, n_rows, w, N, n0, k_begin, k_end);
  if (k_begin + kChunkK < k_end) load_chunk<RG>(b1, xb, K, n_rows, w, N, n0, k_begin + kChunkK, k_end);
  if (k_begin + 2 * kChunkK < k_end)
    load_chunk<RG>(b2, xb, K, n_rows, w, N, n0, k_begin + 2 * kChunkK, k_end);
  for (int kc = k_begin; kc < k_end; kc += 3 * kChunkK) {
    step(b0, kc);
    if (kc + kChunkK < k_end) step(b1, kc + kChunkK);
    if (kc + 2 * kChunkK < k_end) step(b2, kc + 2 * kChunkK);
  }

  auto emit = [&](int m, int n, float sum) {
    if constexpr (SCALED) {
      const float rounded = __bfloat162float(__float2bfloat16(sum));
      out_bf16[size_t(m) * N + n] = __float2bfloat16(rounded * scale[n]);
    } else {
      out_f32[size_t(m) * N + n] = sum;
    }
  };

  if (splits == 1) {
#pragma unroll
    for (int g = 0; g < RG; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g * kRows + int8_gemv::out_row(i);
        const int n = n0 + int8_gemv::out_col(i);
        if (r < n_rows && n < N) emit(m0 + r, n, c0[g][i] + c1[g][i]);
      }
    return;
  }

  // K split: this block's partial sums, then the tile's last block adds
  // all S of them in split order.
#pragma unroll
  for (int g = 0; g < RG; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g * kRows + int8_gemv::out_row(i);
      const int n = n0 + int8_gemv::out_col(i);
      if (r < n_rows && n < N)
        __stcg(partial + (size_t(split) * M + m0 + r) * N + n, c0[g][i] + c1[g][i]);
    }
  __threadfence();  // the partials are visible device-wide before the count
  __syncthreads();
  unsigned* counter = counters + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(counter, 1u) == unsigned(splits - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int g = 0; g < RG; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g * kRows + int8_gemv::out_row(i);
      const int n = n0 + int8_gemv::out_col(i);
      if (r < n_rows && n < N) {
        float sum = 0.f;
        for (int s = 0; s < splits; ++s) sum += __ldcg(partial + (size_t(s) * M + m0 + r) * N + n);
        emit(m0 + r, n, sum);
      }
    }
  if (tid == 0) *counter = 0u;  // ready for the next launch on this stream
}

template <int RG, bool SCALED>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, void* partial,
                   void* counters, int M, int K, int N, int splits, int split_k,
                   cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, splits,
                  (M + kMaxGroups * kRows - 1) / (kMaxGroups * kRows));
  int8_matmul_kernel<RG, SCALED><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), SCALED ? nullptr : static_cast<float*>(out),
      SCALED ? static_cast<__nv_bfloat16*>(out) : nullptr, static_cast<float*>(partial),
      static_cast<unsigned*>(counters), M, K, N, splits, split_k);
  return cudaGetLastError();
}

// The 16-row groups of one block for M rows: up to 64 rows; more rows,
// more blocks.
int row_groups(int M) { return M > 48 ? 4 : (M + kRows - 1) / kRows; }

template <bool SCALED>
cudaError_t launch_rows(const void* x, const void* w, const void* scale, void* out,
                        void* partial, void* counters, int M, int K, int N, int splits,
                        int split_k, cudaStream_t s) {
  switch (row_groups(M)) {
    case 1: return launch<1, SCALED>(x, w, scale, out, partial, counters, M, K, N, splits, split_k, s);
    case 2: return launch<2, SCALED>(x, w, scale, out, partial, counters, M, K, N, splits, split_k, s);
    case 3: return launch<3, SCALED>(x, w, scale, out, partial, counters, M, K, N, splits, split_k, s);
    default: return launch<4, SCALED>(x, w, scale, out, partial, counters, M, K, N, splits, split_k, s);
  }
}

template <int RG, bool SCALED>
cudaError_t occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, int8_matmul_kernel<RG, SCALED>,
                                                       kThreads, 0);
}

}  // namespace

extern "C" int old_int8_matmul_blocks_per_sm(int M, int scaled, int* blocks) {
  if (M <= 0 || blocks == nullptr) return cudaErrorInvalidValue;
  switch (row_groups(M) * 2 + (scaled ? 1 : 0)) {
    case 2: return occupancy<1, false>(blocks);
    case 3: return occupancy<1, true>(blocks);
    case 4: return occupancy<2, false>(blocks);
    case 5: return occupancy<2, true>(blocks);
    case 6: return occupancy<3, false>(blocks);
    case 7: return occupancy<3, true>(blocks);
    case 8: return occupancy<4, false>(blocks);
    default: return occupancy<4, true>(blocks);
  }
}

// out = x[M, K] @ w[K, N]: float32 [M, N] when scale is null; else bf16
// [M, N] = bf16(bf16(sum) * scale[n]). K splits: `splits` ranges of
// `split_k` (a multiple of 128) that together cover K, each non-empty;
// with splits > 1, partial holds splits * M * N floats and counters
// ceil(N / 64) * ceil(M / 64) zeroed words. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int old_int8_matmul(const void* x, const void* w, const void* scale, void* out,
                           void* partial, void* counters, int M, int K, int N, int splits,
                           int split_k, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 16 != 0) return cudaErrorInvalidValue;
  if (splits <= 0 || split_k <= 0 || split_k % kChunkK != 0 ||
      (long long)splits * split_k < K || (long long)(splits - 1) * split_k >= K)
    return cudaErrorInvalidValue;
  if (splits > 1 && (partial == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scale != nullptr)
    return launch_rows<true>(x, w, scale, out, partial, counters, M, K, N, splits, split_k, s);
  return launch_rows<false>(x, w, scale, out, partial, counters, M, K, N, splits, split_k, s);
}
