// The int8 weight-streaming FFN of the TPU prototype ffn_pallas
// (_prof_fused_ffn.py:116, body _ffn_kernel :32), for Hopper (sm_90a):
//
//   g = (x . Wg) * sg,  u = (x . Wu) * su      f32 sums, f32 scales
//   h = bf16((g * sigmoid(g)) * u)
//   out = bf16((h . Wd) * sd)
//
// x bf16 [M, d] (M <= 64); Wg, Wu int8 [d, F]; Wd int8 [F, d]; sg, su f32
// [F]; sd f32 [d]; d and F multiples of 128. No norm, no residual. The plain
// version is ops/ffn_int8.ffn_int8_ref.
//
// What bounds it on the card: 3*d*F weight bytes (176 MB at Llama-3-8B's
// d 4,096 and F 14,336) against 2*M flops a byte (128 at M 64), under the
// H100's ~295 bf16 flops a byte: the floor is the weight bytes over
// 3.35 TB/s. The design reads each weight byte once a call.
//
// h is [M, F] bf16 (1.8 MB at M 64, F 14,336). The TPU kernel kept it in
// VMEM; it does not fit in a block's shared memory, so it goes to a device
// workspace between the two phases, which are TWO LAUNCHES of the one
// kernel template below on the caller's stream (no grid-wide barrier):
//   1. gate/up (NW = 2): a block owns one 64-column tile of F and stages
//      the same 128-deep chunk of Wg's and Wu's tile together (codes
//      converted exactly to bf16 in shared memory), so both sums of every
//      output land in one thread and silu(g)*u and its bf16 rounding happen
//      in the epilogue;
//   2. down (NW = 1): h . Wd over 64-column tiles of d, epilogue * sd, bf16.
// Products run on the tensor cores with int8_gemv.cuh's tile (ldmatrix,
// ldmatrix.trans of the [k][n] codes, mma.sync m16n8k16 bf16 -> f32), every
// 16-row group of the up-to-64 rows against each staged chunk. Each phase
// may split its K range over S blocks a tile to fill the card; the block
// that arrives last at a tile (an integer counter, as csrc/int8_matmul.cu)
// adds the S float32 partial sums in split order before the epilogue: no
// float atomics, so the same inputs give the same bits on every run. The
// wrapper picks S (ops/cuda/int8_matmul.plan) from the blocks the card
// holds at once.
//
// Left for later PRs: one launch with a grid barrier, wgmma/TMA streaming,
// and a deeper load pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_gemv.cuh"

namespace {

using int8_gemv::kActStride;
using int8_gemv::kChunkK;
using int8_gemv::kRows;
using int8_gemv::kThreads;
using int8_gemv::kTileN;
using int8_gemv::kWStride;

constexpr int kMaxGroups = 4;  // 16-row groups: 64 rows

template <int RG, int NW>
struct Layout {
  static constexpr int kActBytes = RG * kRows * kActStride * 2;
  static constexpr int kWBytes = kChunkK * kWStride * 2;
  static constexpr int kSmemBytes = kActBytes + NW * kWBytes;
};

// One 128-deep chunk in registers: two 16-byte loads of codes of each of
// the NW weight tiles (row k, columns nq .. nq + 15) and one 16-byte load
// of 8 activations per 16-row group.
template <int RG, int NW>
struct Chunk {
  uint4 w[NW][2];
  uint4 a[RG];
};

template <int RG, int NW>
__device__ __forceinline__ void load_chunk(Chunk<RG, NW>& c, const __nv_bfloat16* __restrict__ A,
                                           int lda, int n_rows, const int8_t* __restrict__ W0,
                                           const int8_t* __restrict__ W1, int N, int n0, int kc) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = tid + j * kThreads;
    const size_t off = size_t(kc + q / (kTileN / 16)) * N + n0 + (q % (kTileN / 16)) * 16;
    c.w[0][j] = __ldg(reinterpret_cast<const uint4*>(W0 + off));
    if constexpr (NW == 2) c.w[1][j] = __ldg(reinterpret_cast<const uint4*>(W1 + off));
  }
  const int k = kc + (tid % (kChunkK / 8)) * 8;
#pragma unroll
  for (int g = 0; g < RG; ++g) {
    const int r = g * kRows + tid / (kChunkK / 8);
    c.a[g] = r < n_rows ? __ldg(reinterpret_cast<const uint4*>(A + size_t(r) * lda + k))
                        : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int RG, int NW>
__device__ __forceinline__ void store_chunk(const Chunk<RG, NW>& c, unsigned char* smem) {
  using L = Layout<RG, NW>;
  const int tid = threadIdx.x;
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int g = 0; g < RG; ++g)
    *reinterpret_cast<uint4*>(act + (g * kRows + tid / (kChunkK / 8)) * kActStride +
                              (tid % (kChunkK / 8)) * 8) = c.a[g];
#pragma unroll
  for (int m = 0; m < NW; ++m) {
    __nv_bfloat16* wts = reinterpret_cast<__nv_bfloat16*>(smem + L::kActBytes + m * L::kWBytes);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = tid + j * kThreads;
      __nv_bfloat16* dst = wts + (q / (kTileN / 16)) * kWStride + (q % (kTileN / 16)) * 16;
      const uint2 p0 = int8_gemv::int8x4_to_bf16x4(c.w[m][j].x);
      const uint2 p1 = int8_gemv::int8x4_to_bf16x4(c.w[m][j].y);
      const uint2 p2 = int8_gemv::int8x4_to_bf16x4(c.w[m][j].z);
      const uint2 p3 = int8_gemv::int8x4_to_bf16x4(c.w[m][j].w);
      reinterpret_cast<uint4*>(dst)[0] = make_uint4(p0.x, p0.y, p1.x, p1.y);
      reinterpret_cast<uint4*>(dst)[1] = make_uint4(p2.x, p2.y, p3.x, p3.y);
    }
  }
}

// The epilogue of one output from its float32 sums: NW = 2, the gate/up
// phase, h = bf16((g * sigmoid(g)) * u); NW = 1, the down phase, bf16(y * sd).
template <int NW>
__device__ __forceinline__ __nv_bfloat16 epilogue(const float (&sum)[NW], const float* s0,
                                                  const float* s1, int n) {
  if constexpr (NW == 2) {
    const float g = sum[0] * s0[n];
    const float u = sum[1] * s1[n];
    return __float2bfloat16((g * (1.f / (1.f + expf(-g)))) * u);
  } else {
    return __float2bfloat16(sum[0] * s0[n]);
  }
}

// Grid (N / 64 column tiles, K splits). out [M, N] bf16; partial [splits,
// NW, M, N] f32 (splits > 1); counters [N / 64], zero between launches.
template <int RG, int NW>
__global__ void __launch_bounds__(kThreads) ffn_int8_kernel(
    const __nv_bfloat16* __restrict__ A, int lda, const int8_t* __restrict__ W0,
    const int8_t* __restrict__ W1, const float* __restrict__ s0, const float* __restrict__ s1,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partial, unsigned* __restrict__ counters,
    int M, int K, int N, int splits, int split_k) {
  using L = Layout<RG, NW>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * kTileN;
  const int split = blockIdx.y;
  const int k_begin = split * split_k;
  const int k_end = min(K, k_begin + split_k);

  const __nv_bfloat16* a_row =
      reinterpret_cast<const __nv_bfloat16*>(smem) + (lane % 16) * kActStride + (lane / 16) * 8;
  const __nv_bfloat16* w_row[NW];
#pragma unroll
  for (int m = 0; m < NW; ++m)
    w_row[m] = reinterpret_cast<const __nv_bfloat16*>(smem + L::kActBytes + m * L::kWBytes) +
               lane * kWStride + warp * 8;
  float acc[NW][RG][4];
#pragma unroll
  for (int m = 0; m < NW; ++m)
#pragma unroll
    for (int g = 0; g < RG; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][g][i] = 0.f;

  // Two register buffers, each refilled with the chunk two ahead right
  // after it is stored; the loop is unrolled by two so no buffer is copied.
  Chunk<RG, NW> b0, b1;
  auto step = [&](Chunk<RG, NW>& c, int kc) {
    __syncthreads();  // the previous chunk's ldmatrix reads are done
    store_chunk<RG, NW>(c, smem);
    __syncthreads();
    if (kc + 2 * kChunkK < k_end) load_chunk<RG, NW>(c, A, lda, M, W0, W1, N, n0, kc + 2 * kChunkK);
#pragma unroll
    for (int ks = 0; ks < kChunkK / 16; ks += 2) {
      uint32_t b[NW][4];
#pragma unroll
      for (int m = 0; m < NW; ++m)
        int8_gemv::ldmatrix_x4_trans(b[m], w_row[m] + ks * 16 * kWStride);  // k-steps ks, ks + 1
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        uint32_t a0[4], a1[4];
        int8_gemv::ldmatrix_x4(a0, a_row + g * kRows * kActStride + ks * 16);
        int8_gemv::ldmatrix_x4(a1, a_row + g * kRows * kActStride + (ks + 1) * 16);
#pragma unroll
        for (int m = 0; m < NW; ++m) {
          int8_gemv::mma_bf16(acc[m][g], a0, b[m][0], b[m][1]);
          int8_gemv::mma_bf16(acc[m][g], a1, b[m][2], b[m][3]);
        }
      }
    }
  };
  load_chunk<RG, NW>(b0, A, lda, M, W0, W1, N, n0, k_begin);
  if (k_begin + kChunkK < k_end) load_chunk<RG, NW>(b1, A, lda, M, W0, W1, N, n0, k_begin + kChunkK);
  for (int kc = k_begin; kc < k_end; kc += 2 * kChunkK) {
    step(b0, kc);
    if (kc + kChunkK < k_end) step(b1, kc + kChunkK);
  }

  if (splits == 1) {
#pragma unroll
    for (int g = 0; g < RG; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g * kRows + int8_gemv::out_row(i);
        const int n = n0 + int8_gemv::out_col(i);
        if (r < M) {
          float sum[NW];
#pragma unroll
          for (int m = 0; m < NW; ++m) sum[m] = acc[m][g][i];
          out[size_t(r) * N + n] = epilogue<NW>(sum, s0, s1, n);
        }
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
      if (r < M) {
#pragma unroll
        for (int m = 0; m < NW; ++m)
          __stcg(partial + ((size_t(split) * NW + m) * M + r) * N + n, acc[m][g][i]);
      }
    }
  __threadfence();  // the partials are visible device-wide before the count
  __syncthreads();
  unsigned* counter = counters + blockIdx.x;
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
      if (r < M) {
        float sum[NW];
#pragma unroll
        for (int m = 0; m < NW; ++m) {
          sum[m] = 0.f;
          for (int s = 0; s < splits; ++s)
            sum[m] += __ldcg(partial + ((size_t(s) * NW + m) * M + r) * N + n);
        }
        out[size_t(r) * N + n] = epilogue<NW>(sum, s0, s1, n);
      }
    }
  if (tid == 0) *counter = 0u;  // ready for the next launch on this stream
}

template <int RG, int NW>
cudaError_t launch(const void* A, int lda, const void* W0, const void* W1, const void* s0,
                   const void* s1, void* out, void* partial, void* counters, int M, int K, int N,
                   int splits, int split_k, cudaStream_t stream) {
  constexpr int smem = Layout<RG, NW>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(ffn_int8_kernel<RG, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kTileN, splits);
  ffn_int8_kernel<RG, NW><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(A), lda, static_cast<const int8_t*>(W0),
      static_cast<const int8_t*>(W1), static_cast<const float*>(s0),
      static_cast<const float*>(s1), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partial), static_cast<unsigned*>(counters), M, K, N, splits, split_k);
  return cudaGetLastError();
}

int row_groups(int M) { return M > 48 ? 4 : (M + kRows - 1) / kRows; }

template <int NW>
cudaError_t launch_rows(const void* A, int lda, const void* W0, const void* W1, const void* s0,
                        const void* s1, void* out, void* partial, void* counters, int M, int K,
                        int N, int splits, int split_k, cudaStream_t s) {
  switch (row_groups(M)) {
    case 1: return launch<1, NW>(A, lda, W0, W1, s0, s1, out, partial, counters, M, K, N, splits, split_k, s);
    case 2: return launch<2, NW>(A, lda, W0, W1, s0, s1, out, partial, counters, M, K, N, splits, split_k, s);
    case 3: return launch<3, NW>(A, lda, W0, W1, s0, s1, out, partial, counters, M, K, N, splits, split_k, s);
    default: return launch<4, NW>(A, lda, W0, W1, s0, s1, out, partial, counters, M, K, N, splits, split_k, s);
  }
}

template <int RG, int NW>
cudaError_t occupancy(int* blocks) {
  constexpr int smem = Layout<RG, NW>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(ffn_int8_kernel<RG, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ffn_int8_kernel<RG, NW>, kThreads,
                                                       smem);
}

bool split_ok(int K, int splits, int split_k) {
  return splits > 0 && split_k > 0 && split_k % kChunkK == 0 &&
         (long long)splits * split_k >= K && (long long)(splits - 1) * split_k < K;
}

}  // namespace

// How many blocks of the gate/up (nw = 2) or down (nw = 1) phase for M rows
// fit on one SM at once, into *blocks.
extern "C" int ffn_int8_blocks_per_sm(int M, int nw, int* blocks) {
  if (M <= 0 || blocks == nullptr || (nw != 1 && nw != 2)) return cudaErrorInvalidValue;
  switch (row_groups(M) * 2 + (nw - 1)) {
    case 2: return occupancy<1, 1>(blocks);
    case 3: return occupancy<1, 2>(blocks);
    case 4: return occupancy<2, 1>(blocks);
    case 5: return occupancy<2, 2>(blocks);
    case 6: return occupancy<3, 1>(blocks);
    case 7: return occupancy<3, 2>(blocks);
    case 8: return occupancy<4, 1>(blocks);
    default: return occupancy<4, 2>(blocks);
  }
}

// out [M, d] bf16 = the FFN of x [M, d]. h: [M, F] bf16 workspace. The
// gate/up phase splits K = d into splits1 ranges of split_k1, the down phase
// K = F into splits2 of split_k2 (multiples of 128 that together cover K,
// each non-empty); with splits > 1, partial1 holds splits1 * 2 * M * F
// floats and partial2 splits2 * M * d, and counters F / 64 + d / 64 zeroed
// words (each phase's last blocks leave them zeroed). Two launches on
// `stream`; returns cudaGetLastError() after the first that failed, or
// after the second (0 = both launched).
extern "C" int ffn_int8(const void* x, const void* wg, const void* wu, const void* wd,
                        const void* sg, const void* su, const void* sd, void* h, void* out,
                        void* partial1, void* partial2, void* counters, int M, int d, int F,
                        int splits1, int split_k1, int splits2, int split_k2, void* stream) {
  if (M <= 0 || M > kMaxGroups * kRows || d <= 0 || F <= 0 || d % kChunkK != 0 ||
      F % kChunkK != 0)
    return cudaErrorInvalidValue;
  if (!split_ok(d, splits1, split_k1) || !split_ok(F, splits2, split_k2))
    return cudaErrorInvalidValue;
  if ((splits1 > 1 && partial1 == nullptr) || (splits2 > 1 && partial2 == nullptr) ||
      counters == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* cnt = static_cast<unsigned*>(counters);
  cudaError_t err = launch_rows<2>(x, d, wg, wu, sg, su, h, partial1, cnt, M, d, F, splits1,
                                   split_k1, s);
  if (err != cudaSuccess) return err;
  return launch_rows<1>(h, F, wd, nullptr, sd, nullptr, out, partial2, cnt + F / kTileN, M, F, d,
                        splits2, split_k2, s);
}
