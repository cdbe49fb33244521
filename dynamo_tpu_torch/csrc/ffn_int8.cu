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
// workspace between the two products, which are TWO LAUNCHES on the
// caller's stream (h must be whole before the down product reads it). Both
// are int8_stream.cuh's streaming product (the int8 product's kernel,
// csrc/int8_matmul.cu): 128-column tiles, the codes and x's slices by 2-D
// tensor copies from a producer warp through a ring of four stages, the
// codes made exact bf16 fragments on the way to mma.sync, K split over the
// blocks of a thread block cluster and summed in split order through
// distributed shared memory (no float atomics: the same bits every run).
//   1. gate/up: each stage holds the same 128-deep chunk of Wg's and Wu's
//      tile (two tensor maps), so one block holds both sums of a column;
//      after the split sums silu(g * sg) * (u * su) is rounded to bf16 in
//      the epilogue;
//   2. down: h . Wd, its f32 sum times sd rounded once to bf16 (the
//      prototype's point; qeinsum's epilogue rounds the sum before the
//      scale).
// The wrapper (ops/cuda/ffn_int8.py) takes each launch's split from the
// int8 product's plan and the card's cluster capacity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_stream.cuh"

using namespace int8_stream;

// out [M, d] bf16 = the FFN of x [M, d]. h: [M, F] bf16 workspace. The
// gate/up launch splits K = d into splits1 ranges of split_k1, the down
// launch K = F into splits2 of split_k2 (multiples of 128 that together
// cover K, each non-empty, at most 8: one cluster). Two launches on
// `stream`; returns the first launch error, or 0 when both launched.
extern "C" int ffn_int8(const void* x, const void* wg, const void* wu, const void* wd,
                        const void* sg, const void* su, const void* sd, void* h, void* out, int M,
                        int d, int F, int splits1, int split_k1, int splits2, int split_k2,
                        void* stream) {
  if (M <= 0 || M > kMaxGroups * kRows || d <= 0 || F <= 0 || d % kChunkK != 0 ||
      F % kChunkK != 0)
    return cudaErrorInvalidValue;
  if (!split_ok(d, splits1, split_k1) || !split_ok(F, splits2, split_k2))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rg = (M + kRows - 1) / kRows;
  cudaError_t err = launch_rows<2, kSwiGLU>(rg, x, wg, wu, sg, su, h, M, d, F, splits1, split_k1, s);
  if (err != cudaSuccess) return err;
  return launch_rows<1, kScaled>(rg, h, wd, nullptr, sd, nullptr, out, M, F, d, splits2, split_k2,
                                 s);
}
