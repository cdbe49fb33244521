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
//
// The kernel, its ring, fragment builder and tensor maps are
// int8_stream.cuh's stream_kernel (one matrix a stage), which the int8 FFN
// and the fused decoder layer share; this file instantiates its raw and
// qeinsum epilogues and asks the card for its cluster capacity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_stream.cuh"

using namespace int8_stream;

// How many clusters of `splits` blocks (blocks, for splits 1) of the kernel
// the card holds at once, with two blocks an SM (their registers allow it
// up to 32 rows, and a small x: `two_per_sm`) or one (a large x), into *n.
// A cluster's blocks share a GPC, so fewer than SMs / splits are held where
// a GPC's SMs are not a multiple of splits.
extern "C" int int8_matmul_capacity(int splits, int two_per_sm, int* n) {
  if (splits < 1 || splits > kMaxSplits || n == nullptr) return cudaErrorInvalidValue;
  const auto kernel = stream_kernel<2, 1, kQeinsum>;
  cudaError_t err = allow_smem<2, 1, kQeinsum>();
  if (err != cudaSuccess) return err;
  const size_t smem = two_per_sm ? smem_bytes(2 * kRows, 1, 1)
                                 : size_t(kAlign) + ring_bytes(1) + max_x_bytes(1);
  if (splits == 1) {
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
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
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

// out = x[M, K] @ w[K, N]: float32 [M, N] when scale is null; else bf16
// [M, N] = bf16(bf16(sum) * scale[n]). A block takes block_rows (16, 32,
// 48 or 64) rows of x; K splits: `splits` (at most kMaxSplits, one
// cluster) ranges of `split_k` (a multiple of 128) that together cover K,
// each non-empty. Returns the launch's error (0 = launched).
extern "C" int int8_matmul(const void* x, const void* w, const void* scale, void* out, int M,
                           int K, int N, int splits, int split_k, int block_rows, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 16 != 0) return cudaErrorInvalidValue;
  if (block_rows <= 0 || block_rows % kRows != 0 || block_rows > kMaxGroups * kRows)
    return cudaErrorInvalidValue;
  if (!split_ok(K, splits, split_k)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rg = block_rows / kRows;
  if (scale != nullptr)
    return launch_rows<1, kQeinsum>(rg, x, w, nullptr, scale, nullptr, out, M, K, N, splits,
                                    split_k, s);
  return launch_rows<1, kRaw>(rg, x, w, nullptr, nullptr, nullptr, out, M, K, N, splits, split_k,
                              s);
}
