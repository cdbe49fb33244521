// Decode attention with bf16 operands and bf16 probabilities over a bf16
// block pool, for Hopper (sm_90a): the two TPU prototypes of _prof_attn.py,
// which compute one function in two work splits.
//
//   * decode_packed  <- decode_packed (_prof_attn.py:113, body
//     _decode_kernel_packed :22). One thread block per sequence holds all
//     R = KH*G query rows; each staged key is scored against every row of
//     its KV head. The TPU kernel packs the rows block-diagonally so that a
//     page's scores are one MXU product [bs, KH*D] x [KH*D, R]; that
//     packing multiplies by zero blocks to suit the MXU, and is not copied:
//     here each (key, head) pair is scored against its own G rows only.
//   * decode_bf16    <- decode_bf16 (_prof_attn.py:312, body
//     _decode_kernel_bf16 :244). One thread block per (sequence, KV head)
//     holds that head's G rows: KH times the blocks of decode_packed, each
//     staging one head's slice of the keys.
//
// Both keep the prototypes' rounding points, which differ from the serving
// kernels' (csrc/paged_attention.cu, f32 probabilities): q and K/V are bf16
// and every product is exact in f32; scores are f32, times sm_scale, then
// the optional softcap cap*tanh(s/cap), then key t is visible iff
// t <= start (and t > start - W with a window W > 0), else -1e30 (finite:
// an all-masked tile stays finite and is wiped by the next alpha = 0). Per
// row an online softmax over the key tiles: m, alpha = exp(m_old - m_new),
// probabilities exp(s - m_new) rounded to bf16, the row sum l taken over
// the ROUNDED probabilities, acc = acc*alpha + P.V with the bf16
// probabilities; out = bf16(acc / max(l, 1e-30)). The plain version is
// ops/attention.decode_attention_bf16_ref (one global max, so the bf16
// roundings of the probabilities fall at other points: the two agree within
// a bf16 step of the output).
//
// What bounds it on the card: each live K/V byte is read once (2 * keys *
// KH * D * 2 bytes a sequence) for ~2 flops a byte per query row, far
// under the H100's ~295 bf16 flops a byte: the floor is the memory rate
// (3.35 TB/s).
//
// This simple design: the block walks the keys from the first visible one
// (start - W + 1 with a window, as first_needed at _prof_attn.py:63-66,
// but to the key rather than the page) to `start`, in tiles of TILE keys.
// A page may be wider than a tile (block size 128 at Llama-3-8B: a page of
// one sequence is 128 keys x 8 heads x 128 x 2 B = 256 KB of K, more than
// a block's shared memory), so each key finds its own page. Tiles are
// staged by cp.async into two shared-memory buffers: the next tile's copy
// runs while the current one is scored. Keys outside the visible range
// are zero-filled, not read. TILE x (heads a block) x D is 16,384 values,
// so TILE is 16 keys for decode_packed at Llama-3-8B (KH 8, D 128) and
// Gemma-2 (KH 4, D 256), 64 at Gemma-3 (KH 1, D 256) and 128 for
// decode_bf16 at D 128. Scores, softmax and P.V run on CUDA cores in f32:
//   scores: thread = (key, head) pair, dotting the staged key with the
//           head's G query rows (q in f32 in shared memory);
//   softmax: one warp per row;
//   P.V: thread = (head, column pair), accumulating the head's G rows in
//        registers; with fewer than 256 column pairs the keys are split
//        among thread groups whose partial sums are added at the end.
//
// Left for later PRs: split-K over the keys so that B blocks fill 132
// SMs, mma for the two products, TMA page streaming.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;            // query rows of a KV head
constexpr int kMaxRows = 64;        // query rows a block
constexpr int kMaxWidth = 2048;     // heads a block x D
constexpr int kTileValues = 16384;  // bf16 values of one staged K (or V) tile
constexpr int kMaxTile = 128;
constexpr float kNegInf = -1e30f;

// Shared-memory layout for R rows of D, a tile of `tile` keys x `width`
// values: q (f32), K and V in two buffers each (bf16, rows padded by 8
// values so that 16-byte reads of neighbouring keys do not share banks),
// the tile's scores / probabilities (f32), and per row m, l and alpha.
struct Smem {
  int tile, width, stride, pstride;
  size_t kv_bytes, q_off, k_off[2], v_off[2], p_off, stat_off, total;
  __host__ __device__ Smem(int R, int D, int tile_, int width_)
      : tile(tile_), width(width_), stride(width_ + 8), pstride(tile_ + 4) {
    kv_bytes = size_t(tile) * stride * 2;
    q_off = 0;
    k_off[0] = q_off + size_t(R) * D * 4;
    k_off[1] = k_off[0] + kv_bytes;
    v_off[0] = k_off[1] + kv_bytes;
    v_off[1] = v_off[0] + kv_bytes;
    p_off = v_off[1] + kv_bytes;
    stat_off = p_off + size_t(R) * pstride * 4;
    total = stat_off + 3 * size_t(R) * 4;
  }
};

// Keys a tile for `width` values a key: a power of two, at most kMaxTile.
__host__ __device__ inline int tile_keys(int width) {
  int t = kMaxTile;
  while (t > 1 && t * width > kTileValues) t >>= 1;
  return t;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled, src is not read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of key tile `tidx` (keys tidx*tile ...) of heads
// [h0, h0 + NH) into kb / vb. Keys outside [first_key, last_key], and keys
// whose table entry is out of range, are zero-filled.
__device__ __forceinline__ void issue_tile(__nv_bfloat16* kb, __nv_bfloat16* vb,
                                           const __nv_bfloat16* __restrict__ k_cache,
                                           const __nv_bfloat16* __restrict__ v_cache,
                                           const int32_t* __restrict__ table_row, int tidx,
                                           const Smem& L, int first_key, int last_key, int NB,
                                           int BS, int KH, int h0, int D) {
  const int vecs = L.width / 8;  // 16-byte copies a key
  const int total = L.tile * vecs;
  for (int c = threadIdx.x; c < total; c += kThreads) {
    const int t = c / vecs;
    const int col = (c % vecs) * 8;
    const int kp = tidx * L.tile + t;
    bool valid = kp >= first_key && kp <= last_key;
    size_t off = 0;
    if (valid) {
      const int blk = table_row[kp / BS];
      valid = blk >= 0 && blk < NB;
      off = ((size_t(valid ? blk : 0) * BS + kp % BS) * KH + h0) * D + col;
    }
    cp_async16(kb + t * L.stride + col, k_cache + off, valid);
    cp_async16(vb + t * L.stride + col, v_cache + off, valid);
  }
}

template <int D, bool PACKED>
__global__ void __launch_bounds__(kThreads) decode_attention_proto_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, 1, H, D]
    const __nv_bfloat16* __restrict__ k_cache,  // [NB, BS, KH, D]
    const __nv_bfloat16* __restrict__ v_cache,  // [NB, BS, KH, D]
    const int32_t* __restrict__ block_tables,   // [B, P]
    const int32_t* __restrict__ start_pos,      // [B]
    __nv_bfloat16* __restrict__ out,            // [B, 1, H, D]
    int H, int KH, int NB, int BS, int P, int window, float sm_scale, float logit_cap) {
  // P.V: column pairs of the block's heads, at most kIters a thread.
  constexpr int kIters = PACKED ? kMaxWidth / 2 / kThreads : 1;
  const int NH = PACKED ? KH : 1;
  const int G = H / KH;
  const int R = NH * G;
  const int width = NH * D;
  const Smem L(R, D, tile_keys(width), width);
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L.q_off);
  __nv_bfloat16* kbuf[2] = {reinterpret_cast<__nv_bfloat16*>(smem + L.k_off[0]),
                            reinterpret_cast<__nv_bfloat16*>(smem + L.k_off[1])};
  __nv_bfloat16* vbuf[2] = {reinterpret_cast<__nv_bfloat16*>(smem + L.v_off[0]),
                            reinterpret_cast<__nv_bfloat16*>(smem + L.v_off[1])};
  float* ps = reinterpret_cast<float*>(smem + L.p_off);
  float* m_s = reinterpret_cast<float*>(smem + L.stat_off);
  float* l_s = m_s + R;
  float* a_s = l_s + R;

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * NH;  // first KV head of this block
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int start = start_pos[b];
  const int32_t* table_row = block_tables + size_t(b) * P;
  const size_t row0 = (size_t(b) * H + size_t(h0) * G) * D;  // q/out offset of row 0

  for (int e = tid; e < R * D; e += kThreads) qs[e] = __bfloat162float(q[row0 + e]);
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int first_key = window > 0 ? max(start - window + 1, 0) : 0;
  const int last_key = min(start, P * BS - 1);
  const int tile_first = first_key / L.tile;
  const int n_tiles = last_key >= first_key ? last_key / L.tile - tile_first + 1 : 0;

  // P.V work split: `units` column pairs; with fewer than kThreads of them,
  // kg key groups share the keys and add their partial sums at the end.
  const int units = width / 2;
  const int KG = units >= kThreads ? 1 : kThreads / units;
  const int kg = units >= kThreads ? 0 : tid / units;
  const bool pv_active = kg < KG;
  float2 acc[kIters][kMaxG];
#pragma unroll
  for (int i = 0; i < kIters; ++i)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[i][g] = make_float2(0.f, 0.f);

  if (n_tiles > 0)
    issue_tile(kbuf[0], vbuf[0], k_cache, v_cache, table_row, tile_first, L, first_key, last_key,
               NB, BS, KH, h0, D);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int tidx = tile_first + it;
    const __nv_bfloat16* kb = kbuf[it & 1];
    const __nv_bfloat16* vb = vbuf[it & 1];
    if (it + 1 < n_tiles) {  // the next tile's copies run during this tile's math
      issue_tile(kbuf[(it + 1) & 1], vbuf[(it + 1) & 1], k_cache, v_cache, table_row, tidx + 1, L,
                 first_key, last_key, NB, BS, KH, h0, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile has landed (every thread's copies); q and stats are set

    // Scores: (key t, head hh) pairs, each against the head's G rows.
    for (int pr = tid; pr < L.tile * NH; pr += kThreads) {
      const int t = pr % L.tile;
      const int hh = pr / L.tile;
      const __nv_bfloat16* krow = kb + t * L.stride + hh * D;
      const float* qrow = qs + size_t(hh) * G * D;
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + d);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float kf[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 x = __bfloat1622float2(k2[u]);
          kf[2 * u] = x.x;
          kf[2 * u + 1] = x.y;
        }
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float4 qa = *reinterpret_cast<const float4*>(qrow + g * D + d);
            const float4 qb = *reinterpret_cast<const float4*>(qrow + g * D + d + 4);
            s[g] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] + qb.x * kf[4] +
                    qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
          }
        }
      }
      const int kp = tidx * L.tile + t;
      const bool visible =
          kp <= start && kp < P * BS && (window <= 0 || kp > start - window);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float x = s[g] * sm_scale;
          if (logit_cap > 0.f) x = logit_cap * tanhf(x / logit_cap);
          ps[(hh * G + g) * L.pstride + t] = visible ? x : kNegInf;
        }
      }
    }
    __syncthreads();

    // Online softmax, one warp a row: bf16 probabilities, and the row sum
    // over the rounded values.
    for (int r = warp; r < R; r += kWarps) {
      float* prow = ps + r * L.pstride;
      float mx = kNegInf;
      for (int t = lane; t < L.tile; t += 32) mx = fmaxf(mx, prow[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < L.tile; t += 32) {
        const float p = __bfloat162float(__float2bfloat16(expf(prow[t] - m_new)));
        prow[t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V over this group's keys.
    if (pv_active) {
#pragma unroll
      for (int i = 0; i < kIters; ++i) {
        const int u = units >= kThreads ? tid + i * kThreads : tid % units;
        if (u < units && (i == 0 || units >= kThreads)) {
          const int hh = u / (D / 2);
          const int col = (u % (D / 2)) * 2;
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float alpha = a_s[hh * G + g];
              acc[i][g].x *= alpha;
              acc[i][g].y *= alpha;
            }
          }
          for (int t = kg; t < L.tile; t += KG) {
            const float2 v =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vb + t * L.stride +
                                                                             hh * D + col));
#pragma unroll
            for (int g = 0; g < kMaxG; ++g) {
              if (g < G) {
                const float p = ps[(hh * G + g) * L.pstride + t];
                acc[i][g].x += p * v.x;
                acc[i][g].y += p * v.y;
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the buffers of this tile are free for the tile after next
  }

  // out = acc / max(l, 1e-30); key groups' partial sums added first.
  if (KG == 1) {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int u = tid + i * kThreads;
      if (u < units) {
        const int hh = u / (D / 2);
        const int col = (u % (D / 2)) * 2;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const int r = hh * G + g;
            const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
            *reinterpret_cast<__nv_bfloat162*>(out + row0 + size_t(r) * D + col) =
                __floats2bfloat162_rn(acc[i][g].x * inv, acc[i][g].y * inv);
          }
        }
      }
    }
  } else {
    float* red = reinterpret_cast<float*>(smem + L.k_off[0]);  // KG x R x D partial sums
    if (pv_active) {
      const int u = tid % units;
      const int hh = u / (D / 2);
      const int col = (u % (D / 2)) * 2;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float* dst = red + (size_t(kg) * R + hh * G + g) * D + col;
          dst[0] = acc[0][g].x;
          dst[1] = acc[0][g].y;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < R * D; e += kThreads) {
      float sum = 0.f;
      for (int j = 0; j < KG; ++j) sum += red[size_t(j) * R * D + e];
      out[row0 + e] = __float2bfloat16(sum / fmaxf(l_s[e / D], 1e-30f));
    }
  }
}

template <int D, bool PACKED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tables,
                   const void* start, void* out, int B, int H, int KH, int NB, int BS, int P,
                   int window, float sm_scale, float logit_cap, cudaStream_t stream) {
  const int NH = PACKED ? KH : 1;
  const int R = NH * (H / KH);
  const int width = NH * D;
  const Smem L(R, D, tile_keys(width), width);
  cudaError_t err = cudaFuncSetAttribute(decode_attention_proto_kernel<D, PACKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(L.total));
  if (err != cudaSuccess) return err;
  const dim3 grid(B, KH / NH);
  decode_attention_proto_kernel<D, PACKED><<<grid, kThreads, L.total, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(start), static_cast<__nv_bfloat16*>(out), H, KH, NB, BS, P,
      window, sm_scale, logit_cap);
  return cudaGetLastError();
}

template <bool PACKED>
int dispatch(const void* q, const void* k, const void* v, const void* tables, const void* start,
             void* out, int B, int H, int KH, int D, int NB, int BS, int P, int window,
             float sm_scale, float logit_cap, void* stream) {
  const bool bs_ok = BS > 0 && (64 % BS == 0 || (BS % 64 == 0 && BS <= 256));
  if (B <= 0 || KH <= 0 || H % KH != 0 || !bs_ok || P <= 0 || NB <= 0)
    return cudaErrorInvalidValue;
  const int G = H / KH;
  const int NH = PACKED ? KH : 1;
  if (G > kMaxG || NH * G > kMaxRows || NH * D > kMaxWidth) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Built for head_dim 128 (Llama-3-8B) and 256 (Gemma-2-2B, Gemma-3-1B).
  if (D == 128)
    return launch<128, PACKED>(q, k, v, tables, start, out, B, H, KH, NB, BS, P, window,
                               sm_scale, logit_cap, s);
  if (D == 256)
    return launch<256, PACKED>(q, k, v, tables, start, out, B, H, KH, NB, BS, P, window,
                               sm_scale, logit_cap, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, 1, H, D] bf16; pools [NB, BS, KH, D] bf16; tables [B, P] and
// start [B] int32; out [B, 1, H, D] bf16. Each returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int decode_packed(const void* q, const void* k, const void* v, const void* tables,
                             const void* start, void* out, int B, int H, int KH, int D, int NB,
                             int BS, int P, int window, float sm_scale, float logit_cap,
                             void* stream) {
  return dispatch<true>(q, k, v, tables, start, out, B, H, KH, D, NB, BS, P, window, sm_scale,
                        logit_cap, stream);
}

extern "C" int decode_bf16(const void* q, const void* k, const void* v, const void* tables,
                           const void* start, void* out, int B, int H, int KH, int D, int NB,
                           int BS, int P, int window, float sm_scale, float logit_cap,
                           void* stream) {
  return dispatch<false>(q, k, v, tables, start, out, B, H, KH, D, NB, BS, P, window, sm_scale,
                         logit_cap, stream);
}
