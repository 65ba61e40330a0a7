// Masked full-catalog scoring for Hopper (sm_90a), fp32.
//
// Replaces the two TPU kernels of gsrs_tpu/ops/pallas_kernels.py:
//   masked_scores_pallas          (_masked_scores_kernel, natural column order)
//   masked_scores_bitplane_pallas (_masked_scores_bitplane_kernel)
// with one kernel and a layout flag.
//
//   out[b, c] = -1e9                      if the mask bit of column c is set in bits[b, :]
//             = sum_k u[b, k] * it[c, k]  otherwise (fp32 FMA accumulation, k in order)
//
// Where column c's mask bit is read:
//   natural:   word c >> 5, bit c & 31
//   bit-plane: t = c / block_m, cc = c % block_m, wpb = block_m / 32,
//              word t * wpb + cc % wpb, bit cc / wpb
//              (column cc of tile t scores item t * block_m + 32 * (cc % wpb) + cc / wpb;
//              the caller pre-permutes the item rows)
//
// The ragged edges of B, m and d are masked here: nothing is padded on the host and the
// output is exactly (B, m). u is (B, d), it is (m, d), bits is (B, W) 32-bit words
// (an int32 view of the uint32 words), out is (B, m); all row-major and contiguous.
//
// Bound on an H100 SXM at the serving shape B = 256, d = 64, m = 40,981:
//   bytes: 10.49 MB items + 0.07 MB users + 1.31 MB bitset read, 41.96 MB scores
//          written = 53.8 MB -> 16.1 us at 3.35 TB/s;
//   operations: 2 * B * m * d = 1.34 GFLOP -> 20.0 us at 67 TFLOP/s (fp32, no tensor cores:
//   TF32 would lose the fp32 scores that the top-k ranks on).
// So it is bound by operations, at ~20 us, with the score write close behind.
//
// Design: one block of 256 threads computes a 128 x 128 output tile; each thread keeps an
// 8 x 8 register tile of fp32 accumulators, rows ty + 16 i and columns tx + 16 j of the tile
// (ty, tx = thread / 16, thread % 16). The user and item tiles are staged k-major, that is
// k-contiguous ([row][k], a row stride of 36 floats), in shared memory, 32 k at a time,
// double-buffered with cp.async: 16-byte copies when d % 4 == 0 and the rows are 16-byte
// aligned (d = 64 on the main path), 4-byte copies otherwise; rows and k past the edges are
// zero-filled by the copy. Every fragment read is a 16-byte shared load of 4 consecutive k of
// one row: per 4 k a thread loads 4 item fragments, then each of its 8 user fragments against
// them, twice (24 loads for 256 FMAs; keeping all 8 item fragments live spills). The stride
// of 36 floats puts 8 consecutive rows in 8 distinct 16-byte bank groups, so the loads are
// conflict free (a warp's user fragments are 2 broadcast rows). Each score is one fmaf chain
// over k in order, starting from 0, whatever the tiling. No tensor cores.
//
// Epilogue. A column's mask word and bit are worked out once per column, not per score.
//   natural:   the 4 mask words of each tile row are copied to shared memory with the first
//              stage, so the epilogue reads no global memory; each thread stores its scores
//              straight from its registers, a half-warp writing 16 consecutive columns of one
//              row. Scalar stores need no alignment, so an odd m (rows at 4-byte offsets) is no
//              special case.
//   bit-plane: a column's word is read by the 32 blocks of its bit planes (128 words a row
//              when 128 divides block_m), so the tile goes through shared memory and each warp
//              writes whole rows as runs of 32 consecutive columns, reading 32 consecutive mask
//              words a run, all of them loaded before the barrier.
// Stores are streaming (__stcs), so that the 42 MB of scores do not evict the item table from
// L2. wgmma, TMA, a persistent grid that overlaps one tile's stores with the next tile's loop,
// and top-k fused into the epilogue are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;            // output rows and columns a block
constexpr int kTileK = 32;            // k a stage
constexpr int kLd = kTileK + 4;       // shared row stride of a stage, floats
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReg = 8;               // register tile: kReg x kReg
constexpr int kStageFloats = 2 * kTile * kLd;  // the user and the item tile of one stage
constexpr int kRunWords = kTile / 32;          // runs of 32 columns (natural: mask words) a row
constexpr int kOutLd = kTile + 16;  // bit-plane epilogue: shared row stride of the tile, floats
// two stages, then the natural layout's mask words of the tile's rows; the bit-plane layout's
// epilogue reuses the stages for the tile
constexpr size_t kSmemBytes = sizeof(float) * (2 * kStageFloats + kTile * kRunWords);  // 75,776
static_assert(kTile * kOutLd <= 2 * kStageFloats, "the bit-plane tile fits in the stages");
constexpr float kNegInf = -1e9f;

static_assert(kThreads == (kTile / kReg) * (kTile / kReg), "one thread per register tile");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + 128) x k [k0, k0 + 32) of a (rows, d) matrix into dst[128][kLd]; what lies
// outside is zero-filled (a copy of 0 source bytes reads nothing).
template <bool kVec>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int rows,
                                          int d, int r0, int k0) {
  if constexpr (kVec) {
    // 8 threads a row, 16 bytes each: coalesced 128-byte rows of global memory
    for (int e = threadIdx.x; e < kTile * kTileK / 4; e += kThreads) {
      const int r = e >> 3, k = (e & 7) * 4;
      const bool in = r0 + r < rows && k0 + k < d;  // d % 4 == 0: all 4 k or none
      cp_async16(dst + r * kLd + k, in ? src + (size_t)(r0 + r) * d + k0 + k : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * kTileK; e += kThreads) {
      const int r = e >> 5, k = e & 31;
      const bool in = r0 + r < rows && k0 + k < d;
      cp_async4(dst + r * kLd + k, in ? src + (size_t)(r0 + r) * d + k0 + k : src, in);
    }
  }
}

template <bool kVec, bool kBitplane>
__global__ void __launch_bounds__(kThreads, 2)
masked_scores_kernel(const float* __restrict__ u, const float* __restrict__ it,
                     const uint32_t* __restrict__ bits, float* __restrict__ out,
                     int B, int m, int d, int W, int block_m) {
  extern __shared__ __align__(16) float smem[];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int b0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;

  float acc[kReg][kReg];
#pragma unroll
  for (int i = 0; i < kReg; ++i)
#pragma unroll
    for (int j = 0; j < kReg; ++j) acc[i][j] = 0.f;

  // natural layout: the 4 mask words of each tile row, copied now and read in the epilogue
  uint32_t* mask_words = reinterpret_cast<uint32_t*>(smem + 2 * kStageFloats);
  if constexpr (!kBitplane) {
    for (int e = threadIdx.x; e < kTile * kRunWords; e += kThreads) {
      const int r = e / kRunWords, w = c0 / 32 + e % kRunWords;
      const bool in = b0 + r < B && w < W;
      cp_async4(reinterpret_cast<float*>(mask_words + e),
                reinterpret_cast<const float*>(in ? bits + (size_t)(b0 + r) * W + w : bits), in);
    }
  }
  const int n_stages = (d + kTileK - 1) / kTileK;
  if (n_stages > 0) {
    load_tile<kVec>(smem, u, B, d, b0, 0);
    load_tile<kVec>(smem + kTile * kLd, it, m, d, c0, 0);
  }
  cp_async_commit();
#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
    const float* us = smem + (s & 1) * kStageFloats;
    const float* its = us + kTile * kLd;
    if (s + 1 < n_stages) {
      float* next = smem + ((s + 1) & 1) * kStageFloats;
      load_tile<kVec>(next, u, B, d, b0, (s + 1) * kTileK);
      load_tile<kVec>(next + kTile * kLd, it, m, d, c0, (s + 1) * kTileK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 2  // a smaller body measured faster than a full unroll
    for (int k = 0; k < kTileK; k += 4) {
      // 4 item fragments at a time, then each user fragment against them
#pragma unroll
      for (int jh = 0; jh < kReg; jh += 4) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(its + (tx + 16 * (jh + j)) * kLd + k);
#pragma unroll
        for (int i = 0; i < kReg; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(us + (ty + 16 * i) * kLd + k);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float& c = acc[i][jh + j];
            c = fmaf(a.x, b[j].x, c);
            c = fmaf(a.y, b[j].y, c);
            c = fmaf(a.z, b[j].z, c);
            c = fmaf(a.w, b[j].w, c);
          }
        }
      }
    }
    __syncthreads();  // the next stage's copies overwrite this buffer
  }

  // epilogue (see the note at the top); the thread's columns are c0 + tx + 16 j
  if (n_stages == 0) {
    cp_async_wait<0>();
    __syncthreads();
  }
  if constexpr (!kBitplane) {
    // words c0 / 32 + j / 2 of the row, bit tx + 16 (j % 2)
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
      const int r = ty + 16 * i;
      if (b0 + r >= B) break;
      const uint4 w = *reinterpret_cast<const uint4*>(mask_words + r * kRunWords);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
      float* dst = out + (size_t)(b0 + r) * m;
#pragma unroll
      for (int j = 0; j < kReg; ++j) {
        const int c = c0 + tx + 16 * j;
        const bool masked = (words[j / 2] >> (tx + 16 * (j % 2))) & 1u;
        if (c < m) __stcs(dst + c, masked ? kNegInf : acc[i][j]);
      }
    }
    return;
  }
  // bit-plane layout: the tile through shared memory (row stride kOutLd: the register tile's
  // stores hit 32 distinct banks); warp w writes rows w, w + 8, ... The tile index is one
  // constant a block when 128 divides block_m.
  float* tile = smem;
#pragma unroll
  for (int i = 0; i < kReg; ++i)
#pragma unroll
    for (int j = 0; j < kReg; ++j) tile[(ty + 16 * i) * kOutLd + tx + 16 * j] = acc[i][j];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = block_m >> 5;
  const int t_block = block_m % kTile == 0 ? c0 / block_m : -1;
  int word[kRunWords], bit[kRunWords];
#pragma unroll
  for (int q = 0; q < kRunWords; ++q) {
    const int c = c0 + lane + 32 * q;
    const int t = t_block >= 0 ? t_block : c / block_m;
    const int cc = c - t * block_m;
    word[q] = t * wpb + cc % wpb;
    bit[q] = cc / wpb;
  }
  constexpr int kRowsPerWarp = kTile / kWarps;
  uint32_t masked[kRowsPerWarp];  // bit q of masked[i]: run q of row warp + 8 i
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int gb = b0 + warp + kWarps * i;
    masked[i] = 0;
#pragma unroll
    for (int q = 0; q < kRunWords; ++q)
      if (gb < B && c0 + lane + 32 * q < m)
        masked[i] |= ((__ldg(bits + (size_t)gb * W + word[q]) >> bit[q]) & 1u) << q;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (b0 + r >= B) break;
    float* dst = out + (size_t)(b0 + r) * m;
#pragma unroll
    for (int q = 0; q < kRunWords; ++q) {
      const int c = c0 + lane + 32 * q;
      if (c < m)
        __stcs(dst + c, (masked[i] >> q) & 1u ? kNegInf : tile[r * kOutLd + lane + 32 * q]);
    }
  }
}

template <bool kVec, bool kBitplane>
int launch(const float* u, const float* it, const uint32_t* bits, float* out, int B, int m,
           int d, int W, int block_m, cudaStream_t stream) {
  auto kernel = masked_scores_kernel<kVec, kBitplane>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((m + kTile - 1) / kTile, (B + kTile - 1) / kTile);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(u, it, bits, out, B, m, d, W, block_m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). A refused
// launch never runs and a later synchronize does not report it, so the caller
// checks this value. Returns cudaErrorInvalidValue for a bit-plane block_m that is
// not a positive multiple of 32.
extern "C" int gsrs_masked_scores(const float* u, const float* it, const int32_t* bits,
                                  float* out, int B, int m, int d, int W, int bitplane,
                                  int block_m, void* stream) {
  if (B < 0 || m < 0 || d < 0 || (bitplane && (block_m <= 0 || block_m % 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || m == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(it) % 16 == 0;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(bits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bitplane)
    return vec ? launch<true, true>(u, it, words, out, B, m, d, W, block_m, s)
               : launch<false, true>(u, it, words, out, B, m, d, W, block_m, s);
  return vec ? launch<true, false>(u, it, words, out, B, m, d, W, block_m, s)
             : launch<false, false>(u, it, words, out, B, m, d, W, block_m, s);
}
