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
// The ragged edges of B and m are masked here: nothing is padded on the host and the
// output is exactly (B, m). u is (B, d), it is (m, d), bits is (B, W) 32-bit words
// (an int32 view of the uint32 words), out is (B, m); all row-major and contiguous.
//
// Bound on an H100 SXM at the serving shape B = 256, d = 64, m = 40,981:
//   bytes: 10.49 MB items + 0.07 MB users + 1.31 MB bitset read, 41.96 MB scores
//          written = 53.8 MB -> 16.1 us at 3.35 TB/s;
//   operations: 2 * B * m * d = 1.34 GFLOP -> 20.0 us at 67 TFLOP/s (fp32, no tensor cores).
// So it is bound by operations, at ~20 us, with the score write close behind.
//
// Design (a simple kernel that is right first): one block of 256 threads computes one
// 64 x 128 output tile. The user and item tiles pass through shared memory in chunks of
// 32 along d; each thread keeps an 8 x 4 register tile of fp32 accumulators. A warp owns
// 8 user rows and 128 consecutive columns (lane + 32 j), so the epilogue's stores are
// 128-byte coalesced rows and, in natural order, the 32 lanes of a store share one bitset
// word. wgmma, TMA and fusing top-k into the epilogue are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileB = 64;
constexpr int kTileM = 128;
constexpr int kTileK = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = kTileB / kWarps;  // 8
constexpr int kColsPerThread = kTileM / 32;      // 4
constexpr float kNegInf = -1e9f;

__global__ void __launch_bounds__(kThreads)
masked_scores_kernel(const float* __restrict__ u, const float* __restrict__ it,
                     const uint32_t* __restrict__ bits, float* __restrict__ out,
                     int B, int m, int d, int W, int bitplane, int block_m) {
  // +1 column of padding: the transposing stores and the row reads below hit
  // 32 distinct banks
  __shared__ float us[kTileK][kTileB + 1];
  __shared__ float its[kTileK][kTileM + 1];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * kTileB;
  const int c0 = blockIdx.x * kTileM;

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kTileK) {
    // consecutive threads read consecutive k of one row: coalesced along d
    for (int e = threadIdx.x; e < kTileB * kTileK; e += kThreads) {
      const int r = e / kTileK, k = e % kTileK;
      const int gb = b0 + r, gk = k0 + k;
      us[k][r] = (gb < B && gk < d) ? u[(size_t)gb * d + gk] : 0.f;
    }
    for (int e = threadIdx.x; e < kTileM * kTileK; e += kThreads) {
      const int r = e / kTileK, k = e % kTileK;
      const int gc = c0 + r, gk = k0 + k;
      its[k][r] = (gc < m && gk < d) ? it[(size_t)gc * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTileK; ++k) {
      float a[kRowsPerThread], b[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = us[k][warp + kWarps * i];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) b[j] = its[k][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int wpb = block_m >> 5;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int gb = b0 + warp + kWarps * i;
    if (gb >= B) continue;
    const uint32_t* row = bits + (size_t)gb * W;
    float* dst = out + (size_t)gb * m;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c >= m) continue;
      int word, bit;
      if (bitplane) {
        const int t = c / block_m, cc = c - t * block_m;
        word = t * wpb + cc % wpb;
        bit = cc / wpb;
      } else {
        word = c >> 5;
        bit = c & 31;
      }
      const bool masked = (__ldg(row + word) >> bit) & 1u;
      dst[c] = masked ? kNegInf : acc[i][j];
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). A refused
// launch never runs and a later synchronize does not report it, so the caller
// checks this value.
extern "C" int gsrs_masked_scores(const float* u, const float* it, const int32_t* bits,
                                  float* out, int B, int m, int d, int W, int bitplane,
                                  int block_m, void* stream) {
  if (B > 0 && m > 0) {
    const dim3 grid((m + kTileM - 1) / kTileM, (B + kTileB - 1) / kTileB);
    masked_scores_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        u, it, reinterpret_cast<const uint32_t*>(bits), out, B, m, d, W, bitplane, block_m);
  }
  return static_cast<int>(cudaGetLastError());
}
