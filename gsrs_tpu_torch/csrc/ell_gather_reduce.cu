// ELL gather-reduce for Hopper (sm_90a): the propagation kernel of every LightGCN layer,
// forward and backward, fp32 or bf16 features.
//
// Replaces the TPU kernel of tools/probe_pallas_gather.py (main, pallas_call at :101, kernel
// :46-79: per-row async copies of x[idx] with K in flight, then a sum over each block of B
// gathered rows), as the ELL gather-reduce it was written to become: the per-bucket
// take + einsum of gsrs_tpu/ops/ell.py::_apply_side (:544-551).
//
// For every bucket b of the table (rows of one degree bucket, width W_b):
//   out[out_row0_b + n, :] = sum_{j < W_b} w_b[n, j] * mask[eidx_b[n, j]] * x[cols_b[n, j], :]
// with the mask factor only when a mask is given. Accumulation is fp32, in slot order, and the
// sum is rounded once on the store (to bf16 when x is bf16). Padding slots carry weight 0 and
// column 0, and add exactly 0 for finite x. cols/eidx are int32, w and mask fp32, x and out
// row-major (S, d) and (R, d) of one dtype; all contiguous.
//
// One launch covers a whole side (up to kMaxBuckets buckets): the table rides in the kernel's
// parameter space (__grid_constant__, so indexing it dynamically copies nothing to local
// memory), and each block finds its bucket by a scan of the block offsets.
//
// Bound on an H100 SXM, Gowalla-shaped stand-in, d = 64 fp32, one layer (both sides):
//   bytes: 1,615,456 slots x 8 B of cols + w, the two tables read once (18.1 MB) and the two
//          outputs written once (18.1 MB) = 49 MB -> 14.7 us at 3.35 TB/s;
//   operations: 2 * d per real edge slot -> ~2.5 us at 67 TFLOP/s.
// So it is bound by bytes. The gathers themselves re-read x rows (256 B each) once per edge,
// mostly from L2 (the tables are 7.6 MB and 10.5 MB).
//
// Design (a simple kernel that is right first): 512 threads a block. Narrow buckets
// (W < kWideWidth) give each warp one row: the 32 lanes load 32 slots' (col, weight) pairs with
// one coalesced load each, then broadcast them one by one with __shfl_sync, and the lanes
// gather the row x[col] along d (coalesced 128-byte reads). Wide buckets give each block one row:
// its 16 warps take interleaved 32-slot groups and the partial sums are reduced in shared
// memory. Wide buckets' blocks come first in the grid, so the few very wide rows (the item
// side's widest is 32,768 slots) start before the bulk of the narrow rows and overlap with it.
// There are no atomics: every output element is written once by one thread. Any d works,
// 128 columns per pass. cp.async/TMA row prefetch, keeping x resident in L2, splitting the
// widest rows over several blocks and fusing the row assembly are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBuckets = 64;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWideWidth = 512;               // rows at least this wide get a block each
constexpr int kLaneCols = 4;                  // columns per lane per pass
constexpr int kPassCols = 32 * kLaneCols;     // columns per pass
constexpr int kUnroll = 8;                    // slots whose gathers are in flight together
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// Host-side layout, mirrored by ctypes in gsrs_tpu_torch/ops/ell_kernel.py.
struct GsrsEllBucket {
  const int32_t* cols;   // (n_rows, width)
  const float* w;        // (n_rows, width)
  const int32_t* eidx;   // (n_rows, width), or null when no mask is applied
  int32_t n_rows;
  int32_t width;
  int32_t out_row0;      // first output row of this bucket
  int32_t block0;        // first block of this bucket (set by the launcher)
};

struct GsrsEllTable {
  GsrsEllBucket b[kMaxBuckets];
  int32_t n_buckets;
  int32_t n_blocks;      // set by the launcher
};

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Accumulates slots of one row (W wide) into acc, columns [c0, c0 + kPassCols) of x: the
// calling warp takes the 32-slot groups that start at j_begin, j_begin + j_step, ...
template <typename T>
__device__ __forceinline__ void accumulate(const int32_t* __restrict__ cr,
                                          const float* __restrict__ wr,
                                          const int32_t* __restrict__ er,
                                          const float* __restrict__ mask,
                                          const T* __restrict__ x, int d, int c0, int W,
                                          int j_begin, int j_step, int lane,
                                          float (&acc)[kLaneCols]) {
  for (int j0 = j_begin; j0 < W; j0 += j_step) {
    const int j = j0 + lane;
    int col = 0;
    float wt = 0.f;
    if (j < W) {
      col = __ldg(cr + j);
      wt = __ldg(wr + j);
      if (mask != nullptr) wt *= __ldg(mask + __ldg(er + j));
    }
    const int nj = min(32, W - j0);
    int t = 0;
    for (; t + kUnroll <= nj; t += kUnroll) {
      float xv[kUnroll][kLaneCols];
      float wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        wv[u] = __shfl_sync(kFull, wt, t + u);
        const T* xr = x + (size_t)__shfl_sync(kFull, col, t + u) * d + c0;
#pragma unroll
        for (int k = 0; k < kLaneCols; ++k) {
          const int c = lane + 32 * k;
          xv[u][k] = (c0 + c < d) ? to_f32(__ldg(xr + c)) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < kLaneCols; ++k) acc[k] = fmaf(wv[u], xv[u][k], acc[k]);
    }
    for (; t < nj; ++t) {
      const float wj = __shfl_sync(kFull, wt, t);
      const T* xr = x + (size_t)__shfl_sync(kFull, col, t) * d + c0;
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k) {
        const int c = lane + 32 * k;
        if (c0 + c < d) acc[k] = fmaf(wj, to_f32(__ldg(xr + c)), acc[k]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_gather_reduce_kernel(const __grid_constant__ GsrsEllTable table, const T* __restrict__ x,
                         const float* __restrict__ mask, T* __restrict__ out, int d) {
  __shared__ float partial[kWarps][kPassCols];

  const int blk = blockIdx.x;
  int bi = 0;
  for (int i = 1; i < table.n_buckets; ++i)
    if (blk >= table.b[i].block0) bi = i;
  const GsrsEllBucket& bk = table.b[bi];
  const int W = bk.width;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (W < kWideWidth) {
    // a warp per row
    const int row = (blk - bk.block0) * kWarps + warp;
    if (row >= bk.n_rows) return;
    const size_t base = (size_t)row * W;
    const int32_t* er = bk.eidx != nullptr ? bk.eidx + base : nullptr;
    T* orow = out + (size_t)(bk.out_row0 + row) * d;
    for (int c0 = 0; c0 < d; c0 += kPassCols) {
      float acc[kLaneCols] = {};
      accumulate(bk.cols + base, bk.w + base, er, mask, x, d, c0, W, 0, 32, lane, acc);
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k) {
        const int c = c0 + lane + 32 * k;
        if (c < d) store(orow + c, acc[k]);
      }
    }
    return;
  }

  // a block per row: warps take interleaved groups of 32 slots, then reduce in shared memory
  const int row = blk - bk.block0;
  const size_t base = (size_t)row * W;
  const int32_t* er = bk.eidx != nullptr ? bk.eidx + base : nullptr;
  T* orow = out + (size_t)(bk.out_row0 + row) * d;
  for (int c0 = 0; c0 < d; c0 += kPassCols) {
    float acc[kLaneCols] = {};
    accumulate(bk.cols + base, bk.w + base, er, mask, x, d, c0, W, 32 * warp, 32 * kWarps,
               lane, acc);
#pragma unroll
    for (int k = 0; k < kLaneCols; ++k) partial[warp][lane + 32 * k] = acc[k];
    __syncthreads();
    if (threadIdx.x < kPassCols && c0 + threadIdx.x < d) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) s += partial[i][threadIdx.x];
      store(orow + c0 + threadIdx.x, s);
    }
    __syncthreads();
  }
}

}  // namespace

// Launches one gather-reduce over every bucket of `table` on `stream` and returns
// cudaGetLastError() (0 on success); a refused launch never runs, so the caller checks this.
// The launcher orders the blocks (widest buckets first) and fills block0 / n_blocks in its
// own copy of the table; the caller's table is not changed. Returns cudaErrorInvalidValue for
// a table it cannot take.
extern "C" int gsrs_ell_gather_reduce(const GsrsEllTable* table_in, const void* x,
                                      const float* mask, void* out, int d, int bf16,
                                      void* stream) {
  if (table_in == nullptr || table_in->n_buckets < 0 || table_in->n_buckets > kMaxBuckets ||
      d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GsrsEllTable t = {};
  // widest buckets first (a stable insertion sort of at most kMaxBuckets entries)
  int n = 0;
  for (int i = 0; i < table_in->n_buckets; ++i) {
    const GsrsEllBucket& b = table_in->b[i];
    if (b.n_rows <= 0 || b.width <= 0) continue;
    if (mask != nullptr && b.eidx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    int pos = n;
    while (pos > 0 && t.b[pos - 1].width < b.width) {
      t.b[pos] = t.b[pos - 1];
      --pos;
    }
    t.b[pos] = b;
    ++n;
  }
  t.n_buckets = n;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    t.b[i].block0 = static_cast<int32_t>(blocks);
    blocks += t.b[i].width >= kWideWidth ? t.b[i].n_rows
                                         : (t.b[i].n_rows + kWarps - 1) / kWarps;
  }
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  t.n_blocks = static_cast<int32_t>(blocks);
  if (blocks > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16)
      ell_gather_reduce_kernel<__nv_bfloat16><<<t.n_blocks, kThreads, 0, s>>>(
          t, static_cast<const __nv_bfloat16*>(x), mask, static_cast<__nv_bfloat16*>(out), d);
    else
      ell_gather_reduce_kernel<float><<<t.n_blocks, kThreads, 0, s>>>(
          t, static_cast<const float*>(x), mask, static_cast<float*>(out), d);
  }
  return static_cast<int>(cudaGetLastError());
}
