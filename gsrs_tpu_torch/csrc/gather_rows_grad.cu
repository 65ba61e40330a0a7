// The backward of a table row gather (gsrs_tpu_torch/ops/gather.py: out = table[ids]) for Hopper
// (sm_90a): the dense table gradient
//   grad_table[r, :] = sum of grad[i, :] over the positions i with ids[i] == r   (0 where none)
// summed in fp32 and written in the table's dtype (fp32 or bf16).
//
// Replaces no TPU kernel: the JAX package leaves this gradient to XLA's scatter-add. On the H100
// the port took PyTorch's index_put_ with accumulation, which sums each id's run of rows serially
// in one warp, so one long run sets its time: BERT4Rec's PAD row (about 27,700 of a batch's
// 51,200 ids) took 12.4 ms a step, the Gowalla BPR batch's hottest item (about 18,000 of 262,144
// item ids) 2.9 ms.
//
// Bound: bytes. Each gradient row is read once and each table row written once, with the ids:
// 51,200 x 64 fp32 rows read and 26,746 x 64 written in BERT4Rec's step (20 MB, 6 us at
// 3.35 TB/s); 393,216 rows read and 70,839 written in Gowalla's (122 MB, 36 us). An add a value
// read is far from the operations bound.
//
// Design. One call of the entry point, on the caller's stream:
//   1. gather_rows_grad_keys_kernel: each id (int32 or int64) checked against [0, rows) by a
//      device-side assert and written as a 32-bit key beside its position;
//   2. cub's radix sort of the (key, position) pairs over the bits that `rows` needs (15 or 16
//      here: two passes), stable, so each id's positions come in position order;
//   3. bounds (rows x 2 int32) zeroed: bounds[r] = (lo, hi), the sorted positions of id r;
//   4. gather_rows_grad_chunk_kernel, one warp a chunk of kChunk = 32 sorted positions: each lane
//      writes lo where its position starts a run of one id and hi where it ends one (one writer
//      for each, so no atomics), and where all 32 positions hold one id, the warp sums their 32
//      rows in position order into partial[chunk];
//   5. gather_rows_grad_rows_kernel, one warp a table row: the rows of [lo, hi) before its first
//      whole chunk, then the partials of its whole chunks in order, then the rows after its last
//      whole chunk, each in position order; it writes the row, zeros where lo == hi, so no fill of
//      the output runs before it.
// So a long run is summed 32 rows to a warp, all its chunks at once, and its partials combined in
// chunk order: BERT4Rec's PAD run is about 866 chunk sums and one pass over their partials, where
// index_put_ summed 27,700 rows in one warp. No warp sums more than 31 rows of a run on either
// side of its whole chunks. Each sum's order is fixed by the sorted positions alone, and nothing
// is added by atomics, so two calls on the same inputs give the same bits. Nothing is read on the
// host, and the host makes one call: the sort, the scratch and the launches are all here, since
// on a host-bound step each PyTorch call around the kernels costs as much as they do.
// Its weakness: step 5's one warp walks all of a row's partials, so a run of millions of one id
// (tens of thousands of partials) sets the backward's time. HSTU relies on working round it
// (models/hstu.py's spread_ids spreads its zero-gradient ids over the table's rows); a combine of
// a long run's partials by many warps would make that needless.
//
// A lane takes columns lane + 32 v (v < V, V = 1, 2 or 4 by d) of each row, in tiles of 32 V
// columns, so a warp reads a row's 32 V values at once (one 256-byte row of 64 fp32 in two
// 128-byte loads) at any row and column stride.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cassert>
#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kChunk = 32;  // sorted positions a chunk: one warp's lanes
constexpr int kWarps = 8;   // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kAlign = 256;  // each scratch array starts on this boundary

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// acc[v] += grad[perm[i], c0 + lane + 32 v] for i in [lo, hi), in order of i.
template <typename T, int V>
__device__ __forceinline__ void add_rows(float (&acc)[V], const T* __restrict__ grad, long long rs,
                                         long long cs, const int* __restrict__ perm, int lo,
                                         int hi, int c0, int d, int lane) {
  for (int base = lo; base < hi; base += kChunk) {
    const int count = min(kChunk, hi - base);
    const int p = lane < count ? perm[base + lane] : 0;
#pragma unroll 4
    for (int j = 0; j < count; ++j) {
      const T* row = grad + static_cast<long long>(__shfl_sync(kFull, p, j)) * rs;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int col = c0 + lane + 32 * v;
        if (col < d) acc[v] += to_float(row[col * cs]);
      }
    }
  }
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
    gather_rows_grad_keys_kernel(const I* __restrict__ ids, int n, int rows,
                                 unsigned* __restrict__ keys, int* __restrict__ pos) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const I id = ids[i];
  assert(id >= 0 && id < rows);
  keys[i] = static_cast<unsigned>(id);
  pos[i] = static_cast<int>(i);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gather_rows_grad_chunk_kernel(const T* __restrict__ grad, long long rs, long long cs,
                                  const unsigned* __restrict__ sorted,
                                  const int* __restrict__ perm, int n, int d,
                                  int* __restrict__ bounds, float* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const long long chunk = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long start = chunk * kChunk;
  if (start >= n) return;  // the whole warp
  const long long i = start + lane;
  const bool in = i < n;
  const int id = in ? static_cast<int>(sorted[i]) : -1;
  if (in) {
    if (i == 0 || static_cast<int>(sorted[i - 1]) != id) bounds[2 * id] = static_cast<int>(i);
    if (i == n - 1 || static_cast<int>(sorted[i + 1]) != id)
      bounds[2 * id + 1] = static_cast<int>(i + 1);
  }
  const int first = __shfl_sync(kFull, id, 0);
  const int last = __shfl_sync(kFull, id, kChunk - 1);
  if (start + kChunk > n || first != last) return;  // the rows kernel sums its rows
  for (int c0 = 0; c0 < d; c0 += 32 * V) {
    float acc[V] = {};
    add_rows<T, V>(acc, grad, rs, cs, perm, static_cast<int>(start),
                   static_cast<int>(start) + kChunk, c0, d, lane);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int col = c0 + lane + 32 * v;
      if (col < d) partial[chunk * d + col] = acc[v];
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gather_rows_grad_rows_kernel(const T* __restrict__ grad, long long rs, long long cs,
                                 const int* __restrict__ perm, int d, int rows,
                                 const int* __restrict__ bounds,
                                 const float* __restrict__ partial, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lo = bounds[2 * r], hi = bounds[2 * r + 1];
  // whole chunks [a, e) inside [lo, hi): every one of them holds id r alone, so the chunk
  // kernel wrote its partial
  const int a = min(hi, (lo + kChunk - 1) / kChunk * kChunk);
  const int e = max(a, hi / kChunk * kChunk);
  for (int c0 = 0; c0 < d; c0 += 32 * V) {
    float acc[V] = {};
    add_rows<T, V>(acc, grad, rs, cs, perm, lo, a, c0, d, lane);
#pragma unroll 8
    for (int c = a / kChunk; c < e / kChunk; ++c) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int col = c0 + lane + 32 * v;
        if (col < d) acc[v] += partial[static_cast<long long>(c) * d + col];
      }
    }
    add_rows<T, V>(acc, grad, rs, cs, perm, e, hi, c0, d, lane);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int col = c0 + lane + 32 * v;
      if (col < d) out[r * d + col] = from_float<T>(acc[v]);
    }
  }
}

template <typename T, int V>
void launch(const void* grad, long long rs, long long cs, const unsigned* sorted,
            const int* perm, int n, int d, int rows, int* bounds, float* partial, void* out,
            cudaStream_t stream) {
  const T* g = static_cast<const T*>(grad);
  const long long chunks = (static_cast<long long>(n) + kChunk - 1) / kChunk;
  if (chunks > 0)
    gather_rows_grad_chunk_kernel<T, V>
        <<<static_cast<unsigned>((chunks + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
            g, rs, cs, sorted, perm, n, d, bounds, partial);
  gather_rows_grad_rows_kernel<T, V>
      <<<static_cast<unsigned>((static_cast<long long>(rows) + kWarps - 1) / kWarps), kThreads, 0,
         stream>>>(g, rs, cs, perm, d, rows, bounds, partial, static_cast<T*>(out));
}

template <typename T>
void launch_width(const void* grad, long long rs, long long cs, const unsigned* sorted,
                  const int* perm, int n, int d, int rows, int* bounds, float* partial,
                  void* out, cudaStream_t stream) {
  if (d <= 32)
    launch<T, 1>(grad, rs, cs, sorted, perm, n, d, rows, bounds, partial, out, stream);
  else if (d <= 64)
    launch<T, 2>(grad, rs, cs, sorted, perm, n, d, rows, bounds, partial, out, stream);
  else
    launch<T, 4>(grad, rs, cs, sorted, perm, n, d, rows, bounds, partial, out, stream);
}

size_t aligned(size_t bytes) { return (bytes + kAlign - 1) / kAlign * kAlign; }

int key_bits(int rows) {
  int bits = 1;
  while (bits < 31 && (1LL << bits) < rows) ++bits;
  return bits;
}

// The scratch of a call, one buffer: keys and positions, each in and sorted, the bounds, the
// chunk partials and the sort's own storage, each on a kAlign boundary.
struct Scratch {
  size_t keys_in, keys_out, pos_in, pos_out, bounds, partial, sort, sort_bytes, total;
};

cudaError_t plan(int n, int d, int rows, Scratch* s) {
  const size_t ids = aligned(sizeof(int) * static_cast<size_t>(n));
  s->keys_in = 0;
  s->keys_out = s->keys_in + ids;
  s->pos_in = s->keys_out + ids;
  s->pos_out = s->pos_in + ids;
  s->bounds = s->pos_out + ids;
  s->partial = s->bounds + aligned(sizeof(int) * 2 * static_cast<size_t>(rows));
  s->sort = s->partial +
            aligned(sizeof(float) * static_cast<size_t>((n + kChunk - 1) / kChunk) * d);
  s->sort_bytes = 0;
  if (n > 0) {
    cudaError_t e = cub::DeviceRadixSort::SortPairs(
        nullptr, s->sort_bytes, static_cast<const unsigned*>(nullptr),
        static_cast<unsigned*>(nullptr), static_cast<const int*>(nullptr),
        static_cast<int*>(nullptr), n, 0, key_bits(rows));
    if (e != cudaSuccess) return e;
  }
  s->total = s->sort + aligned(s->sort_bytes);
  return cudaSuccess;
}

}  // namespace

// The scratch bytes a call of gsrs_gather_rows_grad with these sizes needs (0 on bad sizes).
// Reads nothing on the card.
extern "C" long long gsrs_gather_rows_grad_scratch(int n, int d, int rows) {
  Scratch s;
  if (n < 0 || d < 1 || rows < 1 || plan(n, d, rows, &s) != cudaSuccess) return 0;
  return static_cast<long long>(s.total);
}

// The table gradient `out` (rows x d, contiguous, fp32 or bf16 as `bf16` says) of the gather of
// the n `ids` (int64 where `ids64`, else int32; contiguous) from their gradient rows `grad`
// (n x d at row stride rs and column stride cs, in elements, the table's dtype). `scratch` holds
// gsrs_gather_rows_grad_scratch(n, d, rows) bytes, 256-byte aligned. Launches on `stream` and
// returns the first error (0 on success), cudaGetLastError() last: a refused launch never runs
// and a later synchronize does not report it, so the caller checks this value. Returns
// cudaErrorInvalidValue unless 0 <= n, 1 <= d, 1 <= rows and the scratch is large enough.
extern "C" int gsrs_gather_rows_grad(const void* grad, long long rs, long long cs, int bf16,
                                     const void* ids, int ids64, int n, int d, int rows,
                                     void* scratch, long long scratch_bytes, void* out,
                                     void* stream) {
  Scratch s;
  if (n < 0 || d < 1 || rows < 1 || out == nullptr || scratch == nullptr ||
      (n > 0 && (grad == nullptr || ids == nullptr)) || plan(n, d, rows, &s) != cudaSuccess ||
      scratch_bytes < static_cast<long long>(s.total))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  unsigned* keys_in = reinterpret_cast<unsigned*>(base + s.keys_in);
  unsigned* keys_out = reinterpret_cast<unsigned*>(base + s.keys_out);
  int* pos_in = reinterpret_cast<int*>(base + s.pos_in);
  int* pos_out = reinterpret_cast<int*>(base + s.pos_out);
  int* bounds = reinterpret_cast<int*>(base + s.bounds);
  float* partial = reinterpret_cast<float*>(base + s.partial);
  cudaError_t e;
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + kThreads - 1) /
                                                  kThreads);
    if (ids64)
      gather_rows_grad_keys_kernel<long long><<<blocks, kThreads, 0, st>>>(
          static_cast<const long long*>(ids), n, rows, keys_in, pos_in);
    else
      gather_rows_grad_keys_kernel<int><<<blocks, kThreads, 0, st>>>(
          static_cast<const int*>(ids), n, rows, keys_in, pos_in);
    size_t sort_bytes = s.sort_bytes;
    e = cub::DeviceRadixSort::SortPairs(base + s.sort, sort_bytes,
                                        static_cast<const unsigned*>(keys_in), keys_out,
                                        static_cast<const int*>(pos_in), pos_out, n, 0,
                                        key_bits(rows), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaMemsetAsync(bounds, 0, sizeof(int) * 2 * static_cast<size_t>(rows), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bf16)
    launch_width<__nv_bfloat16>(grad, rs, cs, keys_out, pos_out, n, d, rows, bounds, partial, out,
                                st);
  else
    launch_width<float>(grad, rs, cs, keys_out, pos_out, n, d, rows, bounds, partial, out, st);
  return static_cast<int>(cudaGetLastError());
}
