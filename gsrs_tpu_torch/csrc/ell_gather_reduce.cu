// ELL gather-reduce for Hopper (sm_90a): the propagation kernel of every LightGCN layer,
// forward and backward, fp32 or bf16 features.
//
// Replaces the TPU kernel of tools/probe_pallas_gather.py (main, pallas_call at :101, kernel
// :46-79: per-row async copies of x[idx] with K in flight, then a sum over each block of B
// gathered rows), as the ELL gather-reduce it was written to become: the per-bucket
// take + einsum of gsrs_tpu/ops/ell.py::_apply_side (:544-551).
//
// For every bucket b of the table (rows of one degree bucket, width W_b):
//   out[out_row0_b + n, :] = sum_{j < W_b} v_b[n, j] * x[cols_b[n, j], :]
//   v_b[n, j] = w_b[n, j] * mask[eidx_b[n, j]]   (the mask factor only when a mask is given),
//               rounded to bf16 and back when x is bf16, as the JAX einsum casts it to x's dtype.
// Accumulation is fp32 and the sum is rounded once on the store (to bf16 when x is bf16).
// Padding slots carry weight 0 and column 0, sit at the end of each row and add exactly 0 for
// finite x, so each row stops at its real length L (the slot after its last non-zero weight).
// cols/eidx are int32, w and mask fp32, x and out row-major (S, d) and (R, d) of one dtype; all
// contiguous.
//
// Bound on an H100 SXM, Gowalla-shaped stand-in, d = 64 fp32, one side (by_item): 641,237 edges
// x 8 B of (col, weight), x read once (7.6 MB) and the output written once (10.5 MB) = 23.3 MB
// -> 7.0 us at 3.35 TB/s; operations 2 * d per edge -> 1.2 us at 67 TFLOP/s. So it is bound by
// bytes. The gathers themselves re-read x rows (256 B each) once per edge, 164 MB a side, from
// L2 (x fits in it), so the L2's rate is the practical limit, not HBM's.
//
// Design: a work list, built once per side on the host (gsrs_tpu_torch/ops/ell_kernel.py,
// build_work_list), gives every warp one item of at most S real slots:
//   * a row with L <= S is one item, stored straight into its output row;
//   * a row with L > S is cut into ceil(L / S) chunks of S slots, and each chunk writes its fp32
//     partial sum to a scratch row; a second kernel sums each split row's partials in chunk
//     order and rounds once on the store.
// The items run longest first, chunks before whole rows. No atomics and no counters: every
// output and scratch element is written once by one thread, so results are deterministic and
// independent of the schedule. A warp walks its slots 32 at a time: the lanes load 32 slots'
// (col, weight) with one coalesced load each and broadcast them with __shfl_sync, then gather
// x rows along d (V consecutive columns a lane, as one 4-, 8- or 16-byte load), 8 slots'
// gathers in flight before their FMAs. cp.async/TMA row prefetch and fusing the row assembly
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBuckets = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;                    // slots whose gathers are in flight together
constexpr int kPartsInFlight = 32;            // pass 2: partial sums whose loads are in flight
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// Host-side layout, mirrored by ctypes in gsrs_tpu_torch/ops/ell_kernel.py.
struct GsrsEllBucket {
  const int32_t* cols;   // (n_rows, width)
  const float* w;        // (n_rows, width)
  const int32_t* eidx;   // (n_rows, width), or null when no mask is applied
  int32_t width;
  int32_t out_row0;      // first output row of this bucket
};

struct GsrsEllTable {
  GsrsEllBucket b[kMaxBuckets];
  int32_t n_buckets;
};

namespace {

// The work list's rows are int4 (built by build_work_list in ops/ell_kernel.py):
//   item  (meta, row, j0, part): slots [j0, j0 + n) of row `row` of bucket meta & 0xff,
//         n = meta >> 8; part < 0: the whole row, stored to out; part >= 0: a chunk, its fp32
//         sum stored to scratch[part];
//   split (out_row, part0, n_parts, 0): out[out_row] = sum_{k < n_parts} scratch[part0 + k],
//         in that order.

__device__ __forceinline__ float round_like(float v, const float*) { return v; }
__device__ __forceinline__ float round_like(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t u) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = u;
  return __bfloat1622float2(h);
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = bf2_to_f2(q.x), b = bf2_to_f2(q.y);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else if constexpr (V == 2) {
    const float2 a = bf2_to_f2(__ldg(reinterpret_cast<const unsigned int*>(p)));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

__device__ __forceinline__ uint32_t f2_to_bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(f2_to_bf2(v[0], v[1]), f2_to_bf2(v[2], v[3]));
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint32_t*>(p) = f2_to_bf2(v[0], v[1]);
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// Pass 1: warp i of the grid takes items[i].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
ell_gather_kernel(const __grid_constant__ GsrsEllTable table,
                  const int4* __restrict__ items, int n_items,
                  const T* __restrict__ x, const float* __restrict__ mask,
                  T* __restrict__ out, float* __restrict__ scratch, int d) {
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;
  const int lane = threadIdx.x & 31;
  const int4 it = __ldg(items + item);  // (meta, row, j0, part)
  const GsrsEllBucket& bk = table.b[it.x & 0xff];
  const int n = it.x >> 8;
  const size_t base = (size_t)it.y * bk.width + it.z;
  const int32_t* __restrict__ cr = bk.cols + base;
  const float* __restrict__ wr = bk.w + base;
  const int32_t* __restrict__ er = mask != nullptr ? bk.eidx + base : nullptr;

  for (int c0 = 0; c0 < d; c0 += 32 * V) {
    const int c = c0 + lane * V;     // this lane's first column; d % V == 0
    const bool on = c < d;
    float acc[V] = {};
    for (int t0 = 0; t0 < n; t0 += 32) {
      int col = 0;
      float wt = 0.f;
      if (t0 + lane < n) {
        col = __ldg(cr + t0 + lane);
        wt = __ldg(wr + t0 + lane);
        if (er != nullptr) wt *= __ldg(mask + __ldg(er + t0 + lane));
        wt = round_like(wt, x);
      }
      const int nj = min(32, n - t0);
      int t = 0;
      for (; t + kUnroll <= nj; t += kUnroll) {
        float xv[kUnroll][V];
        float wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          wv[u] = __shfl_sync(kFull, wt, t + u);
          const int src = __shfl_sync(kFull, col, t + u);
          if (on) {
            load_vec<V>(x + (size_t)src * d + c, xv[u]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) xv[u][v] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(wv[u], xv[u][v], acc[v]);
      }
      for (; t < nj; ++t) {
        const float wj = __shfl_sync(kFull, wt, t);
        const int src = __shfl_sync(kFull, col, t);
        if (on) {
          float xv[V];
          load_vec<V>(x + (size_t)src * d + c, xv);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(wj, xv[v], acc[v]);
        }
      }
    }
    if (!on) continue;
    if (it.w < 0)
      store_vec<V>(out + (size_t)(bk.out_row0 + it.y) * d + c, acc);
    else
      store_vec<V>(scratch + (size_t)it.w * d + c, acc);
  }
}

// Pass 2: warp i sums split row i's partials in chunk order and rounds once on the store.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
ell_split_sum_kernel(const int4* __restrict__ splits, int n_split,
                     const float* __restrict__ scratch, T* __restrict__ out, int d) {
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n_split) return;
  const int lane = threadIdx.x & 31;
  const int4 s = __ldg(splits + i);  // (out_row, part0, n_parts, 0)
  for (int c = lane * V; c < d; c += 32 * V) {
    const float* p = scratch + (size_t)s.y * d + c;
    float acc[V] = {};
    int k = 0;
    for (; k + kPartsInFlight <= s.z; k += kPartsInFlight) {
      float q[kPartsInFlight][V];
#pragma unroll
      for (int u = 0; u < kPartsInFlight; ++u) load_vec<V>(p + (size_t)(k + u) * d, q[u]);
#pragma unroll
      for (int u = 0; u < kPartsInFlight; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] += q[u][v];
    }
    for (; k < s.z; ++k) {
      float q[V];
      load_vec<V>(p + (size_t)k * d, q);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += q[v];
    }
    store_vec<V>(out + (size_t)s.x * d + c, acc);
  }
}

template <typename T, int V>
void launch(const GsrsEllTable& t, const int4* items, int n_items,
            const int4* splits, int n_split, float* scratch, const void* x,
            const float* mask, void* out, int d, cudaStream_t s) {
  if (n_items > 0)
    ell_gather_kernel<T, V><<<(n_items + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        t, items, n_items, static_cast<const T*>(x), mask, static_cast<T*>(out), scratch, d);
  if (n_split > 0)
    ell_split_sum_kernel<T, V><<<(n_split + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        splits, n_split, scratch, static_cast<T*>(out), d);
}

template <typename T>
void launch_vec(int vec, const GsrsEllTable& t, const int4* items, int n_items,
                const int4* splits, int n_split, float* scratch, const void* x,
                const float* mask, void* out, int d, cudaStream_t s) {
  if (vec == 4)
    launch<T, 4>(t, items, n_items, splits, n_split, scratch, x, mask, out, d, s);
  else if (vec == 2)
    launch<T, 2>(t, items, n_items, splits, n_split, scratch, x, mask, out, d, s);
  else
    launch<T, 1>(t, items, n_items, splits, n_split, scratch, x, mask, out, d, s);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Launches one gather-reduce over the work list of `table` on `stream`: pass 1 over the n_items
// items, then (when n_split > 0) pass 2 over the split rows, whose partials go through
// `scratch` (fp32, at least as many rows of d as the items' part indices reach). Returns
// cudaGetLastError() (0 on success); a refused launch never runs, so the caller checks this.
// Returns cudaErrorInvalidValue for arguments it cannot take. The vector width V (columns a
// lane loads at once) is the widest of 4, 2, 1 that divides d and keeps every row of x, out
// and scratch aligned, and no wider than d needs.
extern "C" int gsrs_ell_gather_reduce(const GsrsEllTable* table, const int32_t* items,
                                      int n_items, const int32_t* splits, int n_split,
                                      float* scratch, const void* x, const float* mask,
                                      void* out, int d, int bf16, void* stream) {
  if (table == nullptr || table->n_buckets < 0 || table->n_buckets > kMaxBuckets || d <= 0 ||
      n_items < 0 || n_split < 0 || (n_items > 0 && items == nullptr) ||
      (n_split > 0 && (splits == nullptr || scratch == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mask != nullptr)
    for (int i = 0; i < table->n_buckets; ++i)
      if (table->b[i].eidx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t elem = bf16 ? 2 : 4;
  int vec = 1;
  for (int v = 4; v > 1; v /= 2) {
    if (d % v == 0 && 32 * (v / 2) < d && aligned(x, v * elem) && aligned(out, v * elem) &&
        aligned(scratch, v * 4)) {
      vec = v;
      break;
    }
  }
  if (!aligned(items, 16) || !aligned(splits, 16)) return static_cast<int>(cudaErrorInvalidValue);
  const int4* it = reinterpret_cast<const int4*>(items);
  const int4* sp = reinterpret_cast<const int4*>(splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_vec<__nv_bfloat16>(vec, *table, it, n_items, sp, n_split, scratch, x, mask, out, d, s);
  else
    launch_vec<float>(vec, *table, it, n_items, sp, n_split, scratch, x, mask, out, d, s);
  return static_cast<int>(cudaGetLastError());
}
