// One-pass bias-corrected Adam for Hopper (sm_90a) over every leaf of a step in one launch,
// fp32 or bf16 leaves (both may share a launch).
//
// Replaces the TPU kernel of gsrs_tpu/train/fused_adam.py: _fused_adam_leaf_pallas (pallas_call
// at :107, body _fused_adam_kernel :62-70, math _adam_math :46-58), which the JAX optimizer calls
// once per leaf. Per element, in fp32:
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * (g * g)
//   p' = p - lr * (m' * c1) / (sqrt(v' * c2) + eps)          c1 = 1/(1-b1^t), c2 = 1/(1-b2^t)
// and p', m', v' are stored back in place in the leaf's dtype (round to nearest even for bf16).
// Every product, sum and quotient is a separately rounded IEEE operation (no contraction into
// FMAs), in the order above, so the kernel gives the bits of the plain PyTorch version, which
// runs the same operations one by one. A leaf without a gradient (g null) takes g = +0 and reads
// no gradient memory, which gives the bits of a zero gradient. lr, c1, c2 and the constants b1,
// 1 - b1, b2, 1 - b2, eps arrive by value, computed on the host (so the step needs no device read).
//
// Bound on an H100 SXM: it reads p, m, v, g once and writes p, m, v once: 28 bytes per fp32
// element, 14 per bf16 one. For the Gowalla-shaped tables (29,858 + 40,981) x 64 = 4,533,696 fp32
// elements that is 126.9 MB a step -> 37.9 us at 3.35 TB/s (38.1 us with NGCF's 12 small leaves);
// its ~12 operations per element take 0.8 us at 67 TFLOP/s. So it is bound by bytes.
//
// Design: the host passes a table of up to 64 leaves by value (a __grid_constant__ parameter),
// built once per optimizer state with only the gradient pointers filled in each step. Every leaf
// is cut into chunks of kChunk = 2,048 elements (the wrapper's CHUNK: the smallest that gives
// each of a block's 256 threads a 16-byte bf16 access); the table holds each leaf's first global
// chunk index.
// Block b takes chunks b, b + grid, ... and finds a chunk's leaf by a binary search over the
// table (uniform across the block, so the parameter reads broadcast). The grid is min(chunks,
// SMs x resident blocks): every block stays resident and loops, so the last round's imbalance is
// one small chunk, and a small leaf costs a chunk, not a launch. Within a chunk each thread moves
// 16 bytes per array per access (float4 = 4 fp32, uint4 = 8 bf16), consecutive threads on
// consecutive addresses, when the leaf's four pointers are 16-byte aligned (chunk starts keep that
// alignment); an unaligned leaf, and the ragged end of every leaf, take a scalar loop. Loads and
// stores are evict-first (each byte is touched once). No TMA or cp.async: an elementwise pass has
// no reuse for them to serve, and the resident blocks keep enough bytes in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kChunk = 2048;  // elements a block takes at a time: a multiple of 8 (16-byte bf16)
constexpr int kBf16 = 1;     // flags bit: the leaf is bf16 (else fp32)
constexpr int kAligned = 2;  // flags bit: p, m, v and g (where given) are 16-byte aligned

}  // namespace

// Host-side layout, mirrored by ctypes in gsrs_tpu_torch/train/fused_adam.py.
struct GsrsAdamLeaf {
  void* p;
  void* m;
  void* v;
  const void* g;  // null: a zero gradient
  long long n;    // elements
  int32_t chunk0;  // the leaf's first global chunk index
  int32_t flags;   // kBf16 | kAligned
};

struct GsrsAdamTable {
  GsrsAdamLeaf leaf[kMaxLeaves];
  int32_t n_chunks;  // chunks of all leaves
};

namespace {

struct AdamConsts {
  float lr, c1, c2, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adam(float& p, float& m, float& v, float g, const AdamConsts& k) {
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(k.omb2, __fmul_rn(g, g)));
  const float upd =
      __fdiv_rn(__fmul_rn(m, k.c1), __fadd_rn(__fsqrt_rn(__fmul_rn(v, k.c2)), k.eps));
  p = __fsub_rn(p, __fmul_rn(k.lr, upd));
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t u) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = u;
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t f2_to_bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One type's scalar and 16-byte accesses. kVec elements make 16 bytes.
template <typename T>
struct Access;

template <>
struct Access<float> {
  static constexpr int kVec = 4;
  __device__ static float load(const float* q) { return __ldcs(q); }
  __device__ static void store(float* q, float x) { __stcs(q, x); }
  __device__ static void load_vec(const float* q, float (&x)[4]) {
    const float4 r = __ldcs(reinterpret_cast<const float4*>(q));
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
  }
  __device__ static void store_vec(float* q, const float (&x)[4]) {
    __stcs(reinterpret_cast<float4*>(q), make_float4(x[0], x[1], x[2], x[3]));
  }
};

template <>
struct Access<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float load(const __nv_bfloat16* q) {
    const unsigned short r = __ldcs(reinterpret_cast<const unsigned short*>(q));
    return __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
  __device__ static void store(__nv_bfloat16* q, float x) {
    __stcs(reinterpret_cast<unsigned short*>(q),
           static_cast<unsigned short>(f2_to_bf2(x, 0.f) & 0xffffu));
  }
  __device__ static void load_vec(const __nv_bfloat16* q, float (&x)[8]) {
    const uint4 r = __ldcs(reinterpret_cast<const uint4*>(q));
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = bf2_to_f2(w[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static void store_vec(__nv_bfloat16* q, const float (&x)[8]) {
    __stcs(reinterpret_cast<uint4*>(q), make_uint4(f2_to_bf2(x[0], x[1]), f2_to_bf2(x[2], x[3]),
                                                   f2_to_bf2(x[4], x[5]), f2_to_bf2(x[6], x[7])));
  }
};

// Elements [e0, e1) of one leaf, by the block's threads.
template <typename T>
__device__ __forceinline__ void adam_span(const GsrsAdamLeaf& leaf, long long e0, long long e1,
                                          const AdamConsts& k) {
  using A = Access<T>;
  constexpr int V = A::kVec;
  T* __restrict__ p = static_cast<T*>(leaf.p);
  T* __restrict__ m = static_cast<T*>(leaf.m);
  T* __restrict__ v = static_cast<T*>(leaf.v);
  const T* __restrict__ g = static_cast<const T*>(leaf.g);
  long long e = e0;
  if (leaf.flags & kAligned) {  // e0 is a multiple of the chunk, so of V: aligned too
    const long long nv = (e1 - e0) / V;
    for (long long i = threadIdx.x; i < nv; i += kThreads) {
      const long long o = e0 + i * V;
      float pf[V], mf[V], vf[V], gf[V];
      A::load_vec(p + o, pf);
      A::load_vec(m + o, mf);
      A::load_vec(v + o, vf);
      if (g != nullptr) {
        A::load_vec(g + o, gf);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) gf[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) adam(pf[j], mf[j], vf[j], gf[j], k);
      A::store_vec(p + o, pf);
      A::store_vec(m + o, mf);
      A::store_vec(v + o, vf);
    }
    e = e0 + nv * V;
  }
  for (long long i = e + threadIdx.x; i < e1; i += kThreads) {
    float pf = A::load(p + i), mf = A::load(m + i), vf = A::load(v + i);
    adam(pf, mf, vf, g != nullptr ? A::load(g + i) : 0.f, k);
    A::store(p + i, pf);
    A::store(m + i, mf);
    A::store(v + i, vf);
  }
}

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const __grid_constant__ GsrsAdamTable table, int n_leaves, AdamConsts k) {
  for (int c = blockIdx.x; c < table.n_chunks; c += gridDim.x) {
    // the last leaf whose first chunk is <= c (an empty leaf shares its first chunk with the
    // next one, so the search passes over it)
    int lo = 0, hi = n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table.leaf[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
    }
    const GsrsAdamLeaf& leaf = table.leaf[lo];
    const long long e0 = static_cast<long long>(c - leaf.chunk0) * kChunk;
    const long long e1 = min(e0 + kChunk, leaf.n);
    if (leaf.flags & kBf16)
      adam_span<__nv_bfloat16>(leaf, e0, e1, k);
    else
      adam_span<float>(leaf, e0, e1, k);
  }
}

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

int resident_blocks() {  // blocks of the kernel one SM holds at once, the same on every card here
  static int blocks = 0;
  if (blocks == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_adam_kernel, kThreads, 0) !=
          cudaSuccess)
    blocks = 0;
  return blocks;
}

}  // namespace

// Launches one update of the table's n_leaves leaves on `stream` and returns cudaGetLastError()
// (0 on success; a refused launch never runs, so the caller checks this value). Returns
// cudaErrorInvalidValue, and launches nothing, for a table it cannot take: more than 64 leaves, a
// chunk prefix that does not follow the leaves' sizes, a null p, m or v of a leaf that is not
// empty, or an aligned flag on a pointer that is not 16-byte aligned. A table with no elements launches nothing and returns 0.
extern "C" int gsrs_fused_adam_leaves(const GsrsAdamTable* table, int n_leaves, float lr,
                                      float c1, float c2, float b1, float omb1, float b2,
                                      float omb2, float eps, void* stream) {
  if (table == nullptr || n_leaves < 0 || n_leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  long long chunks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const GsrsAdamLeaf& leaf = table->leaf[i];
    if (leaf.n < 0 || leaf.chunk0 != chunks ||
        (leaf.n > 0 && (leaf.p == nullptr || leaf.m == nullptr || leaf.v == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    if ((leaf.flags & kAligned) && !(aligned16(leaf.p) && aligned16(leaf.m) &&
                                     aligned16(leaf.v) && aligned16(leaf.g)))
      return static_cast<int>(cudaErrorInvalidValue);
    chunks += (leaf.n + kChunk - 1) / kChunk;
    if (chunks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (chunks != table->n_chunks) return static_cast<int>(cudaErrorInvalidValue);
  if (chunks == 0) return 0;
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const int resident = resident_blocks();
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = chunks < (long long)sms * resident ? chunks : (long long)sms * resident;
  const AdamConsts k{lr, c1, c2, b1, omb1, b2, omb2, eps};
  fused_adam_kernel<<<static_cast<int>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *table, n_leaves, k);
  return static_cast<int>(cudaGetLastError());
}
