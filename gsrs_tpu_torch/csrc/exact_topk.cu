// Exact row-wise top-k for Hopper (sm_90a), fp32 scores, in lax.top_k's order.
//
// Replaces no Pallas kernel. It stands in for lax.top_k in the exact branch of
// gsrs_tpu/ops/topk.py::topk_scores, which XLA lowers by itself on the TPU. On the H100 the
// port's plain version (torch.topk of k + 1 columns, two sorts of the k kept, and a host read
// of the rows whose k-th and (k + 1)-th values tie) read each score row several times, made
// 25-30 launches and one blocking read a call, and ran at about a tenth of its byte bound at
// the full-catalog eval batch.
//
//   for each row b of scores (B, m): the k columns of largest key, in descending key order, with
//   key(c) = (order_key(scores[b, c]) with its sign bit flipped) << 32 | ~c   (64 bits, unsigned)
//   order_key(x): x's bits, its magnitude bits flipped when its sign is set, as an int32; that
//   is XLA's total order of floats, where -0.0 ranks below +0.0.
// Keys are distinct, so neither the set nor its order has a tie case: equal scores rank lowest
// column first, as lax.top_k ranks them. values[b, j] are the input's own bits, decoded from
// the key; ids[b, j] its column. The result does not depend on the order in which threads or
// blocks run, and the host reads nothing.
//
// Bound: one read of the scores, B * m * 4 bytes (the k outputs a row are noise): 750 MB at the
// amazon-book eval batch (2048 x 91,599), 224 us at 3.35 TB/s. Bound by bytes; a key and a
// compare are a few integer operations a score.
//
// Design (BlockSelect). A block of 256 threads takes one row. It streams the row in rounds of 2,048 scores, two 16-byte cp.async copies a thread into a
// ring of two rounds in shared memory, so one round is in flight while the last is filtered.
// Shared memory also holds the block's top k keys at [0, k), sorted, and a queue of candidates
// behind them. A thread drops every key below the threshold (the k-th key so far) with one
// 64-bit compare and pushes the rest to the queue (a shared atomic; three counters in turn, so a
// round needs one barrier). When more than kSoft candidates wait, or at the end, the queue and
// the top k are sorted together (bitonic, in shared memory, over the next power of two) and the
// first k kept, which raises the threshold. The first round sets its threshold without sorting
// its 2,048 keys: the k-th largest of the 256 threads' maxima is at most the k-th largest key
// of the round (the k largest maxima are k keys at least that large), so a sort of 256 keys
// gives it. On score rows only about k * ln(m / 2048) keys pass after the first round, so the
// sorts stay small and the loads set the pace. The queue holds a whole round behind k and kSoft
// keys, so rows that rise all the way (every key passes) are only slower. On the H100 a deeper
// ring (3, 4 or 6 rounds), a queue of 1,024 keys (more blocks an SM) and a register prefetch
// instead of the ring all measured slower at the eval batch.
//
// Ragged rows. A row starts at any 4-byte offset (m odd): the up to 3 columns before its first
// 16-byte boundary and the up to 3 after its last whole float4 are read as scalars by threads
// 0-2 and 4-6 of the first round.
//
// One block a row at every batch. A request (B = 1) leaves the card mostly empty, but its row
// is read in about 27 us at the Gowalla catalog, and cutting it across blocks saved no time end
// to end there: the merge's scratch and second launch cost the host what the card saved.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef unsigned long long Key;

constexpr int kThreads = 256;
constexpr int kVec = 2;                        // 16-byte loads a thread a round
constexpr int kPerThread = 4 * kVec;           // scores a thread a round
constexpr int kRoundVecs = kThreads * kVec;    // float4s a block a round
constexpr int kRound = kThreads * kPerThread;  // scores a block a round
constexpr int kMaxK = 256;
constexpr int kSoft = 256;   // sort the queue in once more than this many candidates wait
constexpr int kBuf = 4096;   // shared keys: the top k, then the queue
constexpr int kStages = 2;   // rounds of scores a block holds: a cp.async ring
constexpr int kMaxDevices = 64;
// a round's pushes, the first round's scalar columns among them, fit behind k and kSoft
static_assert(kMaxK + kSoft + kRound + kThreads <= kBuf, "the queue holds a round");
static_assert(kMaxK <= kThreads, "the first threshold is the k-th of the threads' maxima");

struct Shared {
  Key buf[kBuf];
  Key maxima[kThreads];
  int pushed[3];
};
// exact_topk_kernel's dynamic shared memory: the ring, then Shared
constexpr size_t kRingBytes = sizeof(float4) * kStages * kRoundVecs;
constexpr size_t kScoreSmem = kRingBytes + sizeof(Shared);

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ Key score_key(float x, uint32_t col) {
  const int b = __float_as_int(x);
  const uint32_t hi = static_cast<uint32_t>(b ^ ((b >> 31) & 0x7FFFFFFF)) ^ 0x80000000u;
  return (static_cast<Key>(hi) << 32) | static_cast<uint32_t>(~col);
}

__device__ __forceinline__ void store_decoded(Key key, float* value, long long* id) {
  const int ok = static_cast<int>(static_cast<uint32_t>(key >> 32) ^ 0x80000000u);
  *value = __int_as_float(ok ^ ((ok >> 31) & 0x7FFFFFFF));
  *id = static_cast<long long>(~static_cast<uint32_t>(key));
}

// Sorts a[0, n) descending, n a power of two. Every thread of the block calls it, after a
// barrier that makes a[0, n) visible; it ends with one.
__device__ void bitonic_sort_desc(Key* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const Key x = a[lo], y = a[hi];
        if ((x < y) == ((lo & size) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// a[0, k) ← the top k of a[0, k + waiting), sorted. Every thread calls it after a barrier.
__device__ void sort_in(Key* a, int k, int waiting) {
  const int n = k + waiting;
  int p = 1;
  while (p < n) p <<= 1;
  for (int i = n + threadIdx.x; i < p; i += kThreads) a[i] = 0;
  __syncthreads();
  bitonic_sort_desc(a, p);
}

// One score row: the float4s [0, nv) of its aligned body, then its scalar columns. Round r's
// float4s are copied into slot r % kStages of the ring kStages - 1 rounds ahead; each thread
// reads back only the 16-byte cells it copied, so its own cp.async.wait_group orders them.
struct ScoreSource {
  float4* ring;
  const float* row;    // column 0
  const float4* body;  // column `head`, the row's first 16-byte boundary
  int head;
  long long nv;
  int extra;  // this thread's scalar column in the first round, or -1
  int rounds;

  __device__ __forceinline__ long long vec(int r, int v) const {
    return static_cast<long long>(r) * kRoundVecs + v * kThreads + threadIdx.x;
  }
  __device__ __forceinline__ void copy_round(int r) const {
    if (r < rounds) {
      float4* slot = ring + (r % kStages) * kRoundVecs + threadIdx.x;
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const long long j = vec(r, v);
        cp_async16(slot + v * kThreads, j < nv ? body + j : body, j < nv);
      }
    }
    cp_async_commit();  // one group a round, empty past the end
  }
  __device__ __forceinline__ void start() const {
#pragma unroll
    for (int r = 0; r < kStages - 1; ++r) copy_round(r);
  }
  __device__ __forceinline__ void keys(int r, Key* out) const {
    copy_round(r + kStages - 1);
    cp_async_wait<kStages - 1>();
    const float4* slot = ring + (r % kStages) * kRoundVecs + threadIdx.x;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const long long j = vec(r, v);
      const float4 x = slot[v * kThreads];
      const uint32_t c = static_cast<uint32_t>(head + 4 * j);
      const bool in = j < nv;
      out[4 * v + 0] = in ? score_key(x.x, c + 0) : 0;
      out[4 * v + 1] = in ? score_key(x.y, c + 1) : 0;
      out[4 * v + 2] = in ? score_key(x.z, c + 2) : 0;
      out[4 * v + 3] = in ? score_key(x.w, c + 3) : 0;
    }
    out[kPerThread] = r == 0 && extra >= 0 ? score_key(__ldcs(row + extra), extra) : 0;
  }
};

// sh.buf[0, k) ← the top k keys of `src`'s row, sorted descending.
__device__ void select_topk(const ScoreSource& src, int k, Shared& sh) {
  const int t = threadIdx.x;
  for (int i = t; i < k; i += kThreads) sh.buf[i] = 0;
  if (t < 3) sh.pushed[t] = 0;
  src.start();
  __syncthreads();
  Key threshold = 0;  // a key below it is not among the top k
  int waiting = 0;    // candidates queued at buf[k, k + waiting)
  for (int r = 0; r < src.rounds; ++r) {
    Key key[kPerThread + 1];
    src.keys(r, key);
    if (r == 0) {
      Key most = 0;
#pragma unroll
      for (int e = 0; e <= kPerThread; ++e) most = key[e] > most ? key[e] : most;
      sh.maxima[t] = most;
      __syncthreads();
      bitonic_sort_desc(sh.maxima, kThreads);
      threshold = sh.maxima[k - 1];
    }
    int* pushed = &sh.pushed[r % 3];
#pragma unroll
    for (int e = 0; e <= kPerThread; ++e)
      if (key[e] != 0 && key[e] >= threshold) sh.buf[k + waiting + atomicAdd(pushed, 1)] = key[e];
    // round r - 2's counter: every thread read it before the last barrier
    if (t == 0) sh.pushed[(r + 1) % 3] = 0;
    __syncthreads();
    waiting += *pushed;
    if (waiting > kSoft || (r + 1 == src.rounds && waiting > 0)) {
      sort_in(sh.buf, k, waiting);
      threshold = sh.buf[k - 1];
      waiting = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    exact_topk_kernel(const float* __restrict__ scores, int m, int k, float* __restrict__ values,
                      long long* __restrict__ ids) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem + kRingBytes);
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  ScoreSource src;
  src.ring = reinterpret_cast<float4*>(smem);
  src.row = scores + b * m;
  src.head = static_cast<int>((4 - ((reinterpret_cast<uintptr_t>(src.row) >> 2) & 3)) & 3);
  if (src.head > m) src.head = m;
  src.body = reinterpret_cast<const float4*>(src.row + src.head);
  src.nv = (m - src.head) >> 2;
  const int tail = static_cast<int>(m - src.head - 4 * src.nv);
  src.rounds = static_cast<int>((src.nv + kRoundVecs - 1) / kRoundVecs);
  if (src.rounds == 0) src.rounds = 1;
  src.extra = -1;
  if (t < src.head) src.extra = t;
  if (t >= 4 && t < 4 + tail) src.extra = static_cast<int>(src.head + 4 * src.nv + (t - 4));
  select_topk(src, k, sh);
  for (int j = t; j < k; j += kThreads) store_decoded(sh.buf[j], values + b * k + j, ids + b * k + j);
}

}  // namespace

// scores (B, m) fp32, row-major and contiguous; values (B, k) fp32 and ids (B, k) int64 are
// written. Launches exact_topk_kernel on `stream`, one block a row, and returns
// cudaGetLastError() (0 on success): a refused launch never runs and a later synchronize does
// not report it, so the caller checks this value. The kernel's shared-memory limit is raised
// once a device, at its first call there. Returns cudaErrorInvalidValue unless B >= 1 and
// 1 <= k <= 256 and k < m.
extern "C" int gsrs_exact_topk(const float* scores, int B, int m, int k, float* values,
                               long long* ids, void* stream) {
  static std::atomic<bool> ready[kMaxDevices];
  if (B < 1 || k < 1 || k > kMaxK || k >= m) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(exact_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kScoreSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev].store(true, std::memory_order_release);
  }
  exact_topk_kernel<<<B, kThreads, kScoreSmem, static_cast<cudaStream_t>(stream)>>>(
      scores, m, k, values, ids);
  return static_cast<int>(cudaGetLastError());
}
