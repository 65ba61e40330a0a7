// One-pass bias-corrected Adam for Hopper (sm_90a), fp32 or bf16 leaves.
//
// Replaces the TPU kernel of gsrs_tpu/train/fused_adam.py: _fused_adam_leaf_pallas (pallas_call
// at :107, body _fused_adam_kernel :62-70, math _adam_math :46-58). Per element, in fp32:
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * (g * g)
//   p' = p - lr * (m' * c1) / (sqrt(v' * c2) + eps)          c1 = 1/(1-b1^t), c2 = 1/(1-b2^t)
// and p', m', v' are stored back in place in the leaf's dtype (round to nearest even for bf16).
// Every product, sum and quotient is a separately rounded IEEE operation (no contraction into
// FMAs), in the order above, so the kernel gives the bits of the plain PyTorch version, which
// runs the same operations one by one. lr, c1, c2 and the four constants b1, 1 - b1, b2,
// 1 - b2 arrive by value, computed on the host (so the step needs no device read).
//
// Bound on an H100 SXM: it reads p, m, v, g once and writes p, m, v once: 28 bytes per fp32
// element. For the Gowalla-shaped tables (29,858 + 40,981) x 64 = 4,533,696 elements that is
// 126.9 MB per step -> 37.9 us at 3.35 TB/s; its ~12 operations per element take 0.8 us at
// 67 TFLOP/s. So it is bound by bytes.
//
// Design: one elementwise pass over the flat storage of a leaf, a grid-stride loop with each
// thread on consecutive elements of consecutive blocks (coalesced 128-byte accesses per warp).
// The ragged tail is masked by the loop bound: nothing is padded, unlike the TPU kernel's
// 128-lane rows. Vector (float4) loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(T* __restrict__ p, T* __restrict__ m, T* __restrict__ v,
                  const T* __restrict__ g, long long n, float lr, float c1, float c2, float b1,
                  float omb1, float b2, float omb2, float eps) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const float g32 = to_f32(g[i]);
    const float m32 = __fadd_rn(__fmul_rn(b1, to_f32(m[i])), __fmul_rn(omb1, g32));
    const float v32 =
        __fadd_rn(__fmul_rn(b2, to_f32(v[i])), __fmul_rn(omb2, __fmul_rn(g32, g32)));
    const float upd = __fdiv_rn(__fmul_rn(m32, c1), __fadd_rn(__fsqrt_rn(__fmul_rn(v32, c2)), eps));
    store(p + i, __fsub_rn(to_f32(p[i]), __fmul_rn(lr, upd)));
    store(m + i, m32);
    store(v + i, v32);
  }
}

}  // namespace

// Launches the update of one leaf of n elements on `stream` and returns cudaGetLastError()
// (0 on success); a refused launch never runs, so the caller checks this value.
extern "C" int gsrs_fused_adam(void* p, void* m, void* v, const void* g, long long n, float lr,
                               float c1, float c2, float b1, float omb1, float b2, float omb2,
                               float eps, int bf16, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond 64 blocks per SM
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16)
      fused_adam_kernel<__nv_bfloat16><<<(int)blocks, kThreads, 0, s>>>(
          static_cast<__nv_bfloat16*>(p), static_cast<__nv_bfloat16*>(m),
          static_cast<__nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g), n, lr, c1, c2,
          b1, omb1, b2, omb2, eps);
    else
      fused_adam_kernel<float><<<(int)blocks, kThreads, 0, s>>>(
          static_cast<float*>(p), static_cast<float*>(m), static_cast<float*>(v),
          static_cast<const float*>(g), n, lr, c1, c2, b1, omb1, b2, omb2, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
