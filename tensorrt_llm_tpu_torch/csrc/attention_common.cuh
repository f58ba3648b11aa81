// Shared helpers of the paged attention kernels (decode_attention.cu,
// prefill_attention.cu): element conversion, 16-byte vector loads, warp
// reductions and the launch-side shared-memory opt-in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

// Online-softmax seed when a row has no sink logit: finite, so that
// exp(MASK - m) is exactly 0 once a real score arrives (the TPU kernels'
// MASK value, ops/pallas/decode_attention.py).
#define ATTN_MASK (-0.7f * FLT_MAX)

enum AttnDtype { ATTN_F32 = 0, ATTN_BF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Elements of T in one 16-byte load.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// Load Vec<T>::N consecutive elements (16-byte aligned) as floats.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) dst[i] = to_f<T>(e[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Score transform shared by both kernels, in the order of the reference
// path (ops/attention.py _reference_attention): scale, ALiBi bias, soft
// cap. Returns -inf for a masked position.
__device__ __forceinline__ float attn_score(float dot, float sm_scale,
                                           const float* alibi, int head,
                                           int kv_pos, int q_pos,
                                           float soft_cap, bool valid) {
  if (!valid) return -INFINITY;
  float s = dot * sm_scale;
  if (alibi != nullptr) s += alibi[head] * (float)(kv_pos - q_pos);
  if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
  return s;
}

// Dynamic shared memory above 48 KB needs an explicit opt-in per kernel.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
