// Shared helpers of the paged attention kernels (decode_attention.cu,
// prefill_attention.cu): element conversion (the 8-bit pool types
// included), 16-byte vector loads, warp and quad reductions, the score
// transform, and the tensor-core building blocks of the bf16 routes
// (cp.async, ldmatrix, mma.sync m16n8k16, the shared-memory swizzle, the
// widening of 8-bit pool chunks to bf16); the launch-side shared-memory
// opt-in is in smem_optin.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "smem_optin.cuh"

// Online-softmax seed when a row has no sink logit: finite, so that
// exp(MASK - m) is exactly 0 once a real score arrives (the TPU kernels'
// MASK value, ops/pallas/decode_attention.py).
#define ATTN_MASK (-0.7f * FLT_MAX)

// The bf16 routes keep scores in log2 units (score * log2(e)) so that a
// probability is one ex2; ATTN_MASK itself is never rescaled.
#define ATTN_LOG2E 1.4426950408889634f

enum AttnDtype { ATTN_F32 = 0, ATTN_BF16 = 1 };

// The pool's element type: q's own, or an 8-bit quantized pool (int8, or
// float8 e4m3) whose values are dequantized by a per-layer scale as the
// reference does: x * scale in float32, then rounded to q's type
// (ops/cuda/decode_attention.py KV_DTYPES, dequant_kv).
enum AttnKv { KV_SAME = 0, KV_INT8 = 1, KV_E4M3 = 2 };

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) { return (float)x; }
template <> __device__ __forceinline__ float to_f<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}

// The C++ element type of an 8-bit pool kind (the float32 routes' loads).
template <int KV> struct KvElem;
template <> struct KvElem<KV_INT8> { typedef int8_t T; };
template <> struct KvElem<KV_E4M3> { typedef __nv_fp8_e4m3 T; };

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

// Reductions over the four lanes that share one accumulator row of an
// mma.m16n8k16 result (lanes 4g .. 4g+3).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

// The same transform for the bf16 routes when ALiBi or a soft cap is on:
// the slope is already in a register (0 without ALiBi) and the result is
// in log2 units.
__device__ __forceinline__ float attn_score_log2(float dot, float sm_scale, float slope,
                                                int kv_pos, int q_pos, float soft_cap) {
  float s = dot * sm_scale + slope * (float)(kv_pos - q_pos);
  if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
  return s * ATTN_LOG2E;
}

// 2^x in one MUFU instruction (relative error 2^-22): 0 for -inf and for
// anything below -126, 1 for 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// How the prefill kernels' CTAs of `rows` score rows (tokens x query
// heads) cover a KV head's `group` query heads: a group of up to `rows`
// heads is one chunk (rows are tokens x group); a larger one (Falcon-7B's
// 71 over one KV head) is cut into the fewest chunks of at most `rows`
// heads, as equal as they can be (the last may have fewer live heads),
// each CTA then holding one token of one chunk. The grid's second axis is
// KV head x chunk.
struct HeadChunks {
  int n;      // chunks per KV head
  int size;   // heads of a chunk: the rows a token takes in a CTA
};

__host__ __device__ inline HeadChunks head_chunks(int group, int rows) {
  const int n = (group + rows - 1) / rows;
  return {n, (group + n - 1) / n};
}

// This split's share [*lo, *hi) of a decode row's visible positions. The
// visible range starts at the sliding window's first position (rounded
// down to a tile) and is cut into `splits` runs of whole tiles, so a
// window moves the first split instead of leaving early splits empty.
// *lo >= *hi for a split that has nothing to read.
__device__ __forceinline__ void split_range(int kv_len, int window, int tile,
                                            int splits, int split, int* lo, int* hi) {
  int start = window > 0 ? max(0, kv_len - window) : 0;   // kv_pos > q_pos - window
  start = (start / tile) * tile;
  const int tiles = kv_len > start ? (kv_len - start + tile - 1) / tile : 0;
  const int per = (tiles + splits - 1) / splits;
  *lo = start + min(split * per, tiles) * tile;
  *hi = min(kv_len, start + min((split + 1) * per, tiles) * tile);
}

// ---- tensor-core building blocks (bf16 routes) -------------------------

// Width in bf16 of the shared-memory operand tiles for head dim `hd`: the
// 128-byte swizzle and the mma shapes take rows of 64, 128 or 256 values,
// so hd 80 and 96 (GPT-NeoX-20B, Phi-3-mini, StableLM-3B) are staged as
// 128-wide tiles whose columns past hd are zero-filled on the way in:
// they add 0 to every dot and give output columns that are never stored.
// Global memory is read and written at hd, so the bytes moved are the
// pool's own.
__host__ __device__ constexpr int tile_hd(int hd) { return hd == 80 || hd == 96 ? 128 : hd; }

// Byte offset of the 16-byte chunk `c` of row `r` in a shared-memory tile
// whose rows hold HD bf16 values (128 or 256 bytes). The chunk index is
// XORed with the row's low three bits, so the eight rows of one ldmatrix
// 8x8 block land in eight different 16-byte bank groups.
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * (HD * 2) + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared; with `pred` false nothing is
// read and the 16 bytes are zero-filled (src must still be a valid
// address).
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool pred) {
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Four 8x8 bf16 blocks; lane l gives the address of row l % 8 of block
// l / 8 (16 bytes, 16-byte aligned).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The same, each block transposed on the way (B fragments of P.V from a
// [position][dim] tile).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// D += A (16x16 bf16, row) * B (16x8 bf16, col), float32 accumulation.
// Accumulator of lane 4g+t: c[0], c[1] = row g, columns 2t, 2t+1; c[2],
// c[3] = row g+8, the same columns.
__device__ __forceinline__ void mma_m16n8k16(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Byte I of a word of four 8-bit pool values as a float, without a
// conversion instruction (the dequant runs in the kernels' inner loops):
// int8 by the 2^23 magic number, on the word biased by kv8_bias (one
// byte permute to 2^23 + (x + 128), then minus 2^23 + 128: exact); e4m3
// by moving its exponent and mantissa bits into float's low exponent and
// high mantissa bits (shifts and masks, which ran K1 faster on an H100
// than a byte permute first), which gives the value times 2^-120 exactly
// (a float denormal for e4m3's denormals), so `kv8_unit` folds 2^120
// into the scale: (v 2^-120) (s 2^120) rounds once, to the same float as
// v * s.
template <int KV, int I>
__device__ __forceinline__ float kv8_at(uint32_t w) {
  static_assert(KV == KV_INT8 || KV == KV_E4M3, "an 8-bit pool type");
  if constexpr (KV == KV_INT8) {
    return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | I)) - 8388736.f;
  } else {
    const uint32_t b = (w >> (8 * I)) & 0xFFu;
    return __uint_as_float(((b & 0x80u) << 24) | ((b & 0x7Fu) << 20));
  }
}

// The word kv8_at reads: int8 bytes biased to unsigned (x + 128).
template <int KV> __device__ __forceinline__ uint32_t kv8_bias(uint32_t w) {
  return KV == KV_INT8 ? w ^ 0x80808080u : w;
}

// The multiplier of kv8_at's floats that dequantizes by `scale`.
template <int KV> __device__ __forceinline__ float kv8_unit(float scale) {
  return KV == KV_E4M3 ? scale * __uint_as_float(0x7B800000u) : scale;   // 2^120
}

// One 16-byte chunk of an 8-bit pool row (16 values) dequantized to bf16
// as the reference does, bf16(x * scale) with the product in float32
// (`unit` = kv8_unit(scale)): the first 8 values into `lo`, the next 8
// into `hi`, in memory order.
template <int KV>
__device__ __forceinline__ void widen16(const uint4& raw, float unit, uint4& lo,
                                        uint4& hi) {
  const uint32_t w[4] = {kv8_bias<KV>(raw.x), kv8_bias<KV>(raw.y), kv8_bias<KV>(raw.z),
                         kv8_bias<KV>(raw.w)};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = pack_bf16(kv8_at<KV, 0>(w[i]) * unit, kv8_at<KV, 1>(w[i]) * unit);
    o[2 * i + 1] = pack_bf16(kv8_at<KV, 2>(w[i]) * unit, kv8_at<KV, 3>(w[i]) * unit);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// A per-layer dequant scale from device memory (a 0-dim float32 tensor:
// it stays a pointer so that a CUDA graph reads the value current at each
// replay); 1 without one.
__device__ __forceinline__ float load_scale(const float* scale) {
  return scale != nullptr ? *scale : 1.f;
}
