// Paged GQA decode attention: one query token per sequence.
//
// Replaces the TPU kernel paged_decode_attention
// (tensorrt_llm_tpu/ops/pallas/decode_attention.py:164, body _kernel :33).
// Same function: q [S, qh, hd]; KV pool [P, ps, 2*kvh, hd] with k of head
// h at combined index 2h and v at 2h+1; kv_lens i32[S]; page_indices
// i32[S, max_pages] (entries clamped to [0, P-1]); online softmax over the
// sequence's KV in float32, seeded with the sink logit when given;
// optional sliding window, logit soft cap and ALiBi; out [S, qh, hd] in
// q's type. A sequence with kv_len 0 yields zeros.
//
// Design (simple first version): one CTA per (sequence, KV head). The CTA
// holds the `group` query heads that share that KV head, walks the
// sequence's pages in tiles of 32 positions (16-byte vector loads into
// shared memory, converted to float32), scores all group x 32 pairs, runs
// the online-softmax update with one warp per query head and accumulates
// P.V in shared memory.
//
// What bounds it on the H100: the KV bytes it must read (each K and V row
// once), so the bound is bytes / 3.35 TB/s. What this design leaves on the
// table: only S*kvh CTAs (256 at 64 sequences x 4 KV heads, under two per
// SM), no split over the KV axis (flash-decoding), no cp.async/TMA
// pipelining of the next tile behind the current one's math, and CUDA-core
// float32 dot products.

#include "attention_common.cuh"

namespace {

constexpr int kTile = 32;      // KV positions per tile (one per lane)
constexpr int kThreads = 128;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kv,
              const int* __restrict__ kv_lens,
              const int* __restrict__ page_idx,
              const float* __restrict__ sinks,
              const float* __restrict__ alibi, T* __restrict__ out, int qh,
              int kvh, int ps, int num_pages, int max_pages, float sm_scale,
              int window, float soft_cap) {
  constexpr int V = Vec<T>::N;
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int group = qh / kvh;
  const int combined = 2 * kvh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;

  extern __shared__ float smem[];
  float* q_s = smem;                          // [group][HD]
  float* k_s = q_s + group * HD;              // [kTile][HD + 1]
  float* v_s = k_s + kTile * (HD + 1);        // [kTile][HD]
  float* p_s = v_s + kTile * HD;              // [group][kTile]
  float* acc = p_s + group * kTile;           // [group][HD]
  float* m_s = acc + group * HD;              // [group]
  float* l_s = m_s + group;                   // [group]
  float* a_s = l_s + group;                   // [group] rescale factor

  const int kv_len = kv_lens[s];
  const int q_pos = kv_len - 1;
  const T* q_row = q + ((size_t)s * qh + (size_t)h * group) * HD;
  for (int i = tid * V; i < group * HD; i += kThreads * V) load_vec<T>(q_row + i, q_s + i);
  for (int i = tid; i < group * HD; i += kThreads) acc[i] = 0.f;
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = sinks != nullptr ? sinks[h * group + g] : ATTN_MASK;
    l_s[g] = sinks != nullptr ? 1.f : 0.f;
  }

  int start = 0;
  if (window > 0) start = max(0, kv_len - window);   // kv_pos > q_pos - window
  start = (start / kTile) * kTile;
  const int* pt = page_idx + (size_t)s * max_pages;

  for (int base = start; base < kv_len; base += kTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid * V; i < kTile * HD; i += kThreads * V) {
      const int t = i / HD;
      const int d = i % HD;
      const int pos = base + t;
      float kr[V], vr[V];
      if (pos < kv_len) {
        int page = pt[min(pos / ps, max_pages - 1)];
        page = min(max(page, 0), num_pages - 1);
        const T* row = kv + (((size_t)page * ps + pos % ps) * combined + 2 * h) * HD;
        load_vec<T>(row + d, kr);
        load_vec<T>(row + HD + d, vr);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) kr[j] = vr[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        k_s[t * (HD + 1) + d + j] = kr[j];
        v_s[t * HD + d + j] = vr[j];
      }
    }
    __syncthreads();
    for (int i = tid; i < group * kTile; i += kThreads) {
      const int g = i / kTile;
      const int t = i % kTile;
      const int pos = base + t;
      const float* qr = q_s + g * HD;
      const float* kr = k_s + t * (HD + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += qr[d] * kr[d];
      const bool valid = pos < kv_len && (window <= 0 || pos > q_pos - window);
      p_s[i] = attn_score(dot, sm_scale, alibi, h * group + g, pos, q_pos,
                          soft_cap, valid);
    }
    __syncthreads();
    for (int g = warp; g < group; g += nwarps) {
      const float sc = p_s[g * kTile + lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(sc));
      const float p = sc == -INFINITY ? 0.f : expf(sc - m_new);
      const float sum = warp_sum(p);
      p_s[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < group * HD; i += kThreads) {
      const int g = i / HD;
      const int d = i % HD;
      const float* pr = p_s + g * kTile;
      float a = acc[i] * a_s[g];
#pragma unroll 8
      for (int t = 0; t < kTile; ++t) a += pr[t] * v_s[t * HD + d];
      acc[i] = a;
    }
  }
  __syncthreads();
  T* o_row = out + ((size_t)s * qh + (size_t)h * group) * HD;
  for (int i = tid; i < group * HD; i += kThreads)
    o_row[i] = from_f<T>(acc[i] / fmaxf(l_s[i / HD], 1e-30f));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kv, const int* kv_lens,
                   const int* page_idx, const float* sinks, const float* alibi,
                   void* out, int S, int qh, int kvh, int ps, int num_pages,
                   int max_pages, float sm_scale, int window, float soft_cap,
                   cudaStream_t stream) {
  const int group = qh / kvh;
  const size_t smem = sizeof(float) *
      (2 * group * HD + kTile * (HD + 1) + kTile * HD + group * kTile + 3 * group);
  auto kernel = decode_kernel<T, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S, kvh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), kv_lens, page_idx,
      sinks, alibi, static_cast<T*>(out), qh, kvh, ps, num_pages, max_pages,
      sm_scale, window, soft_cap);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes. Returns a cudaError_t (0 = launched).
// dtype: 0 float32, 1 bfloat16 (q, pool and out share it). sinks and alibi
// are float32 [qh] device pointers or null. window <= 0 and soft_cap <= 0
// disable those options.
extern "C" int paged_decode_attention(
    const void* q, const void* kv, const int* kv_lens, const int* page_idx,
    const float* sinks, const float* alibi, void* out, int S, int qh, int kvh,
    int hd, int ps, int num_pages, int max_pages, float sm_scale, int window,
    float soft_cap, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 0) return 0;
#define ARGS q, kv, kv_lens, page_idx, sinks, alibi, out, S, qh, kvh, ps, \
             num_pages, max_pages, sm_scale, window, soft_cap, st
  if (dtype == ATTN_BF16 && hd == 64) return launch<__nv_bfloat16, 64>(ARGS);
  if (dtype == ATTN_BF16 && hd == 128) return launch<__nv_bfloat16, 128>(ARGS);
  if (dtype == ATTN_F32 && hd == 64) return launch<float, 64>(ARGS);
  if (dtype == ATTN_F32 && hd == 128) return launch<float, 128>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
