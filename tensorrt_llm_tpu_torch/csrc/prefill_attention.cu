// Causal ragged attention over the paged KV pool (prefill chunks and mixed
// prefill + decode batches).
//
// Replaces the TPU kernel ragged_prefill_attention
// (tensorrt_llm_tpu/ops/pallas/prefill_attention.py:250, body _kernel :37).
// Same function: query rows packed by cu_q_lens i32[S+1] into q [T, qh, hd];
// the i-th new token of sequence s sits at position kv_len - q_len + i and
// sees KV positions <= its own; pool, page table, sinks, sliding window,
// soft cap and ALiBi as in the decode kernel; out [T, qh, hd]. Rows past
// cu_q_lens[S] are left untouched. A q_len-1 segment is a decode row, so
// one launch serves a mixed batch. There is no cap on the segment length
// (the TPU kernel's 256-row max_q_len was a VMEM bound).
//
// Design (simple first version): one CTA per (query block, KV head,
// sequence). A query block is up to 64 score rows = QB tokens x `group`
// query heads of one KV head (QB = 64 / group). The TPU kernel walks
// sequences in order on one core and blends each segment's unaligned edge
// into rows the previous grid step wrote; CUDA blocks run in any order, so
// here every CTA owns disjoint output rows and writes only rows of its own
// segment. The CTA streams KV tiles of 32 positions up to the causal limit
// of its last row (and from the sliding-window start of its first row),
// scores 64 x 32 pairs per tile with float32 dot products from shared
// memory, runs the online softmax with one warp per row group and keeps
// its P.V accumulator in registers (4 threads per row).
//
// What bounds it on the H100 at long prefills: the attention FLOPs (4 *
// qh * hd per visible (query, key) pair), so the bound is FLOPs / the
// dense bf16 tensor-core peak. What this design leaves on the table: it
// runs on CUDA cores in float32 (no mma/wgmma), reloads K/V per query
// block instead of sharing tiles across blocks of one sequence, and has
// no cp.async/TMA pipelining.

#include "attention_common.cuh"

namespace {

constexpr int kTile = 32;      // KV positions per tile (one per lane)
constexpr int kRows = 64;      // score rows per CTA (tokens x heads)
constexpr int kThreads = 256;  // 8 warps; 4 threads per row in P.V
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;   // 8
constexpr int kPStride = kTile + 1;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ kv,
               const int* __restrict__ kv_lens,
               const int* __restrict__ page_idx,
               const int* __restrict__ cu_q_lens,
               const float* __restrict__ sinks,
               const float* __restrict__ alibi, T* __restrict__ out, int qh,
               int kvh, int ps, int num_pages, int max_pages, float sm_scale,
               int window, float soft_cap) {
  constexpr int V = Vec<T>::N;
  constexpr int kCols = HD / 4;   // accumulator columns per thread
  const int qblk = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int group = qh / kvh;
  const int qb = kRows / group;   // tokens per CTA
  const int rows = qb * group;    // <= kRows
  const int combined = 2 * kvh;

  const int q_start = cu_q_lens[s];
  const int q_len = cu_q_lens[s + 1] - q_start;
  const int tok0 = qblk * qb;
  if (tok0 >= q_len) return;
  const int kv_len = kv_lens[s];
  const int ctx = kv_len - q_len;                 // position of token 0
  const int tok_last = min(tok0 + qb, q_len) - 1;
  const int kv_end = min(kv_len, ctx + tok_last + 1);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                          // [kRows][HD]
  float* k_s = q_s + kRows * HD;              // [kTile][HD + 1]
  float* v_s = k_s + kTile * (HD + 1);        // [kTile][HD]
  float* p_s = v_s + kTile * HD;              // [kRows][kPStride]
  float* a_s = p_s + kRows * kPStride;        // [kRows] rescale factor
  float* l_s = a_s + kRows;                   // [kRows] final denominators

  // rows: r = token_local * group + g  ->  head h*group + g
  for (int i = tid * V; i < kRows * HD; i += kThreads * V) {
    const int r = i / HD;
    const int d = i % HD;
    const int tok = tok0 + r / group;
    if (r < rows && tok < q_len) {
      load_vec<T>(q + ((size_t)(q_start + tok) * qh + h * group + r % group) * HD + d,
                  q_s + i);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) q_s[i + j] = 0.f;
    }
  }

  // per-row online-softmax state, owned by the warp that scores the row
  float m_r[kRowsPerWarp], l_r[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp + j * kWarps;
    const bool sink = sinks != nullptr && r < rows;
    m_r[j] = sink ? sinks[h * group + r % group] : ATTN_MASK;
    l_r[j] = sink ? 1.f : 0.f;
  }
  // P.V accumulator: row tid/4, columns (tid%4) + 4*c
  const int acc_row = tid >> 2;
  const int acc_sub = tid & 3;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  int start = 0;
  if (window > 0) start = max(0, ctx + tok0 - window + 1);
  start = (start / kTile) * kTile;
  const int* pt = page_idx + (size_t)s * max_pages;

  for (int base = start; base < kv_end; base += kTile) {
    __syncthreads();  // q_s ready / previous tile's readers are done
    for (int i = tid * V; i < kTile * HD; i += kThreads * V) {
      const int t = i / HD;
      const int d = i % HD;
      const int pos = base + t;
      float kr[V], vr[V];
      if (pos < kv_end) {
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
    // scores for rows warp + 8j, key position base + lane
    const int pos = base + lane;
    float dot[kRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) dot[j] = 0.f;
    const float* kr = k_s + lane * (HD + 1);
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j)
        dot[j] += q_s[(warp + j * kWarps) * HD + d] * kd;
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + j * kWarps;
      const int tok = tok0 + r / group;
      const int q_pos = ctx + tok;
      const bool valid = r < rows && tok < q_len && pos < kv_end && pos <= q_pos &&
                         (window <= 0 || pos > q_pos - window);
      const float sc = attn_score(dot[j], sm_scale, alibi, h * group + r % group,
                                  pos, q_pos, soft_cap, valid);
      const float m_new = fmaxf(m_r[j], warp_max(sc));
      const float p = sc == -INFINITY ? 0.f : expf(sc - m_new);
      const float sum = warp_sum(p);
      const float alpha = expf(m_r[j] - m_new);
      l_r[j] = l_r[j] * alpha + sum;
      m_r[j] = m_new;
      p_s[r * kPStride + lane] = p;
      if (lane == 0) a_s[r] = alpha;
    }
    __syncthreads();
    const float alpha = a_s[acc_row];
    const float* pr = p_s + acc_row * kPStride;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      const float p = pr[t];
      const float* vr = v_s + t * HD + acc_sub;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] += p * vr[4 * c];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) l_s[warp + j * kWarps] = l_r[j];
  }
  __syncthreads();
  const int tok = tok0 + acc_row / group;
  if (acc_row < rows && tok < q_len) {
    const float inv = 1.f / fmaxf(l_s[acc_row], 1e-30f);
    T* o = out + ((size_t)(q_start + tok) * qh + h * group + acc_row % group) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[acc_sub + 4 * c] = from_f<T>(acc[c] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kv, const int* kv_lens,
                   const int* page_idx, const int* cu_q_lens, const float* sinks,
                   const float* alibi, void* out, int S, int qh, int kvh, int ps,
                   int num_pages, int max_pages, int max_q_len, float sm_scale,
                   int window, float soft_cap, cudaStream_t stream) {
  const int group = qh / kvh;
  const int qb = kRows / group;
  const size_t smem = sizeof(float) *
      (kRows * HD + kTile * (HD + 1) + kTile * HD + kRows * kPStride + 2 * kRows);
  auto kernel = prefill_kernel<T, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((max_q_len + qb - 1) / qb, kvh, S);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), kv_lens, page_idx,
      cu_q_lens, sinks, alibi, static_cast<T*>(out), qh, kvh, ps, num_pages,
      max_pages, sm_scale, window, soft_cap);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes. Returns a cudaError_t (0 = launched).
// dtype: 0 float32, 1 bfloat16. group = qh / kvh must be <= 64. max_q_len
// is the longest segment of this batch (host-known; it sizes the grid).
extern "C" int ragged_prefill_attention(
    const void* q, const void* kv, const int* kv_lens, const int* page_idx,
    const int* cu_q_lens, const float* sinks, const float* alibi, void* out,
    int S, int qh, int kvh, int hd, int ps, int num_pages, int max_pages,
    int max_q_len, float sm_scale, int window, float soft_cap, int dtype,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 0 || max_q_len <= 0) return 0;
  if (qh % kvh != 0 || qh / kvh > kRows) return (int)cudaErrorInvalidValue;
#define ARGS q, kv, kv_lens, page_idx, cu_q_lens, sinks, alibi, out, S, qh, kvh, \
             ps, num_pages, max_pages, max_q_len, sm_scale, window, soft_cap, st
  if (dtype == ATTN_BF16 && hd == 64) return launch<__nv_bfloat16, 64>(ARGS);
  if (dtype == ATTN_BF16 && hd == 128) return launch<__nv_bfloat16, 128>(ARGS);
  if (dtype == ATTN_F32 && hd == 64) return launch<float, 64>(ARGS);
  if (dtype == ATTN_F32 && hd == 128) return launch<float, 128>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
