// Causal ragged attention over the paged KV pool (prefill chunks and mixed
// prefill + decode batches).
//
// Replaces the TPU kernel ragged_prefill_attention
// (tensorrt_llm_tpu/ops/pallas/prefill_attention.py:250, body _kernel :37).
// Same function: query rows packed by cu_q_lens i32[S+1] into q [T, qh, hd];
// the i-th new token of sequence s sits at position kv_len - q_len + i and
// sees KV positions <= its own; pool [P, ps, 2*kvh, hd] with k of head h at
// combined index 2h and v at 2h+1; page table entries clamped to [0, P-1];
// sinks, sliding window, soft cap and ALiBi as in the decode kernel; out
// [T, qh, hd]. Rows past cu_q_lens[S] are left untouched; a row with no
// visible key is 0. A q_len-1 segment is a decode row, so one launch serves
// a mixed batch. There is no cap on the segment length (the TPU kernel's
// 256-row max_q_len was a VMEM bound).
//
// What bounds it on the H100: at the timed shapes the bytes (q, out and the
// KV read once; 11 us at 8 x 512 tokens) narrowly ahead of the attention
// FLOPs (4 * qh * hd per visible pair over the dense bf16 tensor-core
// peak; 9 us), so only a kernel that runs both products on the tensor
// cores and keeps them fed comes near either.
//
// Two routes, picked by the element type:
//
// bf16 -> prefill_wgmma_kernel (FlashAttention shape on Hopper's warpgroup
// MMA). A CTA is one warpgroup and owns 64 score rows of one (sequence, KV
// head): rows are tokens x `group` query heads, r -> (tok0 + r / group,
// r % group), so the K/V tile a CTA stages serves all the query heads that
// share it; a group above 64 (Falcon-7B's 71 over one KV head) is cut into
// equal chunks of at most 64 heads, one token per CTA (head_chunks). (128-row CTAs of two
// warpgroups halve the L2 traffic but ran 5-8 % slower at every shape
// from 16 x 128 to one 8,192-token prompt: a barrier shared by two
// warpgroups keeps them in step, so they want the tensor cores and the
// SFU at the same moments; four independent one-warpgroup CTAs per SM
// drift apart.) Q is copied once into shared memory as bf16. K and V tiles
// of 64 positions stay bf16 in shared memory, copied by 16-byte cp.async
// into a two-stage ring, a tile one commit group, so the next tile is in
// flight while one is used and there is one __syncthreads() per tile. A
// thread copies chunks of two rows of the tile (one page-table entry and
// one address per row, the entries fetched a tile ahead), and every tile
// is laid out as wgmma reads it: blocks of 64
// columns, rows of 128 bytes, the 16-byte chunk XORed with the row's low
// bits (the 128-byte swizzle), 1024-byte aligned. S = Q.K^T is
// wgmma m64n64k16 with both operands from shared memory (K is K-major as
// stored); the online softmax runs on the accumulator fragments in
// registers (row max by quad shuffles, the row sum kept per lane and
// reduced once at the end), in float32 and log2 units with the scale
// folded into the exponent's FMA and ex2.approx for the exponential,
// seeded with the sink logit or ATTN_MASK; P is rounded to bf16 in
// registers and is the register A operand of the second wgmma (m64n64k16
// or m64n128k16), which reads V transposed straight from its
// [position][dim] tile, so P never touches shared memory. Tiles are
// classified once per CTA: tiles before the first row's window start or
// past the last row's causal limit are never loaded, tiles wholly visible
// to every row skip the mask, only edge tiles test each element. The rescale
// of the output accumulator is skipped once the running maxima have
// settled. Query blocks are mapped last to first so the CTAs with the
// longest causal span start first.
//
// float32 -> prefill_f32_simple_kernel: the first version's CUDA-core
// kernel, kept because TF32 does not hold the 1e-4 that the float32 parity
// path is tested to. One CTA per 64 score rows, KV tiles of 32 positions
// widened to float32 in shared memory, synchronous loads.
//
// What is left (measured: the copies take a third of the time at long
// prompts and overlap the math only in part, and a warpgroup's tensor
// cores idle during its softmax): a producer warp with TMA instead of
// per-thread cp.async (one box per page covers k and v of a head); the
// next tile's S started before this tile's softmax, or warpgroups taking
// turns at softmax and products; a K/V tile shared between
// the query blocks of one sequence (each CTA re-reads its causal span
// through L2); a split of the KV range for q_len-1 rows of mixed batches
// (one CTA with 8 live rows of 64 walks the row's whole KV); for 8-bit
// pools, the dequant overlapped with the products (today one more
// barrier per tile).
//
// 8-bit pools (int8, e4m3; the TPU kernel's k_scale / v_scale dequant,
// ops/pallas/prefill_attention.py:145-147): wgmma reads both operands of
// Q.K^T and V of P.V from shared memory in bf16 (q is bf16, not e4m3:
// quantizing q would compute something else), so the bf16 route copies
// the 8-bit K and V tiles as they are into a ring of half-size stages (row
// major), and after the tile's barrier the warpgroup dequantizes the
// current stage into one bf16 K and V tile in the swizzled operand layout,
// as the reference does (bf16(x * scale), the product in float32:
// attention_common.cuh widen16), fences it for the async proxy and meets
// once more before the products. The scales are device pointers, so a
// CUDA graph reads the current per-layer value. The float32 route loads
// the 8-bit values and dequantizes them on the way into shared memory.
//
// hd 80 and 96 (StableLM-3B, GPT-NeoX-20B, Phi-3-mini) run the hd-128
// shapes on 128-wide tiles (attention_common.cuh tile_hd): Q, K and V
// chunks past hd are zero-filled on the way in, and only hd output
// columns are stored, so global memory is read and written at hd. hd 48
// runs the hd-64 shapes on 64-wide tiles in the same way.
//
// hd 256 (Gemma 2 and 3) keeps the one-warpgroup design: Q (32 KB) and a
// two-stage ring of 32 KB K and V tiles take 161 KB, so one CTA per SM
// (MINB 1, up to 255 registers a thread for the 128 output and 32 score
// accumulators), and P.V is two m64n128k16 products per k-step, one per
// half of V's four 64-column blocks, into the two halves of the output
// accumulator (wgmma's widest transposed-B shape this file has is n128;
// one n128 product alone would leave columns 128-255 unwritten).

#include "attention_common.cuh"
#include "wgmma.cuh"

namespace {

// ------------------------------------------------------------------------
// float32 route: CUDA cores, float32 math throughout.
// ------------------------------------------------------------------------
namespace simple {

constexpr int kTile = 32;      // KV positions per tile (one per lane)
constexpr int kRows = 64;      // score rows per CTA (tokens x heads)
constexpr int kThreads = 256;  // 8 warps; 4 threads per row in P.V
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;   // 8
constexpr int kPStride = kTile + 1;

template <typename T, typename KVT, int HD>
__global__ void __launch_bounds__(kThreads)
prefill_f32_simple_kernel(const T* __restrict__ q, const KVT* __restrict__ kv,
                          const int* __restrict__ kv_lens,
                          const int* __restrict__ page_idx,
                          const int* __restrict__ cu_q_lens,
                          const float* __restrict__ sinks,
                          const float* __restrict__ alibi, T* __restrict__ out,
                          int qh, int kvh, int ps, int num_pages, int max_pages,
                          float sm_scale, int window, float soft_cap,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale) {
  constexpr int V = Vec<T>::N;
  constexpr int VK = Vec<KVT>::N;    // pool elements per 16-byte load
  constexpr int kCols = HD / 4;   // accumulator columns per thread
  const int qblk = blockIdx.x;
  const int group = qh / kvh;
  const HeadChunks hc = head_chunks(group, kRows);
  const int h = blockIdx.y / hc.n;
  const int g0 = (blockIdx.y % hc.n) * hc.size;   // first query head of the chunk
  const int gs = hc.size;
  const int grows = min(gs, group - g0);          // its live heads
  const int s = blockIdx.z;
  const int qb = kRows / gs;      // tokens per CTA
  const int rows = qb * gs;       // <= kRows
  const int combined = 2 * kvh;
  // the query head of row r (a dead row past the chunk's heads reads its
  // last live head's sink and slope)
  auto head_of = [&](int r) { return h * group + g0 + min(r % gs, grows - 1); };

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

  // rows: r = token_local * gs + g  ->  head h*group + g0 + g
  for (int i = tid * V; i < kRows * HD; i += kThreads * V) {
    const int r = i / HD;
    const int d = i % HD;
    const int tok = tok0 + r / gs;
    if (r < rows && tok < q_len && r % gs < grows) {
      load_vec<T>(q + ((size_t)(q_start + tok) * qh + head_of(r)) * HD + d,
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
    m_r[j] = sink ? sinks[head_of(r)] : ATTN_MASK;
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
  // an 8-bit pool's scales (1 for a pool of q's type)
  const float ks = load_scale(k_scale);
  const float vs = load_scale(v_scale);

  for (int base = start; base < kv_end; base += kTile) {
    __syncthreads();  // q_s ready / previous tile's readers are done
    for (int i = tid * VK; i < kTile * HD; i += kThreads * VK) {
      const int t = i / HD;
      const int d = i % HD;
      const int pos = base + t;
      float kr[VK], vr[VK];
      if (pos < kv_end) {
        int page = pt[min(pos / ps, max_pages - 1)];
        page = min(max(page, 0), num_pages - 1);
        const KVT* row = kv + (((size_t)page * ps + pos % ps) * combined + 2 * h) * HD;
        load_vec<KVT>(row + d, kr);
        load_vec<KVT>(row + HD + d, vr);
      } else {
#pragma unroll
        for (int j = 0; j < VK; ++j) kr[j] = vr[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VK; ++j) {
        k_s[t * (HD + 1) + d + j] = kr[j] * ks;
        v_s[t * HD + d + j] = vr[j] * vs;
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
      const int tok = tok0 + r / gs;
      const int q_pos = ctx + tok;
      const bool valid = r < rows && tok < q_len && r % gs < grows && pos < kv_end &&
                         pos <= q_pos && (window <= 0 || pos > q_pos - window);
      const float sc = attn_score(dot[j], sm_scale, alibi, head_of(r), pos, q_pos,
                                  soft_cap, valid);
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
  const int tok = tok0 + acc_row / gs;
  if (acc_row < rows && tok < q_len && acc_row % gs < grows) {
    const float inv = 1.f / fmaxf(l_s[acc_row], 1e-30f);
    T* o = out + ((size_t)(q_start + tok) * qh + head_of(acc_row)) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[acc_sub + 4 * c] = from_f<T>(acc[c] * inv);
  }
}

template <int HD, typename KVT>
cudaError_t launch(const void* q, const void* kv, const int* kv_lens,
                   const int* page_idx, const int* cu_q_lens, const float* sinks,
                   const float* alibi, void* out, int S, int qh, int kvh, int ps,
                   int num_pages, int max_pages, int max_q_len, float sm_scale,
                   int window, float soft_cap, const float* k_scale,
                   const float* v_scale, cudaStream_t stream) {
  const HeadChunks hc = head_chunks(qh / kvh, kRows);
  const int qb = kRows / hc.size;
  const size_t smem = sizeof(float) *
      (kRows * HD + kTile * (HD + 1) + kTile * HD + kRows * kPStride + 2 * kRows);
  auto kernel = prefill_f32_simple_kernel<float, KVT, HD>;
  static SmemAllowed allowed = {};
  cudaError_t err = allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((max_q_len + qb - 1) / qb, kvh * hc.n, S);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KVT*>(kv), kv_lens, page_idx,
      cu_q_lens, sinks, alibi, static_cast<float*>(out), qh, kvh, ps, num_pages,
      max_pages, sm_scale, window, soft_cap, k_scale, v_scale);
  return cudaGetLastError();
}

}  // namespace simple

// ------------------------------------------------------------------------
// bf16 route: both products by wgmma.
// ------------------------------------------------------------------------
namespace wg {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;      // score rows per CTA: one warpgroup
constexpr int kThreads = 128;
constexpr int kTile = 64;      // KV positions per tile
constexpr int kNT = kTile / 8;    // 8-position blocks of a tile's scores
constexpr int kPK = kTile / 16;   // k-steps of P.V per tile

// STAGES: depth of the cp.async ring (STAGES - 1 tiles in flight while one
// is used); MINB: CTAs per SM the register budget is cut for. With an
// 8-bit pool (Q8) a ring stage holds K and V of a tile in RAW_BYTES each
// (half a bf16 tile), and one widened bf16 K and V tile follows the ring.
template <int HD, int KV> struct Shape {
  static constexpr bool Q8 = KV != KV_SAME;
  static constexpr int STAGES = 2;
  static constexpr int MINB = HD <= 64 ? 4 : (HD <= 128 ? 2 : 1);
  static constexpr int Q_BYTES = kRows * HD * sizeof(bf16);
  static constexpr int TILE_BYTES = kTile * HD * sizeof(bf16);   // K or V of a tile
  static constexpr int RAW_BYTES = Q8 ? kTile * HD : TILE_BYTES;  // ... in a stage
  // + 1024: the tiles are aligned to the swizzle pattern's 1024 bytes
  static constexpr size_t SMEM =
      Q_BYTES + 2 * STAGES * RAW_BYTES + (Q8 ? 2 * TILE_BYTES : 0) + 1024;
};

// Byte offset of the 16-byte chunk `c` of row `r` in a wgmma operand tile
// of ROWS rows (wgmma.cuh): blocks of 64 columns, each [ROWS][128 bytes]
// with the chunk index XORed with the row's low three bits.
template <int ROWS>
__device__ __forceinline__ int tile_off(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// PLAIN: no ALiBi, no soft cap, sm_scale > 0. The score transform is then
// one multiply, folded into the exponent's FMA. KV: the pool's element
// type (KV_SAME: bf16).
template <int HD, bool PLAIN, int KV>
__global__ void __launch_bounds__(kThreads, Shape<HD, KV>::MINB)
prefill_wgmma_kernel(const bf16* __restrict__ q, const void* __restrict__ kv_pool,
                     const int* __restrict__ kv_lens,
                     const int* __restrict__ page_idx,
                     const int* __restrict__ cu_q_lens,
                     const float* __restrict__ sinks,
                     const float* __restrict__ alibi, bf16* __restrict__ out, int qh,
                     int kvh, int ps, int num_pages, int max_pages, float sm_scale,
                     int window, float soft_cap, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale) {
  constexpr int HP = tile_hd(HD);   // the shared-memory tiles' width
  typedef Shape<HP, KV> SH;
  constexpr bool Q8 = SH::Q8;
  constexpr int kStages = SH::STAGES;
  constexpr int kTileBytes = SH::TILE_BYTES;
  constexpr int kRawBytes = SH::RAW_BYTES;
  constexpr int CH = HD / 8;     // 16-byte chunks per bf16 row
  constexpr int CHP = HP / 8;    // ... per tile row (CH .. CHP - 1: zeros)
  constexpr int CH8 = HD / 16;   // 16-byte chunks per 8-bit row
  constexpr int CH8P = HP / 16;  // ... per row of an 8-bit stage
  constexpr int KS = HP / 16;    // k-steps of Q.K^T
  constexpr int ON = HP / 8;     // 8-dim blocks of the output

  // heaviest first: the last query block has the longest causal span
  const int qblk = gridDim.x - 1 - blockIdx.x;
  const int group = qh / kvh;
  const HeadChunks hc = head_chunks(group, kRows);
  const int h = blockIdx.y / hc.n;
  const int g0 = (blockIdx.y % hc.n) * hc.size;   // first query head of the chunk
  const int gs = hc.size;
  const int grows = min(gs, group - g0);          // its live heads
  const int s = blockIdx.z;
  const int qb = kRows / gs;      // tokens per CTA
  const int combined = 2 * kvh;
  const int tid = threadIdx.x;

  // Copies of a tile: thread -> (rows ld_r and ld_r + 32 of the tile, chunks
  // ld_q + 4i of their K and V), so a thread needs one page-table entry and
  // one address per row, and four neighbouring lanes read 64 contiguous
  // bytes.
  constexpr int LR = 4 * kTile / kThreads;   // rows of a tile per thread
  constexpr int kRowStep = kThreads / 4;     // between a thread's rows
  const int ld_r = tid >> 2;
  const int ld_q = tid & 3;
  const int* pt = page_idx + (size_t)s * max_pages;
  const int ps_shift = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;   // pages of 2^n positions
  // The page-table entries of this thread's rows of the tile at `base`
  // (any base >= 0: entries past the sequence's pages are read but never
  // used). The loop fetches them one tile ahead of their use so that the
  // lookup's latency hides behind a tile's math instead of stalling every
  // warp right after the barrier.
  struct Pages { int p[LR]; };
  auto fetch_page = [&](int base) {
    Pages r;
#pragma unroll
    for (int k = 0; k < LR; ++k) {
      const int pos = base + ld_r + k * kRowStep;
      r.p[k] = pt[min(ps_shift >= 0 ? pos >> ps_shift : pos / ps, max_pages - 1)];
    }
    return r;
  };

  const int q_start = cu_q_lens[s];
  const int q_len = cu_q_lens[s + 1] - q_start;
  const int tok0 = qblk * qb;
  if (tok0 >= q_len) return;
  const int kv_len = kv_lens[s];
  const int ctx = kv_len - q_len;                 // position of token 0
  const int tok_last = min(tok0 + qb, q_len) - 1;
  const int ntok = tok_last - tok0 + 1;
  // row r = token_local * gs + head_local is live for a token of the
  // segment and a head of the chunk; its query head
  auto row_live = [&](int r) { return r / gs < ntok && r % gs < grows; };
  auto head_of = [&](int r) { return h * group + g0 + min(r % gs, grows - 1); };
  const int q_pos_first = ctx + tok0;
  const int q_pos_last = ctx + tok_last;
  const int kv_end = min(kv_len, q_pos_last + 1);

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;      // accumulator row within the warp's 16
  const int t = lane & 3;
  // an 8-bit pool's dequant multipliers (kv8_unit)
  const float k_unit = kv8_unit<KV>(load_scale(k_scale));
  const float v_unit = kv8_unit<KV>(load_scale(v_scale));

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;                          // [kRows][HP]
  unsigned char* kv_s = smem + SH::Q_BYTES;           // stages x [K | V]
  // Q8: the widened bf16 K and V tiles, after the ring
  unsigned char* wide_s = kv_s + kStages * 2 * kRawBytes;

  int start = 0;
  if (window > 0) start = max(0, q_pos_first - window + 1);
  start = (start / kTile) * kTile;
  const int n_tiles = kv_end > start ? (kv_end - start + kTile - 1) / kTile : 0;

  // chunk ld_q of the row's first 64-column block; chunk ld_q + 4 is 64
  // bytes away under the swizzle, later blocks a whole [kTile][128] further
  const int ld_off = ld_r * 128 + ((ld_q ^ (ld_r & 7)) << 4);
  const size_t row_elems = (size_t)combined * HD;
  const bf16* kv = static_cast<const bf16*>(kv_pool);
  const uint8_t* kv8 = static_cast<const uint8_t*>(kv_pool);
  const bf16* kv_head = kv + 2 * h * HD + ld_q * 8;
  const uint8_t* kv8_head = kv8 + 2 * h * HD + ld_q * 16;
  // Start the copies of the tile at `base` into ring stage `st`, K and V
  // as one commit group. Positions at or past kv_end are zero-filled (V
  // must be finite there: its weight is 0), and so are a tile row's chunks
  // past HD (chunk ld_q + 4i of a row is live below CH, or CH8).
  auto start_tile = [&](int base, int st, const Pages& pages) {
    unsigned char* k_dst = kv_s + st * 2 * kRawBytes;
    unsigned char* v_dst = k_dst + kRawBytes;
#pragma unroll
    for (int k = 0; k < LR; ++k) {
      const int pos = base + ld_r + k * kRowStep;
      const bool live = pos < kv_end;
      const int page = min(max(pages.p[k], 0), num_pages - 1);
      const int slot = page * ps + (ps_shift >= 0 ? pos & (ps - 1) : pos % ps);
      if constexpr (Q8) {
        // 8-bit rows as they are, row major: [kTile][HP bytes]; this
        // thread's chunks ld_q + 4i of its rows
        const uint8_t* src = live ? kv8_head + slot * row_elems : kv8;
        const int row_off = (ld_r + k * kRowStep) * HP + ld_q * 16;
#pragma unroll
        for (int i = 0; i < CH8P / 4; ++i) {
          const bool on = live && ld_q + 4 * i < CH8;
          cp_async_16(k_dst + row_off + 64 * i, src + (on ? 64 * i : 0), on);
          cp_async_16(v_dst + row_off + 64 * i, src + (on ? HD + 64 * i : 0), on);
        }
      } else {
        const bf16* src = live ? kv_head + slot * row_elems : kv;
#pragma unroll
        for (int i = 0; i < CHP / 4; ++i) {
          // the row k * kRowStep further has the same low bits: same swizzle
          const int off = (i >> 1) * (kTile * 128) + (ld_off ^ ((i & 1) << 6)) +
                          k * kRowStep * 128;
          const bool on = live && ld_q + 4 * i < CH;
          cp_async_16(k_dst + off, src + (on ? 32 * i : 0), on);
          cp_async_16(v_dst + off, src + (on ? HD + 32 * i : 0), on);
        }
      }
    }
    cp_async_commit();
  };

  // Q: rows r = token_local * group + head_local, dead rows zero-filled;
  // its copies ride in the first tile's group.
  for (int i = tid; i < kRows * CHP; i += kThreads) {
    const int r = i / CHP;
    const int c = i % CHP;
    const bool live = row_live(r) && c < CH;
    const bf16* src = q;
    if (live)
      src = q + ((size_t)(q_start + tok0 + r / gs) * qh + head_of(r)) * HD + c * 8;
    cp_async_16(q_s + tile_off<kRows>(r, c), src, live);
  }
  // Prologue: the first kStages - 1 tiles, then the pages of the tile the
  // loop's first iteration will start.
  static_assert(kRowStep % 8 == 0, "a thread's rows must share their swizzle");
  Pages page_r = {};
  {
    Pages pre[kStages - 1];
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) pre[st] = fetch_page(start + st * kTile);
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_tiles) start_tile(start + st * kTile, st, pre[st]); else cp_async_commit();
    }
    if (kStages - 1 < n_tiles) page_r = fetch_page(start + (kStages - 1) * kTile);
  }

  // This thread's two rows: row0 + g and row0 + g + 8.
  const int row0 = warp * 16;
  int q_pos_r[2];
  float slope_r[2], m_r[2], l_r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row0 + g + 8 * e;
    const int head = head_of(r);
    q_pos_r[e] = ctx + tok0 + r / gs;
    slope_r[e] = alibi != nullptr ? alibi[head] : 0.f;
    const bool sink = sinks != nullptr;
    m_r[e] = sink ? sinks[head] * ATTN_LOG2E : ATTN_MASK;
    l_r[e] = (sink && t == 0) ? 1.f : 0.f;   // per-lane partial sums: seed one lane
  }
  // scores enter the softmax as s * sl2 in log2 units: raw dots times the
  // folded scale when PLAIN, else already transformed in place
  const float sl2 = PLAIN ? sm_scale * ATTN_LOG2E : 1.f;

  float oacc[4 * ON];
#pragma unroll
  for (int i = 0; i < 4 * ON; ++i) oacc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int base = start + j * kTile;
    const unsigned char* k_s = kv_s + (j % kStages) * 2 * kRawBytes;
    cp_async_wait<kStages - 2>();   // tile j (and Q) of this thread have landed
    fence_proxy_async();            // ... where wgmma will see them
    __syncthreads();                // everyone's have; tile j-1 has been read by all
    const int nxt = j + kStages - 1;   // goes where tile j-1 was
    if (nxt < n_tiles) {
      start_tile(start + nxt * kTile, nxt % kStages, page_r);
      if (nxt + 1 < n_tiles) page_r = fetch_page(start + (nxt + 1) * kTile);
    } else {
      cp_async_commit();
    }
    if constexpr (Q8) {
      // dequantize the 8-bit stage into the bf16 operand tiles: chunk c of
      // an 8-bit row is bf16 chunks 2c and 2c + 1 of the swizzled layout;
      // then make the stores visible to wgmma and meet (the last wgmma to
      // read the tiles finished before the barrier above)
#pragma unroll 4
      for (int idx = tid; idx < 2 * kTile * CH8P; idx += kThreads) {
        const int is_v = idx / (kTile * CH8P);
        const int r = (idx / CH8P) % kTile;
        const int c = idx % CH8P;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(k_s + is_v * kRawBytes + r * HP + c * 16);
        uint4 lo16, hi16;
        widen16<KV>(raw, is_v ? v_unit : k_unit, lo16, hi16);
        unsigned char* dst = wide_s + is_v * kTileBytes;
        *reinterpret_cast<uint4*>(dst + tile_off<kTile>(r, 2 * c)) = lo16;
        *reinterpret_cast<uint4*>(dst + tile_off<kTile>(r, 2 * c + 1)) = hi16;
      }
      fence_proxy_async();
      __syncthreads();
      k_s = wide_s;
    }
    const unsigned char* v_s = k_s + kTileBytes;

    // S = Q.K^T: the CTA's 64 rows x 64 positions
    float sacc[4 * kNT];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // columns 16*ks .. of the 64-column block ks / 4
      const uint64_t da = wgmma_desc(
          q_s + (ks >> 2) * (kRows * 128) + (ks & 3) * 32, 16, 1024);
      const uint64_t db = wgmma_desc(
          k_s + (ks >> 2) * (kTile * 128) + (ks & 3) * 32, 16, 1024);
      wgmma_m64n64k16_ss(sacc, da, db, ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();

    if constexpr (!PLAIN) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[4 * n + e] = attn_score_log2(
              sacc[4 * n + e], sm_scale, slope_r[e >> 1],
              base + n * 8 + 2 * t + (e & 1), q_pos_r[e >> 1], soft_cap);
    }
    // wholly visible to every row of the CTA: below the first row's
    // diagonal and inside the last row's window; else test each element
    const bool full = base + kTile - 1 <= q_pos_first &&
                      (window <= 0 || base > q_pos_last - window);
    if (!full) {
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = base + n * 8 + 2 * t + (e & 1);
          const int q_pos = q_pos_r[e >> 1];
          const bool valid = pos <= q_pos && pos < kv_end &&
                             (window <= 0 || pos > q_pos - window);
          sacc[4 * n + e] = valid ? sacc[4 * n + e] : -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sacc[4 * n + e]);
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float m_new = fmaxf(m_r[rr], quad_max(mx[rr]) * sl2);   // finite
      alpha[rr] = fast_exp2(m_r[rr] - m_new);
      m_r[rr] = m_new;
      l_r[rr] *= alpha[rr];
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // 0 for a masked (-inf) score
        const float p = fast_exp2(fmaf(sacc[4 * n + e], sl2, -m_r[e >> 1]));
        sacc[4 * n + e] = p;
        l_r[e >> 1] += p;
      }
    }
    // once the running maxima have settled every alpha is 1: skip the pass
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < ON; ++n) {
        oacc[4 * n + 0] *= alpha[0];
        oacc[4 * n + 1] *= alpha[0];
        oacc[4 * n + 2] *= alpha[1];
        oacc[4 * n + 3] *= alpha[1];
      }
    }
    // P rounded to bf16 in registers: the A operand of P.V
    uint32_t pa[kPK][4];
#pragma unroll
    for (int kk = 0; kk < kPK; ++kk) {
      pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }
    // O += P.V: V is [position][dim], read transposed; positions 16*kk ..
    // are two groups of 8 rows, 1024 bytes apart; dims past 64 are the
    // next block, a tile's 64 x 128 bytes further
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPK; ++kk) {
      const uint64_t db = wgmma_desc(v_s + kk * 16 * 128, kTile * 128, 1024);
      if constexpr (HP == 64) {
        wgmma_m64n64k16_rs_tb(oacc, pa[kk], db);
      } else if constexpr (HP == 128) {
        wgmma_m64n128k16_rs_tb(oacc, pa[kk], db);
      } else {
        // dims 0-127, then 128-255: V's blocks 2 and 3, two blocks on
        static_assert(HP == 256, "P.V covers tiles 64, 128 and 256 wide");
        wgmma_m64n128k16_rs_tb(*reinterpret_cast<float(*)[64]>(oacc), pa[kk], db);
        wgmma_m64n128k16_rs_tb(
            *reinterpret_cast<float(*)[64]>(oacc + 64), pa[kk],
            wgmma_desc(v_s + 2 * kTile * 128 + kk * 16 * 128, kTile * 128, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + g + 8 * rr;
    const float l = quad_sum(l_r[rr]);
    if (!row_live(r)) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* o = out + ((size_t)(q_start + tok0 + r / gs) * qh + head_of(r)) * HD;
#pragma unroll
    for (int n = 0; n < CH; ++n) {   // the output's HD columns
      *reinterpret_cast<__nv_bfloat162*>(o + n * 8 + 2 * t) = __floats2bfloat162_rn(
          oacc[4 * n + 2 * rr] * inv, oacc[4 * n + 2 * rr + 1] * inv);
    }
  }
}

template <int HD, bool PLAIN, int KV>
cudaError_t launch_as(const void* q, const void* kv, const int* kv_lens,
                      const int* page_idx, const int* cu_q_lens, const float* sinks,
                      const float* alibi, void* out, int S, int qh, int kvh, int ps,
                      int num_pages, int max_pages, int max_q_len, float sm_scale,
                      int window, float soft_cap, const float* k_scale,
                      const float* v_scale, cudaStream_t stream) {
  const HeadChunks hc = head_chunks(qh / kvh, kRows);
  const int qb = kRows / hc.size;
  constexpr size_t smem = Shape<tile_hd(HD), KV>::SMEM;
  auto kernel = prefill_wgmma_kernel<HD, PLAIN, KV>;
  static SmemAllowed allowed = {};
  cudaError_t err = allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((max_q_len + qb - 1) / qb, kvh * hc.n, S);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), kv, kv_lens, page_idx, cu_q_lens, sinks, alibi,
      static_cast<bf16*>(out), qh, kvh, ps, num_pages, max_pages, sm_scale, window,
      soft_cap, k_scale, v_scale);
  return cudaGetLastError();
}

template <int HD, int KV>
cudaError_t launch(const void* q, const void* kv, const int* kv_lens,
                   const int* page_idx, const int* cu_q_lens, const float* sinks,
                   const float* alibi, void* out, int S, int qh, int kvh, int ps,
                   int num_pages, int max_pages, int max_q_len, float sm_scale,
                   int window, float soft_cap, const float* k_scale,
                   const float* v_scale, cudaStream_t stream) {
  const bool plain = alibi == nullptr && soft_cap <= 0.f && sm_scale > 0.f;
  auto fn = plain ? launch_as<HD, true, KV> : launch_as<HD, false, KV>;
  return fn(q, kv, kv_lens, page_idx, cu_q_lens, sinks, alibi, out, S, qh, kvh, ps,
            num_pages, max_pages, max_q_len, sm_scale, window, soft_cap, k_scale,
            v_scale, stream);
}

}  // namespace wg


}  // namespace

// C entry point bound with ctypes. Returns a cudaError_t (0 = launched).
// dtype: 0 float32 (the CUDA-core route), 1 bfloat16 (the tensor-core
// route). kv_dtype: the pool's element type, 0 q's own, 1 int8, 2 float8
// e4m3 (AttnKv); k_scale and v_scale are float32 device scalars that
// dequantize an 8-bit pool (null: 1). Head dims 48, 64, 80, 96, 128 and 256.
// max_q_len is the longest segment of this batch (host-known; it sizes the
// grid).
extern "C" int ragged_prefill_attention(
    const void* q, const void* kv, const int* kv_lens, const int* page_idx,
    const int* cu_q_lens, const float* sinks, const float* alibi, void* out,
    int S, int qh, int kvh, int hd, int ps, int num_pages, int max_pages,
    int max_q_len, float sm_scale, int window, float soft_cap, int dtype,
    int kv_dtype, const float* k_scale, const float* v_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 0 || max_q_len <= 0) return 0;
  if (qh % kvh != 0) return (int)cudaErrorInvalidValue;
#define ARGS q, kv, kv_lens, page_idx, cu_q_lens, sinks, alibi, out, S, qh, kvh, \
             ps, num_pages, max_pages, max_q_len, sm_scale, window, soft_cap, \
             k_scale, v_scale, st
#define BY_KV(HD)                                                                   \
  if (hd == HD) {                                                                   \
    if (dtype == ATTN_BF16 && kv_dtype == KV_SAME) return wg::launch<HD, KV_SAME>(ARGS); \
    if (dtype == ATTN_BF16 && kv_dtype == KV_INT8) return wg::launch<HD, KV_INT8>(ARGS); \
    if (dtype == ATTN_BF16 && kv_dtype == KV_E4M3) return wg::launch<HD, KV_E4M3>(ARGS); \
    if (dtype == ATTN_F32 && kv_dtype == KV_SAME) return simple::launch<HD, float>(ARGS); \
    if (dtype == ATTN_F32 && kv_dtype == KV_INT8) return simple::launch<HD, int8_t>(ARGS); \
    if (dtype == ATTN_F32 && kv_dtype == KV_E4M3)                                   \
      return simple::launch<HD, __nv_fp8_e4m3>(ARGS);                               \
  }
  BY_KV(48)
  BY_KV(64)
  BY_KV(80)
  BY_KV(96)
  BY_KV(128)
  BY_KV(256)
#undef BY_KV
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
