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
// What bounds it on the H100: the KV bytes it must read (each K and V row
// once) over 3.35 TB/s. Reaching that needs (a) enough bytes in flight on
// every SM whatever the batch, and (b) arithmetic that keeps up: at group 8
// and hd 64 one KV position of a head costs 1,024 FMAs for 256 bytes,
// about 27 TFLOP/s at the memory rate, which one CUDA-core thread per
// (head, position) cannot deliver next to its shared-memory reads.
//
// Design, for both routes: the KV axis is split across CTAs
// (flash-decoding). Grid (S, KV head x chunks of 16 query heads, splits);
// the number of splits comes from the host (ops/cuda/decode_attention.py
// choose_splits: a pure function of host ints, so the grid is fixed under
// a CUDA graph). split_range() cuts a row's visible range, from its
// sliding-window start to kv_len, into `splits` runs of whole tiles, so
// rows of different lengths and windowed rows still spread their work. With
// splits == 1 a CTA writes the output itself. Otherwise it writes an
// unnormalised partial (running max m, sum l, accumulator; float32) to
// scratch that the wrapper allocated, and decode_merge_kernel combines
// them: weight exp(m_i - max m), so a split that saw no key (m =
// ATTN_MASK, l = 0) weighs exactly 0 and a row with no key at all is 0.
// The sink logit enters once, in split 0.
//
// bf16 -> decode_tc_kernel. Four warps, and each warp owns its own tiles
// of the CTA's range (tile w, w + 4, ...), its own online-softmax state in
// registers and its own three-stage ring in shared memory: a tile of 32
// positions at hd 64 (16 at hd 128) is 8 KB of K and V, copied as bf16 by
// 16-byte cp.async (one page-table read per tile, spread by shuffles), two
// tiles in flight while one is scored, waited for with cp.async.wait_group
// + __syncwarp(). There is no __syncthreads() in the loop; the warps meet
// once, at the end, through shared memory. The up to 16 query heads of the
// KV head are one mma A tile (rows past the group are zero): S = Q.K^T and
// P.V run as mma.sync m16n8k16 on bf16 with float32 accumulation, K
// fragments by ldmatrix and V fragments by ldmatrix.trans from
// XOR-swizzled rows; Q fragments are loaded once from global memory; the
// softmax runs on the accumulator fragments in log2 units. Tiles wholly
// inside [window start, kv_len) skip the mask. Positions past kv_len are
// zero-filled on the way in (their weight is 0, so V must be finite).
// Tensor cores rather than a CUDA-core loop with q in registers: a
// CUDA-core loop needs group x hd FMAs per position per KV head (27
// TFLOP/s at the memory rate, above), 40 % of the card's float32 peak
// before any conversion from bf16; the mma route spends a quarter of the
// tensor pipe at group 8 even with half of the 16 rows padding.
//
// float32 -> decode_f32_simple_kernel: the first version's CUDA-core
// kernel (tiles of 32 positions widened to float32 in shared memory,
// synchronous loads, one CTA-wide barrier per phase), kept for the float32
// parity path, which is tested to 1e-4 (TF32 would not hold it). It takes
// the same splits and writes the same partials, in natural-log units.
//
// hd 256 (Gemma 2 and 3): a stage of 8 KB would hold 8 positions, too few
// for one k-step of P.V, so the stage grows to 16 KB (16 positions, as at
// hd 128): three stages x four warps are 192 KB, one CTA per SM. Q then
// waits in shared memory (16 rows x 512 bytes, swizzled) and each k-step
// reads its A fragment by ldmatrix: held in registers for the whole loop
// it would take 64 of them beside the 128 of the output accumulator.
//
// hd 80 and 96 (StableLM-3B, GPT-NeoX-20B, Phi-3-mini): the tiles are
// 128 wide (attention_common.cuh tile_hd), as at hd 128; the copies read
// the pool's hd columns of each row and zero-fill the rest, Q's fragments
// are zero past hd, and only hd output columns are written. Groups above
// 16 query heads (Falcon-7B's 71 over one KV head) are more chunks of the
// grid's second axis, so the group has no upper limit. hd 48 rides the
// hd-64 shapes the same way: 64-wide tiles, 32 positions a stage, Q's
// fragments and the copies' chunks zero past 48.
//
// 8-bit pools (int8, e4m3; the TPU kernel's k_scale / v_scale dequant,
// ops/pallas/decode_attention.py:109-111): a quantized pool halves the
// bytes the kernel must read, so the bf16 route copies the 8-bit tiles as
// they are into a ring of half-size stages (the same positions per tile,
// one stage deeper), and each warp dequantizes its current tile into one
// bf16 tile of its own in shared memory, in the swizzled layout the
// unchanged ldmatrix / mma code reads. The dequant is the reference's,
// bf16(x * scale) with the product in float32 (the K and V operands are
// the plain version's bits), without a conversion instruction but the
// final rounding (attention_common.cuh kv8_at). The per-layer scales are
// device pointers, so a graph replay reads the current value. The float32
// route loads the 8-bit values and dequantizes them to float32 on the way
// into shared memory.
//
// What is left: TMA instead of per-thread cp.async; a persistent grid that
// balances ragged batches better than equal splits per row; one launch
// instead of two when splits > 1 (last-arriving CTA merges); for 8-bit
// pools, mma fragments built straight from the 8-bit stage (no widened
// tile) and twice the positions per stage.

#include "attention_common.cuh"

namespace {

// Where split `split` of (row, head) keeps its partial. acc: [.., HD]
// floats; ml: [.., 2] floats (m, l).
__device__ __forceinline__ size_t part_index(int s, int head, int qh, int splits,
                                             int split) {
  return ((size_t)s * qh + head) * splits + split;
}

// ------------------------------------------------------------------------
// float32 route: CUDA cores, float32 math throughout.
// ------------------------------------------------------------------------
namespace simple {

constexpr int kTile = 32;      // KV positions per tile (one per lane)
constexpr int kThreads = 128;

template <typename T, typename KVT, int HD>
__global__ void __launch_bounds__(kThreads)
decode_f32_simple_kernel(const T* __restrict__ q, const KVT* __restrict__ kv,
                         const int* __restrict__ kv_lens,
                         const int* __restrict__ page_idx,
                         const float* __restrict__ sinks,
                         const float* __restrict__ alibi, T* __restrict__ out,
                         float* __restrict__ part_acc, float* __restrict__ part_ml,
                         int qh, int kvh, int ps, int num_pages, int max_pages,
                         float sm_scale, int window, float soft_cap, int splits,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale) {
  constexpr int V = Vec<T>::N;
  constexpr int VK = Vec<KVT>::N;    // pool elements per 16-byte load
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
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
  const bool sink = sinks != nullptr && split == 0;   // counted once
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = sink ? sinks[h * group + g] : ATTN_MASK;
    l_s[g] = sink ? 1.f : 0.f;
  }

  int lo, hi;
  split_range(kv_len, window, kTile, splits, split, &lo, &hi);
  const int* pt = page_idx + (size_t)s * max_pages;
  // an 8-bit pool's scales (1 for a pool of q's type)
  const float ks = load_scale(k_scale);
  const float vs = load_scale(v_scale);

  for (int base = lo; base < hi; base += kTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid * VK; i < kTile * HD; i += kThreads * VK) {
      const int t = i / HD;
      const int d = i % HD;
      const int pos = base + t;
      float kr[VK], vr[VK];
      if (pos < hi) {
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
    for (int i = tid; i < group * kTile; i += kThreads) {
      const int g = i / kTile;
      const int t = i % kTile;
      const int pos = base + t;
      const float* qr = q_s + g * HD;
      const float* kr = k_s + t * (HD + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += qr[d] * kr[d];
      const bool valid = pos < hi && (window <= 0 || pos > q_pos - window);
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
  if (splits == 1) {
    T* o_row = out + ((size_t)s * qh + (size_t)h * group) * HD;
    for (int i = tid; i < group * HD; i += kThreads)
      o_row[i] = from_f<T>(acc[i] / fmaxf(l_s[i / HD], 1e-30f));
    return;
  }
  for (int i = tid; i < group * HD; i += kThreads) {
    const size_t p = part_index(s, h * group + i / HD, qh, splits, split);
    part_acc[p * HD + i % HD] = acc[i];
    if (i % HD == 0) {
      part_ml[2 * p] = m_s[i / HD];
      part_ml[2 * p + 1] = l_s[i / HD];
    }
  }
}

}  // namespace simple

// ------------------------------------------------------------------------
// bf16 route: split KV, per-warp cp.async rings, tensor-core products.
// ------------------------------------------------------------------------
namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;

// A warp's region: a ring of STAGES stages of K and V per tile, N
// positions per tile (32 at hd 64, 16 at hd 128 and 256), STAGE bytes of
// them in bf16 (8 KB, 16 KB at hd 256). With an 8-bit pool (Q8) a stage
// holds the same positions in RAW = STAGE / 2 bytes, the ring is one
// stage deeper (more of the smaller stages in flight; two CTAs per SM
// still fit at hd 64 and 128), and the region ends in one bf16 tile
// (STAGE bytes) that the warp dequantizes its current stage into. QSMEM:
// Q waits in shared memory behind the regions instead of in registers.
template <int HD, int KV> struct Ring {
  static constexpr bool Q8 = KV != KV_SAME;
  static constexpr int STAGES = Q8 ? kStages + 1 : kStages;
  static constexpr int STAGE = HD <= 128 ? 8192 : 16384;
  static constexpr int RAW = Q8 ? STAGE / 2 : STAGE;
  static constexpr int BYTES = STAGES * RAW + (Q8 ? STAGE : 0);
  static constexpr int N = STAGE / (4 * HD);
  static constexpr bool QSMEM = HD > 128;
  static constexpr size_t SMEM = (size_t)kWarps * BYTES + (QSMEM ? 16 * HD * 2 : 0);
};

// PLAIN: no ALiBi, no soft cap, sm_scale > 0. The score transform is then
// one multiply, folded into the exponent's FMA. KV: the pool's element
// type (KV_SAME: bf16).
template <int HD, bool PLAIN, int KV>
__global__ void __launch_bounds__(kThreads)
decode_tc_kernel(const bf16* __restrict__ q, const void* __restrict__ kv_pool,
                 const int* __restrict__ kv_lens, const int* __restrict__ page_idx,
                 const float* __restrict__ sinks, const float* __restrict__ alibi,
                 bf16* __restrict__ out, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int qh, int kvh, int gchunks, int ps,
                 int num_pages, int max_pages, float sm_scale, int window,
                 float soft_cap, int splits, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale) {
  constexpr int HP = tile_hd(HD);       // the shared-memory tiles' width
  typedef Ring<HP, KV> R;
  constexpr bool Q8 = R::Q8;
  constexpr int kStages = R::STAGES;    // the ring's depth
  constexpr int TP = R::N;              // 32 or 16 positions
  constexpr int kStageBytes = R::RAW;   // one ring stage
  constexpr int kRingBytes = R::BYTES;  // a warp's region
  constexpr int CH = HD / 8;            // 16-byte chunks per bf16 K (or V) row
  constexpr int CHP = HP / 8;           // ... per row of a tile (CH .. CHP - 1: zeros)
  constexpr int CH8 = HD / 16;          // 16-byte chunks per 8-bit row
  constexpr int CH8P = HP / 16;         // ... per row of an 8-bit stage
  constexpr int COPIES8 = TP * 2 * CH8P / 32;   // 8-bit chunks per lane per tile
  constexpr int KS = HP / 16;           // k-steps of Q.K^T
  constexpr int NT = TP / 8;            // score n-tiles per tile
  constexpr int PK = TP / 16;           // k-steps of P.V
  constexpr int ON = HP / 8;            // output n-tiles
  constexpr int COPIES = TP * 2 * CHP / 32;   // 16-byte copies per lane per tile
  constexpr int OS = HP + 8;            // floats per row of a warp's final stash
  static_assert(16 * OS * 4 + 2 * 16 * 4 <= kRingBytes, "stash must fit the ring");

  const int s = blockIdx.x;
  const int h = blockIdx.y / gchunks;
  const int g0 = (blockIdx.y % gchunks) * 16;   // first query head of this chunk
  const int split = blockIdx.z;
  const int group = qh / kvh;
  const int grows = min(16, group - g0);        // live rows of the A tile
  const int combined = 2 * kvh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* kv = static_cast<const bf16*>(kv_pool);
  const uint8_t* kv8 = static_cast<const uint8_t*>(kv_pool);
  // an 8-bit pool's dequant multipliers (kv8_unit)
  const float k_unit = kv8_unit<KV>(load_scale(k_scale));
  const float v_unit = kv8_unit<KV>(load_scale(v_scale));

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + warp * kRingBytes;
  unsigned char* wide = ring + kStages * kStageBytes;   // Q8: the widened tile

  const int kv_len = kv_lens[s];
  const int q_pos = kv_len - 1;
  int lo, hi;
  split_range(kv_len, window, TP, splits, split, &lo, &hi);
  // this warp's tiles: lo + (warp + kWarps * i) * TP
  const int tiles = hi > lo ? (hi - lo + TP - 1) / TP : 0;
  const int n_my = tiles > warp ? (tiles - warp + kWarps - 1) / kWarps : 0;
  const int* pt = page_idx + (size_t)s * max_pages;

  // Start the copies of this warp's i-th tile into ring stage `st`.
  auto start_tile = [&](int i, int st) {
    const int base = lo + (warp + kWarps * i) * TP;
    int slot = 0;   // pool row (page * ps + offset) of position base + lane
    if (lane < TP) {
      const int pos = min(base + lane, hi - 1);
      int page = pt[min(pos / ps, max_pages - 1)];
      page = min(max(page, 0), num_pages - 1);
      slot = page * ps + pos % ps;
    }
    unsigned char* k_dst = ring + st * kStageBytes;
    if constexpr (Q8) {
      // 8-bit rows as they are: [TP][HP bytes] of K, then of V (chunks
      // past HD zero-filled)
      unsigned char* v_dst = k_dst + TP * HP;
#pragma unroll
      for (int j = 0; j < COPIES8; ++j) {
        const int p = (j * 32 + lane) / (2 * CH8P);
        const int c2 = (j * 32 + lane) % (2 * CH8P);   // chunk of the tile row's [k | v]
        const int c = c2 % CH8P;
        const bool col = c < CH8;
        const int row_slot = __shfl_sync(0xffffffffu, slot, p);
        const uint8_t* src = kv8 + ((size_t)row_slot * combined + 2 * h) * HD +
                             (col ? (c2 >= CH8P) * HD + c * 16 : 0);
        unsigned char* dst = (c2 < CH8P ? k_dst : v_dst) + p * HP + c * 16;
        cp_async_16(dst, src, col && base + p < hi);
      }
    } else {
      unsigned char* v_dst = k_dst + TP * HP * 2;
#pragma unroll
      for (int j = 0; j < COPIES; ++j) {
        const int p = (j * 32 + lane) / (2 * CHP);
        const int c2 = (j * 32 + lane) % (2 * CHP);   // chunk of the tile row's [k | v]
        const int c = c2 % CHP;
        const bool col = c < CH;
        const int row_slot = __shfl_sync(0xffffffffu, slot, p);
        const bf16* src = kv + ((size_t)row_slot * combined + 2 * h) * HD +
                          (col ? (c2 >= CHP) * HD + c * 8 : 0);
        unsigned char* dst = (c2 < CHP ? k_dst : v_dst) + swz<HP>(p, c);
        cp_async_16(dst, src, col && base + p < hi);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_my) start_tile(st, st); else cp_async_commit();
  }

  // Q as A fragments: rows g and g + 8 of the chunk's query heads, zero
  // past the group; straight from global memory into registers, or with
  // QSMEM into shared memory (16 rows, swizzled like the K tiles), from
  // where each k-step loads its fragment.
  const bf16* q_row = q + ((size_t)s * qh + h * group + g0) * HD;
  constexpr int QF = R::QSMEM ? 1 : KS;
  uint32_t qf[QF][4];
  unsigned char* q_s = smem + kWarps * kRingBytes;
  if constexpr (R::QSMEM) {
    static_assert(HP == HD, "Q waits in shared memory only at a tile's own width");
    for (int i = tid; i < 16 * CH; i += kThreads) {
      const int r = i / CH;
      const int c = i % CH;
      const uint4 v = r < grows
          ? *reinterpret_cast<const uint4*>(q_row + (size_t)r * HD + c * 8)
          : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(q_s + swz<HP>(r, c)) = v;
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e & 1);
        const int d = ks * 16 + 2 * t + 8 * (e >> 1);   // 0 past HD
        qf[ks][e] = r < grows && d < HD
            ? *reinterpret_cast<const uint32_t*>(q_row + (size_t)r * HD + d) : 0u;
      }
    }
  }

  float slope_r[2], m_r[2], l_r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = g + 8 * e;
    slope_r[e] = (alibi != nullptr && r < grows) ? alibi[h * group + g0 + r] : 0.f;
    m_r[e] = ATTN_MASK;
    l_r[e] = 0.f;
  }
  // scores enter the softmax as s * sl2 in log2 units: raw dots times the
  // folded scale when PLAIN, else already transformed in place
  const float sl2 = PLAIN ? sm_scale * ATTN_LOG2E : 1.f;
  const int win_lo = window > 0 ? max(0, kv_len - window) : 0;   // first visible

  float oacc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  for (int i = 0; i < n_my; ++i) {
    const int base = lo + (warp + kWarps * i) * TP;
    const unsigned char* k_s = ring + (i % kStages) * kStageBytes;
    cp_async_wait<kStages - 2>();   // this lane's copies of tile i have landed
    __syncwarp();                   // every lane's have; tile i-1 has been read
    const int nxt = i + kStages - 1;
    if (nxt < n_my) start_tile(nxt, nxt % kStages); else cp_async_commit();
    if constexpr (Q8) {
      // dequantize the 8-bit stage into the warp's bf16 tile, in the
      // swizzled layout of a bf16 stage: chunk c of an 8-bit row is bf16
      // chunks 2c and 2c + 1
#pragma unroll
      for (int j = 0; j < COPIES8; ++j) {
        const int p = (j * 32 + lane) / (2 * CH8P);
        const int c2 = (j * 32 + lane) % (2 * CH8P);
        const int c = c2 % CH8P;
        const int is_v = c2 >= CH8P;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(k_s + is_v * TP * HP + p * HP + c * 16);
        uint4 lo16, hi16;
        widen16<KV>(raw, is_v ? v_unit : k_unit, lo16, hi16);
        unsigned char* dst = wide + is_v * TP * HP * 2;
        *reinterpret_cast<uint4*>(dst + swz<HP>(p, 2 * c)) = lo16;
        *reinterpret_cast<uint4*>(dst + swz<HP>(p, 2 * c + 1)) = hi16;
      }
      __syncwarp();
      k_s = wide;
    }
    const unsigned char* v_s = k_s + TP * HP * 2;

    float sacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if constexpr (R::QSMEM) {
        // blocks: (rows 0..7 | 8..15) x (dims 16*ks + 0..7 | +8..15)
        ldmatrix_x4(qf[0], q_s + swz<HP>((lane & 7) + (((lane >> 3) & 1) << 3),
                                         ks * 2 + (lane >> 4)));
      }
      const uint32_t (&qa)[4] = qf[R::QSMEM ? 0 : ks];
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        // blocks: (positions 16*n2 + 0..7 | +8..15) x (dims 16*ks + 0..7 | +8..15)
        uint32_t b[4];
        ldmatrix_x4(b, k_s + swz<HP>(n2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                                     ks * 2 + ((lane >> 3) & 1)));
        mma_m16n8k16(sacc[2 * n2], qa, b[0], b[1]);
        mma_m16n8k16(sacc[2 * n2 + 1], qa, b[2], b[3]);
      }
    }

    const bool full = base >= win_lo && base + TP <= hi;
    if constexpr (!PLAIN) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[n][e] = attn_score_log2(sacc[n][e], sm_scale, slope_r[e >> 1],
                                       base + n * 8 + 2 * t + (e & 1), q_pos, soft_cap);
    }
    if (!full) {   // an edge tile: test each position
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = base + n * 8 + 2 * t + (e & 1);
          sacc[n][e] = (pos >= win_lo && pos < hi) ? sacc[n][e] : -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sacc[n][e]);
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float m_new = fmaxf(m_r[rr], quad_max(mx[rr]) * sl2);   // finite
      alpha[rr] = fast_exp2(m_r[rr] - m_new);
      m_r[rr] = m_new;
      l_r[rr] *= alpha[rr];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // 0 for a masked (-inf) score
        const float p = fast_exp2(fmaf(sacc[n][e], sl2, -m_r[e >> 1]));
        sacc[n][e] = p;
        l_r[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
      a[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
      a[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      a[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
#pragma unroll
      for (int n2 = 0; n2 < ON / 2; ++n2) {
        // blocks: (positions 16*kk + 0..7 | +8..15) x (dims 16*n2 + 0..7 | +8..15)
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_s + swz<HP>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                           n2 * 2 + (lane >> 4)));
        mma_m16n8k16(oacc[2 * n2], a, b[0], b[1]);
        mma_m16n8k16(oacc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncwarp();   // the ring is this warp's own and idle: reuse it as a stash

  // Each warp leaves its state in its own ring: O [16][OS], then m [16],
  // l [16].
  float* o_w = reinterpret_cast<float*>(ring);
  float* ml_w = o_w + 16 * OS;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = g + 8 * rr;
    const float l = quad_sum(l_r[rr]);
#pragma unroll
    for (int n = 0; n < ON; ++n)
      *reinterpret_cast<float2*>(o_w + r * OS + n * 8 + 2 * t) =
          make_float2(oacc[n][2 * rr], oacc[n][2 * rr + 1]);
    if (t == 0) {
      ml_w[r] = m_r[rr];
      ml_w[16 + r] = l;
    }
  }
  __syncthreads();   // the one meeting of the CTA's warps

  for (int i = tid; i < grows * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const int head = h * group + g0 + r;
    const bool sink = sinks != nullptr && split == 0;   // counted once
    float m = sink ? sinks[head] * ATTN_LOG2E : ATTN_MASK;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      m = fmaxf(m, reinterpret_cast<const float*>(smem + w * kRingBytes)[16 * OS + r]);
    float l = sink ? exp2f(sinks[head] * ATTN_LOG2E - m) : 0.f;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* sw = reinterpret_cast<const float*>(smem + w * kRingBytes);
      const float wgt = exp2f(sw[16 * OS + r] - m);   // 1 when both are ATTN_MASK: l, o are 0
      l += sw[16 * OS + 16 + r] * wgt;
      o += sw[r * OS + d] * wgt;
    }
    if (splits == 1) {
      out[((size_t)s * qh + head) * HD + d] = __float2bfloat16(o / fmaxf(l, 1e-30f));
    } else {
      const size_t p = part_index(s, head, qh, splits, split);
      part_acc[p * HD + d] = o;
      if (d == 0) {
        part_ml[2 * p] = m;
        part_ml[2 * p + 1] = l;
      }
    }
  }
}

}  // namespace tc

// out[row, :] from the `splits` partials of (sequence, query head) `row`.
// `unit` converts a difference of running maxima to log2 units (1 for the
// bf16 route, log2(e) for the float32 route).
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml,
                                    T* __restrict__ out, int splits, int hd,
                                    float unit) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + row * splits * 2;
  float m = ATTN_MASK;
  for (int i = 0; i < splits; ++i) m = fmaxf(m, ml[2 * i]);
  float l = 0.f, o = 0.f;
  for (int i = 0; i < splits; ++i) {
    // an empty split has m = ATTN_MASK, l = 0: weight 0 beside any real
    // split, weight 1 (times zeros) when every split is empty; never NaN
    const float w = exp2f((ml[2 * i] - m) * unit);
    l += ml[2 * i + 1] * w;
    o += part_acc[(row * splits + i) * hd + d] * w;
  }
  out[row * hd + d] = from_f<T>(o / fmaxf(l, 1e-30f));
}

struct Args {
  const void* q; const void* kv; const int* kv_lens; const int* page_idx;
  const float* sinks; const float* alibi; void* out; float* part_acc; float* part_ml;
  int S, qh, kvh, ps, num_pages, max_pages;
  float sm_scale; int window; float soft_cap; int splits;
  const float* k_scale; const float* v_scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t merge(const Args& a, int hd, float unit) {
  if (a.splits == 1) return cudaSuccess;
  decode_merge_kernel<T><<<a.S * a.qh, hd, 0, a.stream>>>(
      a.part_acc, a.part_ml, static_cast<T*>(a.out), a.splits, hd, unit);
  return cudaGetLastError();
}

template <int HD, typename KVT>
cudaError_t launch_f32(const Args& a) {
  const int group = a.qh / a.kvh;
  const size_t smem = sizeof(float) *
      (2 * group * HD + simple::kTile * (HD + 1) + simple::kTile * HD +
       group * simple::kTile + 3 * group);
  auto kernel = simple::decode_f32_simple_kernel<float, KVT, HD>;
  static SmemAllowed allowed = {};
  cudaError_t err = allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(a.S, a.kvh, a.splits);
  kernel<<<grid, simple::kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const KVT*>(a.kv), a.kv_lens,
      a.page_idx, a.sinks, a.alibi, static_cast<float*>(a.out), a.part_acc, a.part_ml,
      a.qh, a.kvh, a.ps, a.num_pages, a.max_pages, a.sm_scale, a.window, a.soft_cap,
      a.splits, a.k_scale, a.v_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge<float>(a, HD, ATTN_LOG2E);
}

template <int HD, bool PLAIN, int KV>
cudaError_t launch_tc_as(const Args& a) {
  const int group = a.qh / a.kvh;
  const int gchunks = (group + 15) / 16;
  auto kernel = tc::decode_tc_kernel<HD, PLAIN, KV>;
  constexpr size_t smem = tc::Ring<tile_hd(HD), KV>::SMEM;
  static SmemAllowed allowed = {};
  cudaError_t err = allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(a.S, a.kvh * gchunks, a.splits);
  kernel<<<grid, tc::kThreads, smem, a.stream>>>(
      static_cast<const tc::bf16*>(a.q), a.kv, a.kv_lens, a.page_idx, a.sinks,
      a.alibi, static_cast<tc::bf16*>(a.out), a.part_acc, a.part_ml, a.qh, a.kvh,
      gchunks, a.ps, a.num_pages, a.max_pages, a.sm_scale, a.window, a.soft_cap,
      a.splits, a.k_scale, a.v_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge<tc::bf16>(a, HD, 1.f);
}

template <int HD, int KV>
cudaError_t launch_tc(const Args& a) {
  const bool plain = a.alibi == nullptr && a.soft_cap <= 0.f && a.sm_scale > 0.f;
  return plain ? launch_tc_as<HD, true, KV>(a) : launch_tc_as<HD, false, KV>(a);
}

template <int HD>
cudaError_t launch_hd(const Args& a, int dtype, int kv_dtype) {
  if (dtype == ATTN_BF16 && kv_dtype == KV_SAME) return launch_tc<HD, KV_SAME>(a);
  if (dtype == ATTN_BF16 && kv_dtype == KV_INT8) return launch_tc<HD, KV_INT8>(a);
  if (dtype == ATTN_BF16 && kv_dtype == KV_E4M3) return launch_tc<HD, KV_E4M3>(a);
  if (dtype == ATTN_F32 && kv_dtype == KV_SAME) return launch_f32<HD, float>(a);
  if (dtype == ATTN_F32 && kv_dtype == KV_INT8) return launch_f32<HD, int8_t>(a);
  if (dtype == ATTN_F32 && kv_dtype == KV_E4M3) return launch_f32<HD, __nv_fp8_e4m3>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point bound with ctypes. Returns a cudaError_t (0 = launched).
// dtype: 0 float32, 1 bfloat16 (q and out share it). kv_dtype: the pool's
// element type, 0 q's own, 1 int8, 2 float8 e4m3 (AttnKv); k_scale and
// v_scale are float32 device scalars that dequantize an 8-bit pool (null:
// 1). sinks and alibi are float32 [qh] device pointers or null. window <= 0
// and soft_cap <= 0 disable those options. splits >= 1; with splits > 1,
// part_acc (float32 [S, qh, splits, hd]) and part_ml (float32 [S, qh,
// splits, 2]) are scratch the caller allocated, else they may be null.
extern "C" int paged_decode_attention(
    const void* q, const void* kv, const int* kv_lens, const int* page_idx,
    const float* sinks, const float* alibi, void* out, float* part_acc,
    float* part_ml, int S, int qh, int kvh, int hd, int ps, int num_pages,
    int max_pages, float sm_scale, int window, float soft_cap, int splits,
    int dtype, int kv_dtype, const float* k_scale, const float* v_scale,
    void* stream) {
  if (S == 0) return 0;
  if (qh % kvh != 0 || splits < 1 || splits > 65535 ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a = {q, kv, kv_lens, page_idx, sinks, alibi, out, part_acc, part_ml,
                  S, qh, kvh, ps, num_pages, max_pages, sm_scale, window, soft_cap,
                  splits, k_scale, v_scale, static_cast<cudaStream_t>(stream)};
  if (hd == 48) return launch_hd<48>(a, dtype, kv_dtype);
  if (hd == 64) return launch_hd<64>(a, dtype, kv_dtype);
  if (hd == 80) return launch_hd<80>(a, dtype, kv_dtype);
  if (hd == 96) return launch_hd<96>(a, dtype, kv_dtype);
  if (hd == 128) return launch_hd<128>(a, dtype, kv_dtype);
  if (hd == 256) return launch_hd<256>(a, dtype, kv_dtype);
  return (int)cudaErrorInvalidValue;
}
