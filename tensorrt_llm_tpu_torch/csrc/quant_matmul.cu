// Group-wise dequantize + matrix product for weight-only quantized linears.
//
// Replaces the TPU kernel groupwise_dequant_matmul
// (tensorrt_llm_tpu/ops/pallas/quant_matmul.py:105, bodies _w4_kernel :55
// and _w8_kernel :83). Same function: x [M, K] bf16 with M <= 128; integer
// weights, either int4 packed two per byte in split halves (byte [i, n]
// holds row i in its low nibble and row i + K/2 in its high nibble,
// [K/2, N] int8) or int8 [K, N]; scales f32 [K/G, N], one per (group of G
// rows, column). The integers are widened to bf16 exactly, each group's
// product with its slice of x is accumulated in float32, multiplied by the
// group's scale row and added to the float32 result; out [M, N] bf16.
// Contract: G in {16, 32, 64, 128}; int4 K % 2G == 0, int8 K % G == 0; any
// N (edge columns are zero-filled on the way in and not written).
//
// The e4m3 body (FP8 weights quantized at load, ops/linear.py Fp8QdqMethod
// and Fp8BlockwiseMethod; on the TPU the JAX package leaves that product
// to XLA, so this body ports no Pallas kernel): w float8 e4m3 [K, N], one
// byte a value like int8, G = 128. Every finite e4m3 value is a bf16
// value, and it reaches wgmma as exactly that value: cvt e4m3x2 -> f16x2
// (exact: e4m3's subnormals, down to 2^-9, are normal f16 numbers), then
// f16 -> float -> bf16 (exact: 4 significant bits). No rescaling by a
// power of two, so no product nears float32's subnormal range. The scales
// are read through a row stride and a column shift: scale(group g,
// column n) = scales[g * s_row + (n >> s_shift)], which serves the
// group-wise [K/G, N] layout (s_row N, s_shift 0), one scale per column
// for every group (s_row 0: a fused per-tensor projection, each part's
// scale over its columns), one scale for the tensor (s_row 0, s_shift
// 31) and FP8 block scales [K/128, ceil(N/128)] (s_row ceil(N/128),
// s_shift 7) without expanding them. The output is bf16, or float32 when
// asked (out_f32: the FP8 methods return a float32 model's type). At one
// byte a weight the body is bound by K*N bytes over 3.35 TB/s, half of
// bf16's; the widening costs a cvt and two conversions per pair of
// values, on the CUDA cores, beside the wgmma stream.
//
// What bounds it on the H100: up to 64 rows, the bytes of the quantized
// weight (K*N/2 or K*N) over 3.35 TB/s. At M = 64 with int4 the product is
// 256 FLOP per weight byte against the card's ridge of ~295 (989 TFLOP/s
// over 3.35 TB/s), so the tensor cores must run near their peak to keep up
// with the memory; at M = 128 the FLOPs bound it.
//
// Design. The product is computed transposed, out^T = W^T x^T, so that the
// widened weights are wgmma's A operand in registers (m64: 64 weight
// columns per warpgroup) and x is the B operand, read by wgmma from shared
// memory as stored ([row][k], K-major, 128-byte swizzle), with wgmma's N =
// the rows rounded up to 8 (8, 16, 32 or 64; a second row block above 64).
//   * Fewer x bytes per weight byte: a CTA covers 128 weight columns (two
//     consumer warpgroups) and stages each x slice once for all of them
//     (the first version staged x once per 32 columns).
//   * Enough CTAs: K is split across the CTAs of a thread-block cluster
//     (1, 2 or 4, chosen on the host from M, K, N, G, bits and the SM
//     count: about one CTA per SM), in whole chunks of groups. Each CTA
//     leaves its float32 tile in its own shared memory; after a cluster
//     barrier, CTA r sums rows r/S.. of every member's tile in member order
//     through distributed shared memory and writes bf16. One launch, no
//     atomics: the same inputs give the same bits.
//   * Cheap widening: a warp's 16 weight columns of a 16-row step come in
//     with one ldmatrix.x2.trans on byte pairs; the transpose hands each
//     thread two rows of two adjacent columns, which are exactly its A
//     fragment registers once fragment row g is read as column 2g and row
//     g + 8 as column 2g + 1 (the scales and the epilogue undo that order).
//     One packed register serves both int4 halves. A nibble pair becomes a
//     bf16 pair with one lop3, (v & 0x000F000F) ^ 0x43084308 = 128 + (v ^
//     8), and one bf16x2 subtraction of 136: exact. int8 goes through an
//     exact int-to-float conversion.
//   * wgmma for the product, group scaling beside it: each (segment of a
//     group, half) is one batch of wgmmas into a partial accumulator,
//     zeroed by the group's first batch; both halves' batches are issued
//     back to back into two partials, and while a warpgroup waits for them
//     and multiplies them by their float32 scales into the float32 sum,
//     the other warpgroup's batches run.
//   * Copies that overlap the math: one producer warp fills a ring of
//     stages of 64 stored rows (x slices and weight bytes by TMA into the
//     128-byte swizzle, scale rows by cp.async) and signals an mbarrier per
//     stage; the consumers release a stage through another mbarrier once
//     the wgmmas that read it have completed. Where N % 16 != 0 the weight
//     rows are not 16-byte aligned, as TMA needs, and the producer copies
//     them in 4-byte pieces (N % 4 == 0) or bytes: a route chosen by shape.
// The weight bytes stay in the JAX package's layout; a load-time repack
// into fragment order is left for later.

#include <cuda.h>   // CUtensorMap; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_optin.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTN = 128;                          // weight columns per CTA
constexpr int kConsumers = 2;                     // warpgroups, 64 columns each
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 32;   // + the producer warp
constexpr int kRowBlock = 64;                     // x rows per CTA (grid.z covers more)
constexpr int kRedRow = kTN + 4;                  // floats per row of the partial tile
constexpr int kRingBudget = 200 * 1024;
constexpr int kMaxStages = 8;

// Shared-memory plan for BITS (4 or 8), NB x rows (8, 16, 32, 64) and
// group size G. K is split across CTAs in chunks of CH stored weight rows
// (one group, or 64 rows of smaller groups). The ring's stages are 64
// stored rows each: a stage holds the x slice of each half ([NB][64]
// bf16), the weight bytes ([64][kTN]), both in the 128-byte swizzle
// (16-byte piece c of row r at c ^ (r % 8)), and the scale rows of the
// groups it touches ([HALVES][SEGS][kTN] float). A stage is SEGS segments
// of SEG rows; a segment is a whole group, or part of a 128-row group.
template <int BITS, int NB, int G>
struct Plan {
  static constexpr int HALVES = BITS == 4 ? 2 : 1;
  static constexpr int CH = G > 64 ? G : 64;
  static constexpr int SEG = G < 64 ? G : 64;       // rows of a segment
  static constexpr int SEGS = 64 / SEG;             // segments per stage
  static constexpr int PARTS = G > 64 ? G / 64 : 1;   // stages per group
  static constexpr int KS = SEG / 16;               // k16 steps per segment
  static constexpr int XH = NB * 128;               // bytes of one half's x slice
  static constexpr int W_OFF = HALVES * XH;
  static constexpr int S_OFF = W_OFF + 64 * kTN;
  static constexpr int TMA_BYTES = HALVES * XH;     // x boxes per stage
  static constexpr int STAGE = (S_OFF + HALVES * SEGS * kTN * 4 + 1023) / 1024 * 1024;
  static constexpr int STAGES =
      kRingBudget / STAGE > kMaxStages ? kMaxStages : kRingBudget / STAGE;
  static constexpr int RED = NB * kRedRow * 4;
  static constexpr int RING = STAGES * STAGE > RED ? STAGES * STAGE : RED;
  static constexpr int SMEM = RING + 2048;          // barriers + alignment slack
  static_assert(STAGES >= 2, "ring too shallow");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of 16 or 4 bytes; the first `src_bytes` are read, the rest of
// the piece is zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// A 2-D box of a tensor map into shared memory; its bytes count against
// the mbarrier's expected transaction bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Byte offset of byte c of stored row r in a swizzled [rows][kTN] tile.
__device__ __forceinline__ int wsw(int r, int c) {
  return r * kTN + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// The barrier's phase also waits for this thread's cp.async copies so far.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Four floats at the same shared-memory offset in CTA `rank` of the cluster.
__device__ __forceinline__ float4 ld_cluster(const float* p, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// Two 8x8 b16 matrices, each transposed on the way: lanes 0-7 give the
// rows of the first, lanes 8-15 those of the second.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(row)));
}

// Nibbles at bits 0-3 and 16-19 (two's complement int4) -> two bf16, the
// first in the low half: 128 + (v ^ 8) built in the mantissa of 128.0,
// minus 136. Exact.
__device__ __forceinline__ uint32_t int4_pair(uint32_t v) {
  const uint32_t biased = (v & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                             __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Bytes at bits 0-7 and 16-23 (int8) -> two bf16 (exact: |v| <= 128).
__device__ __forceinline__ uint32_t int8_pair(uint32_t v) {
  __nv_bfloat162 h = __floats2bfloat162_rn((float)(int8_t)(v & 0xFFu),
                                           (float)(int8_t)((v >> 16) & 0xFFu));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Bytes at bits 0-7 and 16-23 (e4m3) -> two bf16 of the same values, the
// first in the low half: exact (see the head of this file).
__device__ __forceinline__ uint32_t e4m3_pair(uint32_t v) {
  const unsigned short pair = (unsigned short)__byte_perm(v, 0u, 0x4420);
  uint32_t h;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h) : "h"(pair));
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<uint32_t*>(&b);
}

// Reads of wgmma accumulators stay after the wait that completes them:
// later instructions depend on this asm's outputs, so the compiler cannot
// hoist them above the wait (a read inside the pipeline makes it
// serialize every wgmma).
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The packed bytes of one segment for this thread: the warp's 16 columns
// (starting at `col`), KS x 16 stored rows from `row0` of the stage.
// raw[s][0] holds stored rows 2t, 2t+1 and raw[s][1] rows 2t+8, 2t+9 of
// step s, each for columns 2g and 2g + 1 (fragment rows g and g + 8).
template <int KS>
__device__ __forceinline__ void load_raw(uint32_t (&raw)[KS][2], const uint8_t* ws, int row0,
                                         int col, int lane) {
#pragma unroll
  for (int s = 0; s < KS; ++s)
    ldmatrix_x2_trans(raw[s][0], raw[s][1], ws + wsw(row0 + 16 * s + (lane & 15), col));
}

// A fragments of one half from the packed bytes: register a[s] is
// mma.m16n8k16's A layout for k16 step s, fragment row g = column 2g, row
// g + 8 = column 2g + 1.
template <int BITS, int HALF, int KS, bool FP8>
__device__ __forceinline__ void widen(uint32_t (&a)[KS][4], const uint32_t (&raw)[KS][2]) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (BITS == 4) {
        a[s][2 * i] = int4_pair(raw[s][i] >> (4 * HALF));
        a[s][2 * i + 1] = int4_pair(raw[s][i] >> (4 * HALF + 8));
      } else if constexpr (FP8) {
        a[s][2 * i] = e4m3_pair(raw[s][i]);
        a[s][2 * i + 1] = e4m3_pair(raw[s][i] >> 8);
      } else {
        a[s][2 * i] = int8_pair(raw[s][i]);
        a[s][2 * i + 1] = int8_pair(raw[s][i] >> 8);
      }
    }
  }
}

// One (segment, half) batch: p = A . x over the segment's KS k16 steps;
// `desc` addresses the segment's first step in the x slice (steps are 32
// bytes apart in the swizzled rows); `fresh` starts the partial at 0.
template <int NB, int KS>
__device__ __forceinline__ void issue(float (&p)[NB / 2], const uint32_t (&a)[KS][4],
                                      uint64_t desc, bool fresh) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) wgmma_rs<NB>(p, a[s], desc + 2 * s, s > 0 || !fresh);
  wgmma_commit();
}

// acc += p * scale of the accumulator row's column (rows g: sc.x, g + 8: sc.y).
template <int NR>
__device__ __forceinline__ void scale_add(float (&acc)[NR], float (&p)[NR], float2 sc) {
  keep(p);
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = fmaf(p[i], (i & 2) ? sc.y : sc.x, acc[i]);
}

template <int BITS, int NB, int G, bool FP8>
__global__ void __launch_bounds__(kThreads, 1)
quant_matmul_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map, const uint8_t* __restrict__ w,
                    const float* __restrict__ scales, void* __restrict__ out, int M, int K,
                    int N, int w_piece, int s_piece, int s_row, int s_shift, int out_f32) {
  using P = Plan<BITS, NB, G>;
  constexpr int HALVES = P::HALVES;
  constexpr int NR = NB / 2;   // accumulator floats per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + P::STAGES;
  const unsigned raw = smem_addr(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 256 + 1023) & ~1023u) - raw);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kTN;
  const int splits = gridDim.y;
  const int m0 = blockIdx.z * kRowBlock;
  const int rows_m = min(kRowBlock, M - m0);
  const int Kh = K / HALVES;       // stored weight rows
  const int groups = Kh / G;       // groups per half
  // This CTA's chunks: an even share, the first `extra` CTAs one more
  // (ops/cuda/quant_matmul.py split_chunks computes the same); its stored
  // rows [row_begin, row_end), walked in stages of 64.
  const int chunks = (Kh + P::CH - 1) / P::CH;
  const int per = chunks / splits;
  const int extra = chunks % splits;
  const int c_begin = blockIdx.y * per + min((int)blockIdx.y, extra);
  const int row_begin = c_begin * P::CH;
  const int row_end = min(Kh, (c_begin + per + ((int)blockIdx.y < extra ? 1 : 0)) * P::CH);
  const int n_stages = (row_end - row_begin + 63) / 64;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  const int lane = tid & 31;
  const int col = (tid >> 5) * 16;   // consumer warp's 16 columns in the tile

  if (tid >= kConsumerThreads) {
    // ---- producer warp: fill the ring ---------------------------------
    // x by TMA (rows past M and columns past the chunk arrive as zeros);
    // the weights by TMA where their rows are 16-byte aligned (w_piece 0),
    // else by 4-byte cp.async (N % 4 == 0) or byte loads; the scale rows
    // by cp.async. Lane 0 arrives with the TMA bytes after its own copies.
    for (int j = 0; j < n_stages; ++j) {
      const int st = j % P::STAGES;
      if (j >= P::STAGES) mbar_wait(&empty[st], (j / P::STAGES - 1) & 1);
      const int r0 = row_begin + 64 * j;
      const int rows = min(64, row_end - r0);
      unsigned char* base = ring + st * P::STAGE;
      uint8_t* ws = base + P::W_OFF;
      if (w_piece == 4) {
        const int c = lane * 4;
        for (int r = 0; r < 64; ++r) {
          const bool live = r < rows && n0 + c < N;   // N % 4 == 0: whole pieces
          cp_async_4(ws + wsw(r, c), live ? w + (size_t)(r0 + r) * N + n0 + c : w,
                     live ? 4 : 0);
        }
      } else if (w_piece == 1) {
        const int c = lane * 4;
        for (int r = 0; r < 64; ++r) {
          uint32_t v = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (r < rows && n0 + c + b < N)
              v |= (uint32_t)w[(size_t)(r0 + r) * N + n0 + c + b] << (8 * b);
          *reinterpret_cast<uint32_t*>(ws + wsw(r, c)) = v;
        }
      }
      float* sc = reinterpret_cast<float*>(base + P::S_OFF);
      for (int h = 0; h < HALVES; ++h) {
        for (int si = 0; si < P::SEGS; ++si) {
          const bool seg = si * P::SEG < rows;
          const float* src =
              scales + (size_t)(h * groups + (r0 + (seg ? si * P::SEG : 0)) / G) * s_row;
          float* dst = sc + (h * P::SEGS + si) * kTN;
          if (s_piece == 16) {   // s_shift 0
            const int c = lane * 4;
            const bool live = seg && n0 + c < N;   // N % 4 == 0: whole pieces
            cp_async_16(dst + c, live ? src + n0 + c : scales, live ? 16 : 0);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = lane + 32 * i;
              const bool live = seg && n0 + c < N;
              cp_async_4(dst + c, live ? src + ((n0 + c) >> s_shift) : scales, live ? 4 : 0);
            }
          }
        }
      }
      mbar_arrive_copies(&full[st]);
      if (lane == 0) {
        mbar_arrive_expect(&full[st], P::TMA_BYTES + (w_piece == 0 ? 64 * kTN : 0));
#pragma unroll
        for (int h = 0; h < HALVES; ++h)
          tma_load(base + h * P::XH, &x_map, h * Kh + r0, m0, &full[st]);
        if (w_piece == 0) tma_load(ws, &w_map, n0, r0, &full[st]);
      } else {
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // ---- consumer warpgroups ------------------------------------------
    // Per segment: widen both halves, issue both batches back to back,
    // wait, scale. Nothing reads an accumulator while a wgmma is in flight
    // (the compiler would serialize every wgmma otherwise); the other
    // warpgroup's batches keep the tensor cores busy meanwhile. The group
    // structure is unrolled at compile time (a 128-row group is two
    // stages), and a stage past the end of K is multiplied out in full
    // (its weights and scales arrive as zeros).
    const int g = lane >> 2;
    float p0[NR], p1[NR];
    uint32_t raw[P::KS][2], a0[P::KS][4], a1[P::KS][4];
    float2 s0, s1;
    for (int j0 = 0; j0 < n_stages; j0 += P::PARTS) {
#pragma unroll
      for (int part = 0; part < P::PARTS; ++part) {
        const int j = j0 + part;
        const int st = j % P::STAGES;
        mbar_wait(&full[st], (j / P::STAGES) & 1);
        const unsigned char* base = ring + st * P::STAGE;
        const uint8_t* ws = base + P::W_OFF;
        const float* sc = reinterpret_cast<const float*>(base + P::S_OFF) + col + 2 * g;
        const uint64_t xd = wgmma_desc(base, 16, 1024);   // + 2 per 32 bytes
        const bool last = part == P::PARTS - 1;   // folded by the unrolling
#pragma unroll
        for (int si = 0; si < P::SEGS; ++si) {
          const int k0 = si * P::SEG;
          load_raw(raw, ws, k0, col, lane);
          widen<BITS, 0, P::KS, FP8>(a0, raw);
          if constexpr (BITS == 4) widen<BITS, 1, P::KS, FP8>(a1, raw);
          if (last) {
            s0 = *reinterpret_cast<const float2*>(sc + si * kTN);
            if constexpr (BITS == 4) s1 = *reinterpret_cast<const float2*>(sc + (P::SEGS + si) * kTN);
          }
          // the low half (or the int8 group) into p0, the high half into p1
          issue<NB>(p0, a0, xd + k0 / 8, part == 0);
          if constexpr (BITS == 4) issue<NB>(p1, a1, xd + (P::XH + k0 * 2) / 16, part == 0);
          wgmma_wait<0>();
          if (last) {
            scale_add(acc, p0, s0);
            if constexpr (BITS == 4) scale_add(acc, p1, s1);
          }
        }
        mbar_arrive(&empty[st]);
      }
    }
  }

  // ---- epilogue: partial tiles meet across the cluster ------------------
  __syncthreads();   // every stage has been read: the ring holds the tile now
  float* red = reinterpret_cast<float*>(ring);
  if (tid < kConsumerThreads) {
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(8 * j + 2 * t + (e & 1)) * kRedRow + col + 2 * g + (e >> 1)] = acc[4 * j + e];
  }
  if (splits > 1) cluster_sync(); else __syncthreads();
  const int rank = splits > 1 ? cluster_rank() : 0;
  constexpr int V = NB * (kTN / 4);   // float4s of the tile
  const int share = V / splits;
  for (int v = rank * share + tid; v < (rank + 1) * share; v += kThreads) {
    const int m = v / (kTN / 4);
    const int c = (v % (kTN / 4)) * 4;
    if (m >= rows_m || n0 + c >= N) continue;
    const float* src = red + m * kRedRow + c;
    float4 sum = splits > 1 ? ld_cluster(src, 0) : *reinterpret_cast<const float4*>(src);
    for (int q = 1; q < splits; ++q) {
      const float4 o = ld_cluster(src, q);
      sum.x += o.x;
      sum.y += o.y;
      sum.z += o.z;
      sum.w += o.w;
    }
    const size_t at = (size_t)(m0 + m) * N + n0 + c;
    if (out_f32) {
      float* dst = static_cast<float*>(out) + at;
      if ((N & 3) == 0) {   // n0 + c + 3 < N, 16-byte aligned
        *reinterpret_cast<float4*>(dst) = sum;
      } else {
        const float f[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (n0 + c + i < N) dst[i] = f[i];
      }
      continue;
    }
    bf16* dst = static_cast<bf16*>(out) + at;
    if ((N & 3) == 0) {   // n0 + c + 3 < N, 8-byte aligned
      __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x, sum.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z, sum.w);
      uint2 pk;
      pk.x = *reinterpret_cast<uint32_t*>(&lo);
      pk.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst) = pk;
    } else {
      const float f[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n0 + c + i < N) dst[i] = __float2bfloat16(f[i]);
    }
  }
  if (splits > 1) cluster_sync();   // no CTA leaves while others read its tile
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                               const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                               const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                               CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (no link against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D row-major tensor of `cols` x `rows` elements (`pitch` bytes per
// row) read in boxes of box_cols x box_rows into the 128-byte swizzle;
// reads outside the tensor fill zeros.
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t cols,
            uint64_t rows, uint64_t pitch, uint32_t box_cols, uint32_t box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Where the scales are read: row stride and column shift (see the head).
struct ScaleMap {
  int row;
  int shift;
};

template <int BITS, int NB, int G, bool FP8>
cudaError_t launch(const void* x, const void* w, const float* scales, void* out, int M,
                   int K, int N, int splits, ScaleMap sm, int out_f32, cudaStream_t stream) {
  using P = Plan<BITS, NB, G>;
  auto kernel = quant_matmul_kernel<BITS, NB, G, FP8>;
  static SmemAllowed allowed = {};
  cudaError_t err = allow_smem(kernel, P::SMEM, &allowed);
  if (err != cudaSuccess) return err;
  // copy routes by shape: TMA needs 16-byte aligned rows, cp.async of 16
  // bytes 16-byte aligned pieces
  const int Kh = K / P::HALVES;
  const uintptr_t wp = reinterpret_cast<uintptr_t>(w);
  const int w_piece = (N % 16 == 0 && wp % 16 == 0) ? 0 : (N % 4 == 0 && wp % 4 == 0) ? 4 : 1;
  const int s_piece = (N % 4 == 0 && sm.shift == 0 && sm.row % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(scales) % 16 == 0)
                          ? 16
                          : 4;
  CUtensorMap x_map = {}, w_map = {};
  if (!encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2, 64, NB))
    return cudaErrorInvalidValue;
  if (w_piece == 0 &&
      !encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, Kh, N, kTN, 64))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTN - 1) / kTN, splits, (M + kRowBlock - 1) / kRowBlock);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = P::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x_map, w_map, static_cast<const uint8_t*>(w), scales,
                           out, M, K, N, w_piece, s_piece, sm.row, sm.shift, out_f32);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// wgmma's N by the rows of one row block: no more rows staged than needed.
template <int BITS, int G, bool FP8>
cudaError_t launch_rows(const void* x, const void* w, const float* scales, void* out, int M,
                        int K, int N, int splits, ScaleMap sm, int out_f32,
                        cudaStream_t stream) {
  const int rows = M < kRowBlock ? M : kRowBlock;
  if (rows <= 8)
    return launch<BITS, 8, G, FP8>(x, w, scales, out, M, K, N, splits, sm, out_f32, stream);
  if (rows <= 16)
    return launch<BITS, 16, G, FP8>(x, w, scales, out, M, K, N, splits, sm, out_f32, stream);
  if (rows <= 32)
    return launch<BITS, 32, G, FP8>(x, w, scales, out, M, K, N, splits, sm, out_f32, stream);
  return launch<BITS, 64, G, FP8>(x, w, scales, out, M, K, N, splits, sm, out_f32, stream);
}

template <int BITS>
cudaError_t launch_group(const void* x, const void* w, const float* scales, void* out, int M,
                         int K, int N, int G, int splits, ScaleMap sm, int out_f32,
                         cudaStream_t stream) {
  switch (G) {
    case 16:
      return launch_rows<BITS, 16, false>(x, w, scales, out, M, K, N, splits, sm, out_f32,
                                          stream);
    case 32:
      return launch_rows<BITS, 32, false>(x, w, scales, out, M, K, N, splits, sm, out_f32,
                                          stream);
    case 64:
      return launch_rows<BITS, 64, false>(x, w, scales, out, M, K, N, splits, sm, out_f32,
                                          stream);
    case 128:
      return launch_rows<BITS, 128, false>(x, w, scales, out, M, K, N, splits, sm, out_f32,
                                           stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes. Returns a cudaError_t (0 = launched).
// x is bf16; w int8 (bits 4: [K/2, N] packed; bits 8: [K, N]) or, with
// e4m3 (bits 8, G 128), float8 e4m3 [K, N]; scale(g, n) =
// scales[g * s_row + (n >> s_shift)] (float32); out bf16, or float32 with
// out_f32. x must be 16-byte aligned. `splits` (1, 2, 4 or 8) is the
// cluster's CTAs along K, chosen by the caller.
extern "C" int groupwise_dequant_matmul(const void* x, const void* w, const float* scales,
                                        void* out, int M, int K, int N, int G, int bits,
                                        int e4m3, int splits, int s_row, int s_shift,
                                        int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (G <= 0 || M < 0 || M > 2 * kRowBlock) return (int)cudaErrorInvalidValue;
  if (splits != 1 && splits != 2 && splits != 4 && splits != 8) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16) return (int)cudaErrorInvalidValue;
  if (s_row < 0 || s_shift < 0 || s_shift > 31) return (int)cudaErrorInvalidValue;
  const ScaleMap sm = {s_row, s_shift};
  if (e4m3) {
    if (bits != 8 || G != 128 || K % G) return (int)cudaErrorInvalidValue;
    return launch_rows<8, 128, true>(x, w, scales, out, M, K, N, splits, sm, out_f32, st);
  }
  if (bits == 4 && K % (2 * G) == 0)
    return launch_group<4>(x, w, scales, out, M, K, N, G, splits, sm, out_f32, st);
  if (bits == 8 && K % G == 0)
    return launch_group<8>(x, w, scales, out, M, K, N, G, splits, sm, out_f32, st);
  return (int)cudaErrorInvalidValue;
}
