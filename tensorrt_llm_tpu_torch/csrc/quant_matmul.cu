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
// N (edge columns are guarded, not padded).
//
// Design (simple first version): one CTA of sixteen warps per tile of 32
// output columns and block of up to 64 rows. K is walked in chunks of 128
// stored weight rows (for int4 that is 128 rows of the low half of K and
// the 128 matching rows of the high half). A chunk's weights (128 x 32
// bytes), the matching columns of x (two slices for int4) and its scale
// rows are copied into shared memory with cp.async, into a ring of three
// buffers, so the next two chunks are in flight while one is multiplied.
// Warp (c, k) owns the 8-column slice c and the 32-row slice k of the
// chunk: it widens the nibbles/bytes of a 16 x 8 weight fragment once,
// feeds it to mma.sync m16n8k16 (bf16 in, float32 out) for every 16-row
// block of x (A fragments by ldmatrix), and after the last fragment of a
// group multiplies the partial sums by the two scales its accumulator
// columns need. The four row slices' float32 sums meet in shared memory
// at the end. Staged rows are padded (x by 8 elements, weights to 36
// bytes) so the fragment reads hit 32 distinct banks. Group size, bits
// and row blocks are template parameters: every inner loop has a
// compile-time trip count.
//
// What bounds it on the H100: at M <= 128 the bytes of the quantized
// weight (K*N/2 or K*N) over 3.35 TB/s; the product itself would take
// 2*M*K*N / 989 TFLOP/s on the tensor cores. What this design leaves on
// the table: every CTA stages all of x again (N/32 copies through L2),
// N = 2048 gives only 64 CTAs for 132 SMs (no split over K across CTAs),
// each fragment byte is read with its own shared-memory load and widened
// through an int-to-float conversion, the ring is filled by all threads
// rather than by TMA, and mma.sync reaches about half of what wgmma does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTN = 32;              // output columns per CTA: four 8-column slices
constexpr int kKSplit = 4;           // row slices per chunk, one warp each per column slice
constexpr int kThreads = 128 * kKSplit;
constexpr int kChunk = 128;          // stored weight rows per ring buffer
constexpr int kSlice = kChunk / kKSplit;   // rows of a chunk per warp: two k16 steps
constexpr int kWStride = kTN + 4;    // bytes per staged weight row
constexpr int kXPad = 8;             // bf16 elements of padding per x row
constexpr int kStages = 3;           // ring depth (chunks)
constexpr int kRedStride = kTN + 1;  // floats per row of the final reduction

__device__ __forceinline__ void mma_m16n8k16(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16 x 16 bf16 A fragment of mma.m16n8k16 in one instruction: lanes
// 0-15 give the addresses of rows 0-15 at column 0, lanes 16-31 those of
// rows 0-15 at column 8 (each row 16 bytes, 16-byte aligned).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* row) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// One stored byte -> the integer it holds for this pass. int4: half 0 is
// the low nibble, half 1 the high nibble, both sign-extended from 4 bits.
template <int BITS>
__device__ __forceinline__ int widen(uint8_t b, int half) {
  if (BITS == 8) return (int)(int8_t)b;
  const int nib = half == 0 ? (b & 0x0F) : (b >> 4);
  return (nib ^ 8) - 8;
}

// Two small integers -> one register of two bf16 (exact), first in the
// low 16 bits.
__device__ __forceinline__ uint32_t bf16_pair(int first, int second) {
  __nv_bfloat162 h = __floats2bfloat162_rn((float)first, (float)second);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// BITS: 4 (packed split halves) or 8. MT: 16-row blocks per CTA (1, 2 or
// 4). G: quantization group size.
template <int BITS, int MT, int G>
struct Tile {
  static constexpr int HALVES = BITS == 4 ? 2 : 1;
  static constexpr int TM = MT * 16;
  static constexpr int NG = kChunk / G;                       // groups per chunk and half
  static constexpr int XS_STRIDE = kChunk + kXPad;            // bf16 elements
  static constexpr int XS_BYTES = 2 * HALVES * TM * XS_STRIDE;
  static constexpr int WS_BYTES = kChunk * kWStride;
  static constexpr int SC_BYTES = 4 * HALVES * NG * kTN;
  static constexpr int STAGE_BYTES = XS_BYTES + WS_BYTES + SC_BYTES;   // multiple of 16
  static constexpr int RED_BYTES = 4 * kKSplit * TM * kRedStride;
  static constexpr int SMEM_BYTES =
      kStages * STAGE_BYTES > RED_BYTES ? kStages * STAGE_BYTES : RED_BYTES;
};

template <int BITS, int MT, int G>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scales, __nv_bfloat16* __restrict__ out,
                    int M, int K, int N) {
  using T = Tile<BITS, MT, G>;
  constexpr int HALVES = T::HALVES;
  constexpr int TM = T::TM;
  constexpr int NG = T::NG;
  constexpr int XS = T::XS_STRIDE;
  extern __shared__ __align__(16) unsigned char smem[];   // kStages x [x | w | scales]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cw = (tid >> 5) & 3;     // column slice of this warp
  const int kw = tid >> 7;           // row slice of this warp
  const int g = lane >> 2;           // fragment row / column group
  const int t = lane & 3;
  const int n0 = blockIdx.x * kTN;
  const int m0 = blockIdx.y * TM;
  const int Kh = K / HALVES;         // stored weight rows
  const int groups = Kh / G;         // groups per half
  const int chunks = (Kh + kChunk - 1) / kChunk;
  const bool word_loads = (N % 4) == 0;

  // Start the copies of chunk c into ring buffer `buf` (cp.async where a
  // whole aligned word or vector is in range, plain stores elsewhere).
  // Rows past the end of K are neither copied nor read.
  auto stage = [&](int c, int buf) {
    unsigned char* base = smem + buf * T::STAGE_BYTES;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base);
    uint8_t* ws = base + T::XS_BYTES;
    float* sc = reinterpret_cast<float*>(base + T::XS_BYTES + T::WS_BYTES);
    const int rows = min(kChunk, Kh - c * kChunk);
#pragma unroll
    for (int i = tid; i < kChunk * (kTN / 4); i += kThreads) {
      const int r = i / (kTN / 4);
      const int c4 = (i % (kTN / 4)) * 4;
      if (r >= rows) continue;
      const int8_t* src = w + (size_t)(c * kChunk + r) * N + n0 + c4;
      uint8_t* dst = ws + r * kWStride + c4;
      if (word_loads && n0 + c4 + 3 < N) {
        cp_async_4(dst, src);
      } else {
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + c4 + j < N) v |= (uint32_t)(uint8_t)src[j] << (8 * j);
        *reinterpret_cast<uint32_t*>(dst) = v;
      }
    }
    constexpr int VECS = kChunk / 8;   // 16-byte vectors per staged x row
#pragma unroll
    for (int i = tid; i < HALVES * TM * VECS; i += kThreads) {
      const int h = i / (TM * VECS);
      const int rem = i % (TM * VECS);
      const int r = rem / VECS;
      const int v = (rem % VECS) * 8;
      if (v >= rows) continue;
      __nv_bfloat16* dst = xs + (h * TM + r) * XS + v;
      if (m0 + r < M)
        cp_async_16(dst, x + (size_t)(m0 + r) * K + h * Kh + c * kChunk + v);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = tid; i < HALVES * NG * kTN; i += kThreads) {
      const int h = i / (NG * kTN);
      const int gi = (i / kTN) % NG;
      const int cc = i % kTN;
      if (gi * G >= rows) continue;
      if (n0 + cc < N)
        cp_async_4(sc + i, scales + (size_t)(h * groups + c * NG + gi) * N + n0 + cc);
      else
        sc[i] = 0.f;
    }
    cp_async_commit();
  };

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;

  // Ring of kStages chunks: kStages - 1 are in flight while one is
  // multiplied. Every step commits one cp.async group (an empty one past
  // the end), so "all but the newest kStages - 2" always means "chunk c".
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) stage(s, s); else cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    const int buf = c % kStages;
    cp_async_wait<kStages - 2>();    // this thread's copies of chunk c have landed
    __syncthreads();                 // everyone's have, and chunk c - 1 has been read
    const int next = c + kStages - 1;
    if (next < chunks) stage(next, next % kStages); else cp_async_commit();

    const unsigned char* base = smem + buf * T::STAGE_BYTES;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(base);
    const uint8_t* ws = base + T::XS_BYTES;
    const float* sc = reinterpret_cast<const float*>(base + T::XS_BYTES + T::WS_BYTES);
    const int rows = min(kChunk, Kh - c * kChunk);
    // This warp's rows of the chunk, one group (or part of one) at a time.
    constexpr int SUB = G < kSlice ? G : kSlice;
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      const __nv_bfloat16* xh = xs + h * TM * XS;
#pragma unroll
      for (int sb = 0; sb < kSlice; sb += SUB) {
        const int row0 = kw * kSlice + sb;
        if (row0 >= rows) continue;   // rows is a multiple of G, so of SUB
        float part[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[mt][i] = 0.f;
#pragma unroll
        for (int ks = row0; ks < row0 + SUB; ks += 16) {
          // B fragment: rows ks + 2t, +1, +8, +9 of column cw*8 + g
          const uint8_t* wr = ws + (ks + t * 2) * kWStride + cw * 8 + g;
          const uint32_t b0 = bf16_pair(widen<BITS>(wr[0], h), widen<BITS>(wr[kWStride], h));
          const uint32_t b1 = bf16_pair(widen<BITS>(wr[8 * kWStride], h),
                                        widen<BITS>(wr[9 * kWStride], h));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            ldmatrix_x4(a, xh + (mt * 16 + (lane & 15)) * XS + ks + (lane >> 4) * 8);
            mma_m16n8k16(part[mt], a, b0, b1);
          }
        }
        const float* s = sc + (h * NG + row0 / G) * kTN + cw * 8 + t * 2;
        const float s0 = s[0];
        const float s1 = s[1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][0] += part[mt][0] * s0;
          acc[mt][1] += part[mt][1] * s1;
          acc[mt][2] += part[mt][2] * s0;
          acc[mt][3] += part[mt][3] * s1;
        }
      }
    }
  }

  // The row slices' sums meet in shared memory (every real copy has been
  // waited for; the ring is free once all warps are past the loop).
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);   // [kKSplit][TM][kRedStride]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = mt * 16 + g + (i >> 1) * 8;
      red[(kw * TM + r) * kRedStride + cw * 8 + t * 2 + (i & 1)] = acc[mt][i];
    }
  }
  __syncthreads();
  for (int i = tid; i < TM * kTN; i += kThreads) {
    const int r = i / kTN;
    const int cc = i % kTN;
    if (m0 + r >= M || n0 + cc >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kKSplit; ++k) sum += red[(k * TM + r) * kRedStride + cc];
    out[(size_t)(m0 + r) * N + n0 + cc] = __float2bfloat16(sum);
  }
}

template <int BITS, int MT, int G>
cudaError_t launch(const void* x, const void* w, const float* scales, void* out, int M,
                   int K, int N, cudaStream_t stream) {
  using T = Tile<BITS, MT, G>;
  constexpr size_t smem = T::SMEM_BYTES;
  auto kernel = quant_matmul_kernel<BITS, MT, G>;
  static bool opted_in = false;   // dynamic shared memory above 48 KB needs an opt-in
  if (smem > 48 * 1024 && !opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  dim3 grid((N + kTN - 1) / kTN, (M + T::TM - 1) / T::TM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w), scales,
      static_cast<__nv_bfloat16*>(out), M, K, N);
  return cudaGetLastError();
}

// Row blocks per CTA by M: no more rows are staged than the call has.
template <int BITS, int G>
cudaError_t launch_rows(const void* x, const void* w, const float* scales, void* out, int M,
                        int K, int N, cudaStream_t stream) {
  if (M <= 16) return launch<BITS, 1, G>(x, w, scales, out, M, K, N, stream);
  if (M <= 32) return launch<BITS, 2, G>(x, w, scales, out, M, K, N, stream);
  return launch<BITS, 4, G>(x, w, scales, out, M, K, N, stream);
}

template <int BITS>
cudaError_t launch_group(const void* x, const void* w, const float* scales, void* out, int M,
                         int K, int N, int G, cudaStream_t stream) {
  switch (G) {
    case 16: return launch_rows<BITS, 16>(x, w, scales, out, M, K, N, stream);
    case 32: return launch_rows<BITS, 32>(x, w, scales, out, M, K, N, stream);
    case 64: return launch_rows<BITS, 64>(x, w, scales, out, M, K, N, stream);
    case 128: return launch_rows<BITS, 128>(x, w, scales, out, M, K, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes. Returns a cudaError_t (0 = launched).
// x and out are bf16, w int8 (bits 4: [K/2, N] packed; bits 8: [K, N]),
// scales float32 [K/G, N]; x must be 16-byte and w 4-byte aligned.
extern "C" int groupwise_dequant_matmul(const void* x, const void* w, const float* scales,
                                        void* out, int M, int K, int N, int G, int bits,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (G <= 0 || M < 0 || M > 128) return (int)cudaErrorInvalidValue;
  if (bits == 4 && K % (2 * G) == 0) return launch_group<4>(x, w, scales, out, M, K, N, G, st);
  if (bits == 8 && K % G == 0) return launch_group<8>(x, w, scales, out, M, K, N, G, st);
  return (int)cudaErrorInvalidValue;
}
