// Hopper warpgroup matrix multiply (wgmma) for the bf16 prefill kernel and
// the dequant-matmul kernel: shared-memory matrix descriptors, the fences
// and group waits, and the instruction shapes the two kernels use. All of
// it needs sm_90a.
//
// A warpgroup is four consecutive warps (128 threads); every thread of it
// executes each wgmma instruction. The float32 result of m64nNk16 is spread
// like mma.m16n8k16's: warp w of the group holds rows 16w + g and 16w + g +
// 8 (g = lane / 4), and for every block of 8 columns j the registers d[4j],
// d[4j+1] are row g, columns 8j + 2t, 8j + 2t + 1 (t = lane % 4) and
// d[4j+2], d[4j+3] the same columns of row g + 8. An A operand given in
// registers has mma.m16n8k16's A layout for the warp's 16 rows.
#pragma once

#include <stdint.h>

// Shared-memory operand tiles use the 128-byte swizzle: rows of 64 bf16
// (128 bytes), the 16-byte chunk index XORed with the row's low three
// bits, each tile 1024-byte aligned. A matrix wider than 64 elements in
// its contiguous dimension is stored as blocks of 64 columns, one whole
// [rows][64] tile after the other.
//
// Descriptor: bits 0-13 start address >> 4, 16-29 leading byte offset >> 4,
// 32-45 stride byte offset >> 4, 62-63 swizzle mode (1 = 128 bytes).
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile, int lbo_bytes,
                                               int sbo_bytes) {
  const uint64_t addr = (uint64_t)__cvta_generic_to_shared(tile);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// Writes made by ordinary stores and cp.async become visible to wgmma's
// reads of shared memory (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Before the first wgmma of a batch, and after registers it will read or
// accumulate into were written by other instructions.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// d (64 x 64) = or += A (64 x 16, shared, K-major) * B (64 x 16 rows of
// [n][k], shared, K-major). accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, stored
// [k][n]: MN-major, read transposed).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128) += A (64 x 16, registers) * B (16 x 128, shared, stored
// [k][n]: MN-major, read transposed).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x N) = or += A (64 x 16, registers) * B (16 x N, shared, stored
// [n][k]: K-major, as the ss shape above reads it). accumulate == 0
// overwrites d. The dequant-matmul kernel's shapes: A holds widened weight
// columns, B the activation rows (N = rows rounded up to 8).
__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// The register-A shape whose N is NB (8, 16, 32 or 64).
template <int NB>
__device__ __forceinline__ void wgmma_rs(float (&d)[NB / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  static_assert(NB == 8 || NB == 16 || NB == 32 || NB == 64, "no such shape");
  if constexpr (NB == 8) wgmma_m64n8k16_rs(d, a, desc_b, accumulate);
  if constexpr (NB == 16) wgmma_m64n16k16_rs(d, a, desc_b, accumulate);
  if constexpr (NB == 32) wgmma_m64n32k16_rs(d, a, desc_b, accumulate);
  if constexpr (NB == 64) wgmma_m64n64k16_rs(d, a, desc_b, accumulate);
}
