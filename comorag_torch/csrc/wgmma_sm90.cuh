// Hopper warpgroup matrix products (wgmma) shared by the port's kernels:
// the shared-memory matrix descriptor of a 128-byte-swizzled operand, the
// fence / commit / wait steps, and the bf16 products with fp32 sums that
// the kernels issue.
//
// Operand layouts (PTX ISA, "Matrix Descriptor"; T = 8 bf16, one 16-byte
// unit), for tiles written by TMA with CU_TENSOR_MAP_SWIZZLE_128B in boxes
// of [rows][64 columns] (one 128-byte row per box row, 1024-byte aligned):
//   K-major (K contiguous):  8-row groups at SBO bytes; a 16-deep step
//                            starts 32 bytes further along the row.
//   MN-major (M or N contiguous): 64 columns a box; the next 64 columns at
//                            LBO bytes, the next 8 K rows at SBO bytes; a
//                            16-deep step starts 16 rows further down.
// Accumulator of an m64nN product, thread t of the warpgroup (warp w =
// t / 32, g = (t % 32) / 4, q = t % 4): d[i] is row 16w + g + 8((i / 2) % 2),
// column 8(i / 4) + 2q + i % 2.
#pragma once

#include <stdint.h>

namespace comorag {

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define COMORAG_D32(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),   \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),  \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),  \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define COMORAG_R32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " COMORAG_R32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : COMORAG_D32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

#define COMORAG_D64(d)                                                                               \
  COMORAG_D32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),        \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),       \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]),       \
      "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define COMORAG_R64                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "      \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "   \
  "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " COMORAG_R64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : COMORAG_D64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory, A
// K-major and B MN-major (a row-major [K, N] matrix's tile as it lies)
__device__ __forceinline__ void wgmma_ss128_bmn(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " COMORAG_R64 ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : COMORAG_D64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] (registers) B[16 x 64] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " COMORAG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : COMORAG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] (+)= A[64 x 16] (registers) B[16 x 128] (shared, K-major);
// accumulate 0 overwrites d. A's registers are read asynchronously: they
// stay untouched until a wgmma_wait covers this product.
__device__ __forceinline__ void wgmma_rs128(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " COMORAG_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : COMORAG_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

}  // namespace comorag
