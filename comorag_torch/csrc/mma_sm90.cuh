// Warp-level building blocks shared by the port's kernels: cp.async copies
// into shared memory, ldmatrix fragment loads, mma.sync m16n8k16 bf16 and
// m16n8k8 tf32 products with fp32 accumulators.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .row.col), for lane l with
// g = l / 4 and t = l % 4:
//   A (16x16, row-major): a0 = (row g, cols 2t..2t+1), a1 = (row g+8, same),
//                         a2 = (row g, cols 2t+8..2t+9), a3 = (row g+8, same)
//   B (16x8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16x8, fp32):       c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, same)
// Each 32-bit register holds two bf16, the lower column (or k) in the low half.
// mma.m16n8k8 with .tf32 operands, one per 32-bit register:
//   A (16x8):             a0 = (row g, col t), a1 = (row g+8, col t),
//                         a2 = (row g, col t+4), a3 = (row g+8, col t+4)
//   B (8x8, k x n):       b0 = (k t, n g), b1 = (k t+4, n g)
//   C:                    as for m16n8k16.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace comorag {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// c += a @ b for one 16x8x16 tile
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a @ b for one 16x8x8 tile of tf32 operands
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as hi + lo, both tf32 rounded to nearest (ties away): hi keeps 11
// significant bits, lo the next 11, and x - hi - lo is at most ~2^-22 |x|
// (the 3xTF32 split)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// A fragment of the 16x16 row-major tile at `tile` (row stride `ld`
// elements, rows 16-byte aligned): lanes 0-15 address rows 0-15 at column
// 0, lanes 16-31 the same rows at column 8.
__device__ __forceinline__ void ldmatrix_a(uint32_t (&r)[4], const __nv_bfloat16* tile, int ld) {
  const int lane = threadIdx.x & 31;
  const unsigned s = static_cast<unsigned>(
      __cvta_generic_to_shared(tile + (lane & 15) * ld + (lane >> 4) * 8));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// B fragments of two 8-column tiles from the 16x16 block at `tile` of a
// row-major [k, n] matrix (row stride `ld`): r0, r1 = (b0, b1) of columns
// 0-7, r2, r3 = (b0, b1) of columns 8-15 (ldmatrix with transpose).
__device__ __forceinline__ void ldmatrix_b_trans(uint32_t (&r)[4], const __nv_bfloat16* tile,
                                                 int ld) {
  const int lane = threadIdx.x & 31;
  const unsigned s = static_cast<unsigned>(
      __cvta_generic_to_shared(tile + (lane & 15) * ld + (lane >> 4) * 8));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo -> low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace comorag
