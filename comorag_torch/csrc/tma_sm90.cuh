// Hopper copy-engine building blocks shared by the port's kernels: mbarrier
// waits and arrivals, TMA tensor and bulk copies into shared memory, and
// the host-side tensor-map encoder (taken from the driver at run time, so
// the libraries link against the CUDA runtime alone).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace comorag {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Waits until the barrier's phase differs from `parity`; traps after
// ~2^26 polls so that a broken pipeline fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 26)) __trap();
  }
}

// One TMA box of `map` at coordinates (c0 innermost, ...) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory by the copy engine, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Byte offset of (row r, byte b) in a box whose rows are 128 bytes,
// written by TMA with CU_TENSOR_MAP_SWIZZLE_128B (16-byte chunk index XOR
// r % 8; the box 1024-byte aligned)
__device__ __forceinline__ int swizzle128(int r, int b) { return r * 128 + ((((b >> 4) ^ (r & 7))) << 4) + (b & 15); }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                                       &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A tiled map with 128-byte swizzle (or `swizzle`) and zero fill out of
// bounds. dims and box innermost first; strides (bytes) of dims 1..rank-1
// (rank <= 4).
// Encoding costs microseconds of host time a call, so maps are kept in a
// table by (address, type, geometry): the caching allocator hands the same
// addresses back call after call. A decode step over a model axis of 4 on
// one card uses ~520 weight maps (the fused tail's 12 a layer), so the
// table has room for several times that.
inline cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                            CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  struct Key {
    const void* base;
    cuuint64_t dims[4], strides[3];
    cuuint32_t box[4];
    int type, rank, swizzle;
  };
  constexpr int SLOTS = 4096;
  static std::mutex mu;
  static Key keys[SLOTS];
  static CUtensorMap maps[SLOTS];
  static bool used[SLOTS];
  if (rank < 1 || rank > 4) return cudaErrorInvalidValue;
  Key key;
  memset(&key, 0, sizeof(key));
  key.base = base;
  key.type = static_cast<int>(type);
  key.rank = rank;
  key.swizzle = static_cast<int>(swizzle);
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i + 1 < rank) key.strides[i] = strides[i];
  }
  uint64_t h = 1469598103934665603ull;  // FNV-1a over the key's bytes
  for (size_t i = 0; i < sizeof(key); ++i) h = (h ^ reinterpret_cast<const unsigned char*>(&key)[i]) * 1099511628211ull;
  const int slot = static_cast<int>(h % SLOTS);
  {
    std::lock_guard<std::mutex> lock(mu);
    if (used[slot] && memcmp(&keys[slot], &key, sizeof(key)) == 0) {
      *map = maps[slot];
      return cudaSuccess;
    }
  }
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  keys[slot] = key;
  maps[slot] = *map;
  used[slot] = true;
  return cudaSuccess;
}

}  // namespace comorag
