// Encoder FFN half-layer for Hopper (sm_90a), bf16 in/out:
//   x1  = LN1(xres) -> bf16
//   mid = gelu_erf(x1 @ W1 + b1) -> bf16
//   out = LN2(x1 + (mid @ W2 + b2)) -> bf16
// with fp32 sums, fp32 bias, fp32 GELU and fp32 LayerNorms.
//
// Replaces: comorag_tpu/ops/pallas_ffn.py:112 fused_encoder_ffn (kernel
// _ffn_kernel :77). The rounding points are the TPU kernel's: x1 is cast
// to bf16 after LN1 (:80), mid before the second product (:88), and the
// residual is x1 + f (:92). GELU uses CUDA's erff; the TPU kernel's A&S
// polynomial (:57) exists only because Mosaic has no erf. The TPU kernel
// fused the whole half-layer to escape XLA's lowering of it
// (pallas_ffn.py:8-29), not for the bytes.
//
// What bounds it on the H100: the two products, 4*N*H*I FLOPs (309 GFLOP
// at N = 32768, H = 768, I = 3072), tensor-core work: ~0.31 ms at 989
// TFLOP/s against ~0.03 ms for the activations and weights in bf16. Only
// wgmma reaches that rate, and a wgmma tile needs 64 rows a warpgroup. A
// kernel that keeps the whole [rows, H] fp32 output of the second product
// in registers (the fused design) cannot hold 128-row tiles at H = 768 to
// 1024 (192-256 registers a thread), and with small row tiles every tile
// re-reads all the weights. The mid tensor it keeps off device memory is
// cheap on this card: 2 x 201 MB of bf16 at the shape above, ~0.12 ms at
// 3.35 TB/s, and 6.3 MB (in the 50 MB L2) at the slice's [1024, 768].
//
// What the design does about it: four launches on one stream.
// 1. ln1_rows: x1 = bf16(LN1(xres)), one warp a row.
// 2. gemm_kernel<GELU_BF16>: mid = bf16(gelu(x1 @ W1 + b1)).
// 3. gemm_kernel<PARTIAL_F32>: the fp32 sums of mid @ W2, one [N, H]
//    partial per split of the K (intermediate) dimension.
// 4. finish_rows: out = bf16(LN2(x1 + (sum of the partials + b2))), the
//    partials summed in split order (no atomics: the result does not change
//    from run to run), one warp a row.
// Both products are one GEMM template, C[M, N] = A[M, K] B[K, N] with A
// K-major (activations as they lie) and B MN-major (the weights' own [H, I]
// and [I, H] layouts, never transposed or copied): a persistent grid (one
// block an SM) walks 128 x 256 output tiles, each split into K slices of
// ffn_plan's choosing. One producer warp keeps a ring of four TMA stages
// in flight (128-byte swizzle, mbarriers; rows past M and columns past N
// land as zeros); two consumer warpgroups own 64 rows each and issue
// m64n128k16 wgmma products from shared memory, k-block after k-block,
// releasing each stage as soon as the products reading it are done;
// setmaxnreg moves the producer's registers to the consumers. The epilogue
// works on the fp32 accumulators in registers and stores rows < M and
// columns < N (mid as 16-byte rows of 8 bf16, after a transpose across
// each quad of lanes); the producer meanwhile fills the ring for the
// block's next tile. Measured on the H100 at [32768, 768] -> 3072: 256-
// column tiles beat 128 (0.84-0.89 vs 0.90 ms a call, both with 4-byte
// stores of mid); 4-byte stores cost GEMM1 a third more time than the
// 16-byte ones; consumers taking alternate tiles (ping-pong, one's
// epilogue beside the other's products) were level with this cooperative
// split and were dropped.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "tma_sm90.cuh"
#include "wgmma_sm90.cuh"

using namespace comorag;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 128;                 // output rows of a tile: two consumer warpgroups of 64
constexpr int BN = 256;                 // output columns of a tile
constexpr int BK = 64;                  // K of a ring stage: one 128-byte swizzle atom of bf16
constexpr int NH = BN / 128;            // m64n128k16 products a consumer issues a 16-deep step
constexpr int ATOM = 64 * 128;          // bytes of one [64 rows][64 bf16] swizzled box
constexpr int A_BYTES = BM * BK * 2;    // [BM rows][BK] of A, K-major
constexpr int B_BYTES = BK * BN * 2;    // BN / 64 boxes of [BK rows][64] of B, MN-major
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int STAGES = 4;
constexpr int OFF_BAR = STAGES * STAGE_BYTES;
constexpr int SMEM = OFF_BAR + 2 * STAGES * 8 + 1024;  // + alignment slack
constexpr int THREADS = 384;            // producer warpgroup + two consumers
// setmaxnreg: a thread starts with CAP registers (what the launch bounds
// leave, one block an SM); the producer keeps 40 and the consumers share
// the rest
constexpr int CAP = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = (CAP * THREADS - 128 * PRODUCER_REGS) / 256 / 8 * 8;
static_assert(SMEM <= 232448, "shared-memory plan exceeds a block's 227 KB");

enum Epilogue { GELU_BF16 = 0, PARTIAL_F32 = 1 };

struct GemmArgs {
  int M, N, K, splits;
  const float* bias;  // GELU_BF16: [N]
  void* out;          // GELU_BF16: bf16 [M, N]; PARTIAL_F32: fp32 [splits, M, N]
};

// A work item: output tile (m0, n0) over K blocks [kb0, kb1) of split s.
// Items walk the columns of a row tile first, so blocks running side by
// side share their A tile in L2.
struct Item {
  int m0, n0, s, kb0, kb1;
  __device__ Item(int w, int tm, int tn, int kbs, int splits) {
    n0 = (w % tn) * BN;
    m0 = ((w / tn) % tm) * BM;
    s = w / (tn * tm);
    kb0 = s * kbs / splits;
    kb1 = (s + 1) * kbs / splits;
  }
};

__device__ __forceinline__ float gelu_erf(float v) { return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f)); }

// Transpose of a 4 x 4 block among the four lanes of a quad: lane q holds
// a[j] = element (q, j) and ends with a[k] = element (k, q). Two steps of
// two shuffles: swap the off-diagonal 2 x 2 blocks (lanes q ^ 2), then the
// off-diagonal elements of each 2 x 2 block (lanes q ^ 1).
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int q) {
  const bool hi = q & 2, lo = q & 1;
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi ? a[0] : a[2], 2);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi ? a[1] : a[3], 2);
  if (hi) a[0] = r0, a[1] = r1;
  else a[2] = r0, a[3] = r1;
  const uint32_t e0 = __shfl_xor_sync(0xffffffffu, lo ? a[0] : a[1], 1);
  const uint32_t e1 = __shfl_xor_sync(0xffffffffu, lo ? a[2] : a[3], 1);
  if (lo) a[0] = e0, a[2] = e1;
  else a[1] = e0, a[3] = e1;
}

template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap, const GemmArgs g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;
  const int tm = (g.M + BM - 1) / BM, tn = (g.N + BN - 1) / BN, kbs = g.K / BK;
  const int items = tm * tn * g.splits;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    int it = 0;  // stages filled so far
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const Item u(w, tm, tn, kbs, g.splits);
      for (int kb = u.kb0; kb < u.kb1; ++kb, ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        unsigned char* st = smem + s * STAGE_BYTES;
        tma_load_2d(st, &amap, &full[s], kb * BK, u.m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) tma_load_2d(st + A_BYTES + j * ATOM, &bmap, &full[s], u.n0 + 64 * j, kb * BK);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const uint32_t base = smem_u32(smem);
  int it = 0;  // stages consumed so far
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Item u(w, tm, tn, kbs, g.splits);
    float acc[NH][64];
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    int prev = -1;
    for (int kb = u.kb0; kb < u.kb1; ++kb, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t a_addr = base + s * STAGE_BYTES + c * 64 * 128;  // this consumer's 64 rows
      const uint32_t b_addr = base + s * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t a = sw128_desc(a_addr + kk * 32, 16, 8 * 128);
#pragma unroll
        for (int h = 0; h < NH; ++h)
          wgmma_ss128_bmn(acc[h], a, sw128_desc(b_addr + 2 * h * ATOM + kk * 16 * 128, ATOM, 8 * 128), 1);
      }
      wgmma_commit();
      // the previous k-block's products are done: its stage goes back to the producer
      wgmma_wait<1>();
      if (prev >= 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    if (prev >= 0) mbar_arrive(&empty[prev]);

    const int row0 = u.m0 + c * 64 + warp * 16 + g8;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int col0 = u.n0 + 128 * h;  // N is a multiple of 128: a half is in or out whole
      if (col0 >= g.N) continue;
      if constexpr (EPI == GELU_BF16) {
        // bias + GELU, packed to bf16 pairs; four column groups at a time
        // are transposed across the quad, so each lane stores 8 columns (16
        // bytes) of one group and a warp's store covers 64 bytes of each of
        // its 8 rows
#pragma unroll
        for (int jb = 0; jb < 4; ++jb) {
          float2 b[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float2*>(g.bias + col0 + 8 * (4 * jb + j) + 2 * t4);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            uint32_t v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int i = 4 * (4 * jb + j) + 2 * r;
              v[j] = pack_bf16(gelu_erf(acc[h][i] + b[j].x), gelu_erf(acc[h][i + 1] + b[j].y));
            }
            quad_transpose(v, t4);
            const int row = row0 + 8 * r;
            if (row < g.M)
              *reinterpret_cast<uint4*>(static_cast<bf16*>(g.out) + (size_t)row * g.N + col0 + 8 * (4 * jb + t4)) =
                  make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
      } else {
        // fp32 pairs: a quad's store covers 32 bytes of a row
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = row0 + 8 * r;
            if (row < g.M)
              *reinterpret_cast<float2*>(static_cast<float*>(g.out) + ((size_t)u.s * g.M + row) * g.N + col0 + 8 * j +
                                         2 * t4) = make_float2(acc[h][4 * j + 2 * r], acc[h][4 * j + 2 * r + 1]);
          }
      }
    }
  }
}

// ---------------------------------------------------------- the row passes
// One warp a row; lane l holds columns 128q + 4l .. 128q + 4l + 3 of each
// 128-column slice q (8-byte bf16 and 16-byte fp32 accesses).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int H>
__device__ __forceinline__ void load_bf16_row(float (&v)[H / 32], const bf16* __restrict__ src, int lane) {
#pragma unroll
  for (int q = 0; q < H / 128; ++q) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src + 128 * q + 4 * lane);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[4 * q] = lo.x, v[4 * q + 1] = lo.y, v[4 * q + 2] = hi.x, v[4 * q + 3] = hi.y;
  }
}

template <int H>
__device__ __forceinline__ void store_bf16_row(bf16* __restrict__ dst, const float (&v)[H / 32], int lane) {
#pragma unroll
  for (int q = 0; q < H / 128; ++q)
    *reinterpret_cast<uint2*>(dst + 128 * q + 4 * lane) =
        make_uint2(pack_bf16(v[4 * q], v[4 * q + 1]), pack_bf16(v[4 * q + 2], v[4 * q + 3]));
}

// LayerNorm of one row, in pallas_ffn.py _ln's order:
// ((x - mean) * rsqrt(var + eps)) * s + b.
template <int H>
__device__ __forceinline__ void layer_norm_row(float (&v)[H / 32], const float* __restrict__ s,
                                               const float* __restrict__ b, float eps, int lane) {
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < H / 32; ++j) sum += v[j];
  const float mean = warp_sum(sum) / H;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < H / 32; ++j) {
    v[j] -= mean;
    sq += v[j] * v[j];
  }
  const float inv = rsqrtf(warp_sum(sq) / H + eps);
#pragma unroll
  for (int q = 0; q < H / 128; ++q) {
    const float4 sv = *reinterpret_cast<const float4*>(s + 128 * q + 4 * lane);
    const float4 bv = *reinterpret_cast<const float4*>(b + 128 * q + 4 * lane);
    v[4 * q] = v[4 * q] * inv * sv.x + bv.x;
    v[4 * q + 1] = v[4 * q + 1] * inv * sv.y + bv.y;
    v[4 * q + 2] = v[4 * q + 2] * inv * sv.z + bv.z;
    v[4 * q + 3] = v[4 * q + 3] * inv * sv.w + bv.w;
  }
}

// x1 = bf16(LN1(xres))
template <int H>
__global__ void __launch_bounds__(256)
ln1_rows(const bf16* __restrict__ x, const float* __restrict__ s1, const float* __restrict__ n1,
         bf16* __restrict__ x1, int M, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  float v[H / 32];
  load_bf16_row<H>(v, x + (size_t)row * H, lane);
  layer_norm_row<H>(v, s1, n1, eps, lane);
  store_bf16_row<H>(x1 + (size_t)row * H, v, lane);
}

// out = bf16(LN2(x1 + (f + b2))), f the partials summed in split order
template <int H>
__global__ void __launch_bounds__(256)
finish_rows(const bf16* __restrict__ x1, const float* __restrict__ part, const float* __restrict__ b2,
            const float* __restrict__ s2, const float* __restrict__ n2, bf16* __restrict__ out, int M,
            int splits, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  float v[H / 32];
  load_bf16_row<H>(v, x1 + (size_t)row * H, lane);
#pragma unroll
  for (int q = 0; q < H / 128; ++q) {
    const int col = 128 * q + 4 * lane;
    float4 f = *reinterpret_cast<const float4*>(part + (size_t)row * H + col);
    for (int sp = 1; sp < splits; ++sp) {
      const float4 p = *reinterpret_cast<const float4*>(part + ((size_t)sp * M + row) * H + col);
      f.x += p.x, f.y += p.y, f.z += p.z, f.w += p.w;
    }
    const float4 b = *reinterpret_cast<const float4*>(b2 + col);
    v[4 * q] += f.x + b.x;
    v[4 * q + 1] += f.y + b.y;
    v[4 * q + 2] += f.z + b.z;
    v[4 * q + 3] += f.w + b.w;
  }
  layer_norm_row<H>(v, s2, n2, eps, lane);
  store_bf16_row<H>(out + (size_t)row * H, v, lane);
}

// --------------------------------------------------------------- host side
// A map over a row-major bf16 [rows, cols] matrix, boxes of [box_rows][64]
// with 128-byte swizzle; reads past either edge fill zeros.
cudaError_t matrix_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box);
}

// Per device, once: both GEMM instantiations take their shared memory and
// were compiled to CAP registers (setmaxnreg.inc would wait forever if the
// block started with fewer than it hands round).
// Per device, once: both GEMM instantiations take their shared memory and
// were compiled to CAP registers (setmaxnreg.inc would wait forever if the
// block started with fewer than it hands round).
cudaError_t prepare(int device) {
  static bool ready[64] = {false};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (ready[device]) return cudaSuccess;
  const void* kernels[2] = {reinterpret_cast<const void*>(gemm_kernel<GELU_BF16>),
                            reinterpret_cast<const void*>(gemm_kernel<PARTIAL_F32>)};
  for (const void* k : kernels) {
    cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, k);
    if (err != cudaSuccess) return err;
    if (attr.numRegs != CAP) return cudaErrorInvalidConfiguration;
  }
  ready[device] = true;
  return cudaSuccess;
}

template <int EPI>
cudaError_t gemm(const void* a, const void* b, const GemmArgs& g, int sm_count, cudaStream_t stream) {
  CUtensorMap amap{}, bmap{};
  cudaError_t err = matrix_map(&amap, a, g.M, g.K, BM);
  if (err == cudaSuccess) err = matrix_map(&bmap, b, g.K, g.N, BK);
  if (err != cudaSuccess) return err;
  const long long items = (long long)((g.M + BM - 1) / BM) * ((g.N + BN - 1) / BN) * g.splits;
  if (items > (1ll << 31) - 1) return cudaErrorInvalidValue;
  const int grid = (int)(items < sm_count ? items : sm_count);
  gemm_kernel<EPI><<<grid, THREADS, SMEM, stream>>>(amap, bmap, g);
  return cudaGetLastError();
}

template <int H>
cudaError_t run(const void* x, const void* s1, const void* n1, const void* w1, const void* b1, const void* w2,
                const void* b2, const void* s2, const void* n2, void* out, void* x1, void* mid, void* part, int M,
                int I, int splits, float eps, int sm_count, cudaStream_t stream) {
  const int row_blocks = (M + 7) / 8;
  ln1_rows<H><<<row_blocks, 256, 0, stream>>>(static_cast<const bf16*>(x), static_cast<const float*>(s1),
                                              static_cast<const float*>(n1), static_cast<bf16*>(x1), M, eps);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = gemm<GELU_BF16>(x1, w1, GemmArgs{M, I, H, 1, static_cast<const float*>(b1), mid}, sm_count, stream);
  if (err == cudaSuccess)
    err = gemm<PARTIAL_F32>(mid, w2, GemmArgs{M, H, I, splits, nullptr, part}, sm_count, stream);
  if (err != cudaSuccess) return err;
  finish_rows<H><<<row_blocks, 256, 0, stream>>>(
      static_cast<const bf16*>(x1), static_cast<const float*>(part), static_cast<const float*>(b2),
      static_cast<const float*>(s2), static_cast<const float*>(n2), static_cast<bf16*>(out), M, splits, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* comorag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The GEMM's tile: 0 -> output rows, 1 -> output columns, 2 -> K of a
// stage (K splits fall on its multiples); -1 otherwise.
extern "C" int comorag_encoder_ffn_tile(int dim) {
  switch (dim) {
    case 0: return BM;
    case 1: return BN;
    case 2: return BK;
    default: return -1;
  }
}

// x, out, x1: [N, H] bf16; w1: [H, I] bf16; w2: [I, H] bf16; mid: [N, I]
// bf16; part: [splits, N, H] fp32; s1, n1, b2, s2, n2: [H] fp32; b1: [I]
// fp32; every pointer 16-byte aligned. H in {128, 256, ..., 1024}, I a
// multiple of 128, 1 <= splits <= I / 64 (split s holds K blocks [s * KB /
// splits, (s + 1) * KB / splits) of KB = I / 64). x1, mid and part are
// workspaces the call overwrites. sm_count: the persistent grid's blocks.
// Returns a cudaError_t (0 on success). Launches on `stream`, never syncs.
extern "C" int comorag_encoder_ffn_bf16(const void* x, const void* s1, const void* n1, const void* w1,
                                        const void* b1, const void* w2, const void* b2, const void* s2,
                                        const void* n2, void* out, void* x1, void* mid, void* part, int N, int H,
                                        int I, int splits, float eps, int sm_count, void* stream) {
  if (N <= 0 || I <= 0 || I % 128 != 0 || splits < 1 || splits > I / BK || sm_count <= 0)
    return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = prepare(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define COMORAG_FFN_RUN(h) \
  case h: return run<h>(x, s1, n1, w1, b1, w2, b2, s2, n2, out, x1, mid, part, N, I, splits, eps, sm_count, st)
  switch (H) {
    COMORAG_FFN_RUN(128);
    COMORAG_FFN_RUN(256);
    COMORAG_FFN_RUN(384);
    COMORAG_FFN_RUN(512);
    COMORAG_FFN_RUN(640);
    COMORAG_FFN_RUN(768);
    COMORAG_FFN_RUN(896);
    COMORAG_FFN_RUN(1024);
    default: return cudaErrorInvalidValue;
  }
#undef COMORAG_FFN_RUN
}
