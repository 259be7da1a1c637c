// Fused encoder FFN half-layer for Hopper (sm_90a), bf16 in/out:
//   x1  = LN1(xres) -> bf16
//   mid = gelu_erf(x1 @ W1 + b1) -> bf16
//   out = LN2(x1 + (mid @ W2 + b2)) -> bf16
// with fp32 accumulation, fp32 bias, fp32 GELU and fp32 LayerNorms.
//
// Replaces: comorag_tpu/ops/pallas_ffn.py:112 fused_encoder_ffn (kernel
// _ffn_kernel :77). The rounding points are the TPU kernel's: x1 is cast
// to bf16 after LN1 (:80), mid before the second product (:88), and the
// residual is x1 + f (:92). GELU uses CUDA's erff; the TPU kernel's A&S
// polynomial (:57) exists only because Mosaic has no erf.
//
// What bounds it on the H100: the two products are 4*N*H*I FLOPs (309
// GFLOP at N = 32768, H = 768, I = 3072), tensor-core work; what a plain
// implementation adds is the [N, I] mid tensor, written and read back in
// bf16 (2 x 201 MB at that shape), plus separate read/write passes for
// the bias, the GELU and both LayerNorms. A fused kernel trades those for
// re-reading the weights (9.4 MB at bert-base) once per row tile, and the
// row tile is capped by the [rows, H] fp32 accumulator that must stay in
// registers (32 rows x 768 = 96 registers per thread on 256 threads).
//
// What the design does about it: one block owns a 32-row tile (8 warps)
// or, where H divides by 192 as bert-base's 768 does, a 48-row tile (12
// warps), from LN1 to LN2. The intermediate dimension is walked in chunks
// of 128. Each warp computes a [16, 32] block of the chunk's [rows, 128]
// mid tile with mma.sync (ldmatrix operands), adds the bias and applies
// the GELU on its fp32 accumulator registers, and stores bf16 to shared
// memory; the chunk is then multiplied (WMMA) into the [rows, H] fp32
// output accumulator, which stays in registers (each warp owns H/warps
// columns of every row). No part of the mid tensor reaches device memory;
// activations are read and written once. The weights stream through a
// 3-stage cp.async ring of shared-memory tiles (W1: [128, 128], W2:
// [16, H]; rows padded by 16 bytes against bank conflicts), one barrier
// per tile. A block walks all of the intermediate dimension while the row
// tiles alone fill the card (N >= 132 x 48 rows at bert-base). Below
// that, as in the encoder's small index batches, each row tile's chunks
// are split over several blocks; they store fp32 partial products of the
// second GEMM to a workspace, and ffn_finish sums them, adds the
// residual and applies LN2. Measured on the H100: a deeper ring is no
// faster, and starting each block at a different chunk (so the SMs read
// different weight lines) is slower than all blocks reading the same tile
// at once. wgmma, TMA multicast of the weight tiles and larger row tiles
// are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <type_traits>

#include "mma_sm90.cuh"

using namespace nvcuda;
using namespace comorag;
using bf16 = __nv_bfloat16;

namespace {

constexpr int IC = 128;       // intermediate columns per chunk
constexpr int PAD = 8;        // bf16 elements (16 bytes) of row padding
constexpr int W1_KT = 128;    // W1 rows per staged tile ([W1_KT, IC])
constexpr int W2_KT = 16;     // W2 rows per staged tile ([W2_KT, H])
constexpr int STAGES = 3;
constexpr int LDM = IC + PAD;       // sMid and W1-tile row stride (bf16)

// TN rows per block, WARPS warps: each warp owns H / WARPS output columns
// of all TN rows (RF x NCF accumulator fragments) and one [16, 32] block
// of each [TN, 128] mid chunk.
template <int H_, int TN_, int WARPS_>
struct Layout {
  static constexpr int H = H_, TN = TN_, WARPS = WARPS_;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int ROWS_PER_WARP = TN / WARPS;
  static constexpr int RF = TN / 16;               // row fragments
  static constexpr int NCF = H / (16 * WARPS);     // output column fragments per warp
  static_assert(TN % 16 == 0 && TN % WARPS == 0 && H % (16 * WARPS) == 0, "tiling");
  static_assert(H % W1_KT == 0, "whole W1 tiles");
  static_assert(RF * (IC / 32) == WARPS, "one [16, 32] mid block per warp");
  static constexpr int LDX = H + PAD;  // sX1 and W2-tile row stride (bf16)
  static constexpr int N1 = H / W1_KT;  // W1 tiles per chunk
  static constexpr int N2 = IC / W2_KT;  // W2 tiles per chunk
  static constexpr int TILES = N1 + N2;
  static constexpr int STAGE_ELEMS = (W1_KT * LDM > W2_KT * LDX) ? W1_KT * LDM : W2_KT * LDX;
  static constexpr size_t X1_BYTES = (size_t)TN * LDX * sizeof(bf16);
  static constexpr size_t MID_BYTES = (size_t)TN * LDM * sizeof(bf16);
  static constexpr size_t RING_BYTES = (size_t)STAGES * STAGE_ELEMS * sizeof(bf16);
  static constexpr size_t LOOP_BYTES = RING_BYTES + MID_BYTES;
  static constexpr size_t F_BYTES = (size_t)TN * H * sizeof(float);  // epilogue, aliases the loop region
  static constexpr size_t SMEM = X1_BYTES + (LOOP_BYTES > F_BYTES ? LOOP_BYTES : F_BYTES);
  static_assert(SMEM <= 232448, "shared-memory plan exceeds a block's 227 KB");
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of one row held as H/32 values per lane (column lane + 32*j),
// in pallas_ffn.py _ln's order: ((x - mean) * rsqrt(var + eps)) * s + b.
template <int H>
__device__ __forceinline__ void layer_norm_row(float (&vals)[H / 32], const float* __restrict__ s,
                                               const float* __restrict__ bias, float eps, int lane) {
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < H / 32; ++j) sum += vals[j];
  const float mean = warp_sum(sum) / H;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < H / 32; ++j) {
    vals[j] -= mean;
    sq += vals[j] * vals[j];
  }
  const float inv = rsqrtf(warp_sum(sq) / H + eps);
#pragma unroll
  for (int j = 0; j < H / 32; ++j) {
    const int c = lane + 32 * j;
    vals[j] = vals[j] * inv * s[c] + bias[c];
  }
}

// Issue the cp.async copies of weight tile g (chunk c_first + g / TILES;
// W1 tiles first, then W2 tiles) into `buf`, and always commit a group so
// the wait counts stay uniform past the last tile.
template <class L>
__device__ __forceinline__ void load_tile(bf16* buf, const bf16* __restrict__ w1,
                                          const bf16* __restrict__ w2, int g, int total, int I,
                                          int c_first) {
  constexpr int H = L::H, THREADS = L::THREADS;
  if (g < total) {
    const int c0 = (c_first + g / L::TILES) * IC;
    const int t = g % L::TILES;
    if (t < L::N1) {
      for (int i = threadIdx.x; i < W1_KT * (IC / 8); i += THREADS) {
        const int r = i / (IC / 8), v = i % (IC / 8);
        cp_async16(buf + r * LDM + v * 8, w1 + (size_t)(t * W1_KT + r) * I + c0 + v * 8);
      }
    } else {
      const int r0 = c0 + (t - L::N1) * W2_KT;
      for (int i = threadIdx.x; i < W2_KT * (H / 8); i += THREADS) {
        const int r = i / (H / 8), v = i % (H / 8);
        cp_async16(buf + r * L::LDX + v * 8, w2 + (size_t)(r0 + r) * H + v * 8);
      }
    }
  }
  cp_async_commit();
}

template <class L>
__global__ void __launch_bounds__(L::THREADS)
ffn_kernel(const bf16* __restrict__ x, const float* __restrict__ s1, const float* __restrict__ n1,
           const bf16* __restrict__ w1, const float* __restrict__ b1, const bf16* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ s2,
           const float* __restrict__ n2, bf16* __restrict__ out, float* __restrict__ part,
           int N, int I, int splits, float eps) {
  constexpr int H = L::H, TN = L::TN, RF = L::RF, NCF = L::NCF;
  constexpr int ROWS_PER_WARP = L::ROWS_PER_WARP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX1 = reinterpret_cast<bf16*>(smem);                                 // [TN, LDX]
  bf16* ring = reinterpret_cast<bf16*>(smem + L::X1_BYTES);                  // STAGES tiles
  bf16* sMid = reinterpret_cast<bf16*>(smem + L::X1_BYTES + L::RING_BYTES);  // [TN, LDM]
  float* sF = reinterpret_cast<float*>(smem + L::X1_BYTES);                  // [TN, H], after the loop

  const int r0 = blockIdx.x * TN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // this block's share of the intermediate chunks (all of them unless split)
  const int c_first = blockIdx.y * (I / IC) / splits;
  const int total = ((blockIdx.y + 1) * (I / IC) / splits - c_first) * L::TILES;

  // the first weight tiles fly while LN1 runs
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    load_tile<L>(ring + s * L::STAGE_ELEMS, w1, w2, s, total, I, c_first);

  // LN1 -> x1 (bf16); rows past N are zeros and are never stored
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    const int row = r0 + r;
    float vals[H / 32];
    if (row < N) {
#pragma unroll
      for (int j = 0; j < H / 32; ++j) vals[j] = __bfloat162float(x[(size_t)row * H + lane + 32 * j]);
      layer_norm_row<H>(vals, s1, n1, eps, lane);
    } else {
#pragma unroll
      for (int j = 0; j < H / 32; ++j) vals[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < H / 32; ++j) sX1[r * L::LDX + lane + 32 * j] = __float2bfloat16(vals[j]);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> facc[RF][NCF];
#pragma unroll
  for (int i = 0; i < RF; ++i)
#pragma unroll
    for (int j = 0; j < NCF; ++j) wmma::fill_fragment(facc[i][j], 0.0f);
  float macc[4][4];                        // mid [16, 32]: four m16n8 tiles
  const int mrow = (warp / (IC / 32)) * 16;  // this warp's mid block: rows mrow..+16,
  const int mcol = (warp % (IC / 32)) * 32;  // columns mcol..+32
  const int g8 = lane >> 2, t4 = lane & 3;   // mma fragment row group / column pair

  for (int g = 0; g < total; ++g) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile g landed for everyone; tile g-1's buffer is free
    load_tile<L>(ring + ((g + STAGES - 1) % STAGES) * L::STAGE_ELEMS, w1, w2,
                 g + STAGES - 1, total, I, c_first);
    const bf16* tile = ring + (g % STAGES) * L::STAGE_ELEMS;
    const int c0 = (c_first + g / L::TILES) * IC;
    const int t = g % L::TILES;
    if (t < L::N1) {
      // mid[mrow.., mcol.. + 32] += x1[mrow.., t*W1_KT : (t+1)*W1_KT] @ W1 tile
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) macc[j][0] = macc[j][1] = macc[j][2] = macc[j][3] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < W1_KT; kk += 16) {
        uint32_t a[4];
        ldmatrix_a(a, sX1 + mrow * L::LDX + t * W1_KT + kk, L::LDX);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t b[4];
          ldmatrix_b_trans(b, tile + kk * LDM + mcol + 16 * i, LDM);
          mma_bf16(macc[2 * i], a, b[0], b[1]);
          mma_bf16(macc[2 * i + 1], a, b[2], b[3]);
        }
      }
      if (t == L::N1 - 1) {
        // bias + GELU on the accumulators, cast to bf16 into sMid; the
        // barrier at the top of the next tile orders these writes before
        // the W2 tiles read them
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = mcol + 8 * j + 2 * t4;
          const float bias0 = b1[c0 + c], bias1 = b1[c0 + c + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float m0 = macc[j][2 * h] + bias0, m1 = macc[j][2 * h + 1] + bias1;
            *reinterpret_cast<uint32_t*>(sMid + (mrow + g8 + 8 * h) * LDM + c) =
                pack_bf16(0.5f * m0 * (1.0f + erff(m0 * 0.70710678118654752f)),
                          0.5f * m1 * (1.0f + erff(m1 * 0.70710678118654752f)));
          }
        }
      }
    } else {
      // f[:, this warp's columns] += mid[:, 16tt : 16tt + 16] @ W2 tile
      const int tt = t - L::N1;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[RF];
#pragma unroll
      for (int i = 0; i < RF; ++i) wmma::load_matrix_sync(a[i], sMid + i * 16 * LDM + tt * W2_KT, LDM);
#pragma unroll
      for (int j = 0; j < NCF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
        wmma::load_matrix_sync(bw, tile + (warp * NCF + j) * 16, L::LDX);
#pragma unroll
        for (int i = 0; i < RF; ++i) wmma::mma_sync(facc[i][j], a[i], bw, facc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  if (splits > 1) {
    // a partial f over this block's chunks: ffn_finish sums the splits
    float* dst = part + ((size_t)blockIdx.y * gridDim.x * TN + r0) * H;
#pragma unroll
    for (int j = 0; j < NCF; ++j)
#pragma unroll
      for (int i = 0; i < RF; ++i)
        wmma::store_matrix_sync(dst + i * 16 * H + (warp * NCF + j) * 16, facc[i][j], H,
                                wmma::mem_row_major);
    return;
  }
  __syncthreads();  // the ring and mid buffers become sF

#pragma unroll
  for (int j = 0; j < NCF; ++j) {
    const int col = (warp * NCF + j) * 16;
#pragma unroll
    for (int i = 0; i < RF; ++i)
      wmma::store_matrix_sync(sF + i * 16 * H + col, facc[i][j], H, wmma::mem_row_major);
  }
  __syncthreads();

  // out = LN2(x1 + (f + b2))
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    const int row = r0 + r;
    if (row >= N) break;
    float vals[H / 32];
#pragma unroll
    for (int j = 0; j < H / 32; ++j) {
      const int c = lane + 32 * j;
      vals[j] = __bfloat162float(sX1[r * L::LDX + c]) + (sF[r * H + c] + b2[c]);
    }
    layer_norm_row<H>(vals, s2, n2, eps, lane);
#pragma unroll
    for (int j = 0; j < H / 32; ++j) out[(size_t)row * H + lane + 32 * j] = __float2bfloat16(vals[j]);
  }
}

// Split path, second pass: out = LN2(x1 + (sum of the partial f + b2)),
// one warp per row, x1 recomputed from xres exactly as ffn_kernel does.
template <int H>
__global__ void __launch_bounds__(256)
ffn_finish(const bf16* __restrict__ x, const float* __restrict__ s1, const float* __restrict__ n1,
           const float* __restrict__ part, const float* __restrict__ b2,
           const float* __restrict__ s2, const float* __restrict__ n2, bf16* __restrict__ out,
           int N, int n_pad, int splits, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= N) return;
  float vals[H / 32];
#pragma unroll
  for (int j = 0; j < H / 32; ++j) vals[j] = __bfloat162float(x[(size_t)row * H + lane + 32 * j]);
  layer_norm_row<H>(vals, s1, n1, eps, lane);
#pragma unroll
  for (int j = 0; j < H / 32; ++j) {
    const int c = lane + 32 * j;
    float f = 0.0f;
    for (int sp = 0; sp < splits; ++sp) f += part[((size_t)sp * n_pad + row) * H + c];
    vals[j] = __bfloat162float(__float2bfloat16(vals[j])) + (f + b2[c]);
  }
  layer_norm_row<H>(vals, s2, n2, eps, lane);
#pragma unroll
  for (int j = 0; j < H / 32; ++j) out[(size_t)row * H + lane + 32 * j] = __float2bfloat16(vals[j]);
}

// 48-row tiles on 12 warps where H divides by 12 warps x 16 columns
// (bert-base's 768): 1.5x the weight reuse of 32 rows, with the [48, H]
// accumulator spread over 384 threads (~100 registers each); 32-row tiles
// on 8 warps elsewhere.
template <int H>
using LayoutFor =
    typename std::conditional<H % 192 == 0, Layout<H, 48, 12>, Layout<H, 32, 8>>::type;

// Splits of the intermediate dimension: a block walks all of it while the
// row tiles alone fill the card; below that (the encoder's small batches:
// 32 texts x 32 tokens are 22 row tiles for 132 SMs) the chunks are split
// over up to sm_count / tiles blocks per row tile, whose partial f sums go
// through an fp32 workspace to ffn_finish.
template <class L>
int splits_for(int N, int I, int sm_count) {
  const int tiles = (N + L::TN - 1) / L::TN, chunks = I / IC;
  const int s = tiles >= sm_count ? 1 : sm_count / tiles;
  return s > chunks ? chunks : s;
}

template <class L>
long long workspace_bytes(int N, int I, int sm_count) {
  const int splits = splits_for<L>(N, I, sm_count);
  const long long n_pad = (long long)((N + L::TN - 1) / L::TN) * L::TN;
  return splits > 1 ? splits * n_pad * L::H * (long long)sizeof(float) : 0;
}

template <class L>
int launch(const void* x, const void* s1, const void* n1, const void* w1, const void* b1,
           const void* w2, const void* b2, const void* s2, const void* n2, void* out,
           void* workspace, int N, int I, float eps, int sm_count, cudaStream_t stream) {
  constexpr int H = L::H;
  const int tiles = (N + L::TN - 1) / L::TN;
  const int splits = splits_for<L>(N, I, sm_count);
  if (splits > 1 && workspace == nullptr) return cudaErrorInvalidValue;
  const size_t smem = L::SMEM;
  cudaError_t err = cudaFuncSetAttribute(ffn_kernel<L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ffn_kernel<L><<<dim3(tiles, splits), L::THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(s1), static_cast<const float*>(n1),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(s2), static_cast<const float*>(n2),
      static_cast<bf16*>(out), static_cast<float*>(workspace), N, I, splits, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  ffn_finish<H><<<(N + 7) / 8, 256, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(s1), static_cast<const float*>(n1),
      static_cast<const float*>(workspace), static_cast<const float*>(b2),
      static_cast<const float*>(s2), static_cast<const float*>(n2), static_cast<bf16*>(out), N,
      tiles * L::TN, splits, eps);
  return cudaGetLastError();
}

// f(LayoutFor<H>{}) for a supported hidden size H; `bad` otherwise.
template <class F>
long long with_layout(int H, long long bad, F&& f) {
  switch (H) {
    case 128: return f(LayoutFor<128>{});
    case 256: return f(LayoutFor<256>{});
    case 384: return f(LayoutFor<384>{});
    case 512: return f(LayoutFor<512>{});
    case 640: return f(LayoutFor<640>{});
    case 768: return f(LayoutFor<768>{});
    case 896: return f(LayoutFor<896>{});
    case 1024: return f(LayoutFor<1024>{});
    default: return bad;
  }
}

}  // namespace

extern "C" const char* comorag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of fp32 workspace a call with these sizes needs (0: none), or -1
// for sizes the kernel does not take. sm_count: the card's SM count.
extern "C" long long comorag_encoder_ffn_workspace_bytes(int N, int H, int I, int sm_count) {
  if (N <= 0 || I <= 0 || I % IC != 0 || sm_count <= 0) return -1;
  return with_layout(H, -1, [&](auto l) { return workspace_bytes<decltype(l)>(N, I, sm_count); });
}

// x, out: [N, H] bf16; w1: [H, I] bf16; w2: [I, H] bf16; s1, n1, b2, s2, n2:
// [H] fp32; b1: [I] fp32. H in {128, 256, ..., 1024}, I a multiple of 128;
// w1 and w2 16-byte aligned; workspace: as many bytes as
// comorag_encoder_ffn_workspace_bytes says (32-byte aligned; may be null
// when that is 0). Returns a cudaError_t (0 on success). Launches on
// `stream`, never syncs.
extern "C" int comorag_encoder_ffn_bf16(const void* x, const void* s1, const void* n1,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* b2, const void* s2, const void* n2,
                                        void* out, void* workspace, int N, int H, int I,
                                        float eps, int sm_count, void* stream) {
  if (N <= 0 || I <= 0 || I % IC != 0 || sm_count <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_layout(H, cudaErrorInvalidValue, [&](auto l) {
    return (long long)launch<decltype(l)>(x, s1, n1, w1, b1, w2, b2, s2, n2, out, workspace, N, I,
                                          eps, sm_count, st);
  }));
}
