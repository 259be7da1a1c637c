// int4 weight products for Hopper (sm_90a): the decoder's nibble-packed
// weights, unpacked in registers and multiplied on the tensor cores.
//
// Replaces: comorag_tpu/ops/pallas_int4.py:132 int4_matmul (kernel
// _make_int4_kernel :91) and comorag_tpu/ops/pallas_int4.py:365
// int4_fused_layer_tail (kernel _make_fused_tail_kernel :251).
//
// Layout (pallas_int4.py quantize_int4_grouped): W [K, N] is stored as
// packed [K/2, N] int8 with byte[r] = (w[2r+1] << 4) | (w[2r] & 0xF), and
// fp32 scales [K/gs, N], one per (group of gs inputs, output column). The
// arithmetic is the TPU kernel's: x rounded to bf16, each group's partial
// product summed in fp32, multiplied by the group's scale row and added
// to the running fp32 sum.
//
// What bounds it on the H100: at decode (M <= 64 rows) the weight bytes,
// 0.5 per element plus the scales (13.4 MB for Llama-3.1-8B's qkv, 279 MB
// for its lm_head, 3.35 TB/s); at prefill (M = B x 512) the products,
// 2*M*K*N operations at the bf16 tensor-core rate.
//
// int4_matmul has three routes, chosen by shape in ops/int4.int4_matmul:
// - decode, M <= 64 and each block's width a multiple of 16: one stage of
//   the fused tail's split-K streaming code below (splitk::product_kernel,
//   an ordinary launch over a persistent grid): work items of two
//   128-column boxes side by side (256-byte runs of each packed row:
//   128-byte runs, rows N bytes apart, streamed at a third of the card's
//   rate), laid out block by block (a block's last item holds its ragged
//   rest, any multiple of 16 columns up to 240: TMA fills the part of a
//   box past the block's edge with zeros, and the stores stop at the
//   edge; a block narrower than a box is one such item), split along K
//   on scale-group boundaries (ops/int4.matmul_plan), TMA boxes in a ring
//   on mbarriers, the weights as the m16n8k16 A operand and the tokens as
//   its 8-wide N (W^T x^T), the exact nibble unpack, fp32 partials summed
//   in split order by the tile's last split to arrive (at one split the
//   sums go to out directly);
// - prefill, M > 64 and each block's width a multiple of 16:
//   prefill::matmul_kernel, a warp-specialized persistent kernel on wgmma.
//   Still W^T x^T: an output tile is out^T [128 columns][128 tokens],
//   tiled block by block (a block's last tile holds its ragged rest, any
//   multiple of 16 columns: TMA fills the packed box past the block's edge
//   with zeros, the scale copy and the stores stop at the edge; no K
//   split, so a column's sum is the same in any tile). One producer
//   thread keeps a ring of TMA stages in flight (x's [128 tokens][64
//   inputs] box, the
//   packed [32 rows][128 bytes] box, the scale row); two consumer
//   warpgroups own 64 columns each and issue m64n128k16 wgmma with the
//   weights as the register operand (a lane's two columns are one 16-bit
//   element of a packed row: one ldmatrix.trans gives a lane its bytes of
//   a whole stage) and x as the K-major shared-memory operand. Scale
//   groups alternate between two accumulators: group j is folded into the
//   running sum, times its scales, beside group j + 1's first products.
//   Each stage's products are waited for before the next stage's A
//   registers are written (wgmma reads them asynchronously), with the
//   next stage's bytes already loaded; setmaxnreg moves the producer's
//   registers to the consumers; the epilogue stages out^T through shared
//   memory for 16-byte row stores;
// - every other shape (N no multiple of 16, e.g. a 259-token
//   vocabulary): the first design, int4_matmul_kernel. A block owns a
//   [BM, BN] output tile and walks K in slabs of 64 through a cp.async
//   ring (the x rows as bf16, the packed bytes as they are); the
//   m16n8k16 B fragment of a lane, (k 2t, 2t+1; n g) and (k 2t+8, 2t+9;
//   n g), is exactly the two nibbles of packed bytes (t, g) and (t+4, g).
//   Tiles: 16 x 64 for M <= 16, 64 x 64 up to 64 rows, 128 x 128 above;
//   mma.sync, no split of K.
// The split-K and wgmma routes take the weight whole or as up to
// splitk::MAX_BLOCKS (8) column blocks (a `model` axis's shards, up to
// an 8-card node's): each block has its own tensor map and scale
// pointer; both routes tile each block on its own (a split-K item and a
// wgmma tile lie in one block, the last of a block ragged), so one launch
// reads the shards in place with the whole weight's sums (bit-equal
// output at the same K splits; wgmma has none). A block may lie on the
// launching card or on a peer card (a `model` axis over distinct cards, after
// comorag_enable_peer_access), as in the fused tail below: the split-K
// PRODUCT stage and prefill::matmul_kernel's producer read it through the
// same tensor map and scale bulk copies, over NVLink, with the same items
// and sums as the blocks on one card. The wgmma route reads each weight
// box once a 128-token tile, and a peer's box crosses NVLink each time:
// gate/up at M = 4,096 over blocks on 4 H100s (700 W) took ~2.1x the
// same blocks on one card, ~350 GB/s over NVLink (chip_smoke.py phase 21a).

// The fused layer tail, x_res + FFN(RMSNorm(x_res + ctx @ O)), is one
// cooperative launch (the TPU kernel exists to be one invocation instead
// of three). At decode it is bound by its weight bytes (~102 MB of packed
// weights and scales per call at Llama-3.1-8B width, 30.7 us at 3.35
// TB/s), so its design is about keeping every SM's memory pipe full:
// - split-K: a work item is (a tile of up to 128 columns, K split) and a
//   split is a run of whole scale groups; ops/int4.tail_plan picks the split count
//   that gives every block an item at the least cost. fp32 partials go to
//   a workspace, and the tile's last split to arrive (an integer ticket)
//   sums them in split order, adding x_res (o) or xmid (down), so the
//   result is deterministic (no float atomics);
// - gate and up are read in one K walk and act(gate) * up formed where
//   their sums meet;
// - the copy engine moves the bytes: one thread a block issues each
//   64-input step as TMA boxes (the packed rows [32][128 bytes], 128-byte
//   swizzled; the activations [tokens][64] bf16, rows past M zero) and a
//   bulk copy of the scale row, into a ring of 7-10 stages completed on
//   mbarriers that runs across item boundaries. Small copies do not do:
//   512-byte bulk copies measured ~40 ns each per SM;
// - a persistent grid of two blocks of 4 warps an SM up to 32 tokens (one
//   warp per scheduler leaves the unpack and product chain exposed), one
//   of 8 warps above;
// - the product is W^T x^T: weights are the m16n8k16 A operand (16 output
//   columns a tile) and the tokens its 8-wide N, so M = 8 wastes no
//   tensor-core rows; a lane reads whole 32-bit words of the JAX packing
//   (4 adjacent columns of one packed row) and turns each byte into a
//   bf16 pair with one PRMT, one LOP3 and one HSUB2 (nibble_pair), exact.
// - each weight may arrive as up to MAX_BLOCKS (8) column blocks (a
//   `model` axis's shards on one device, the TP decode path): a block has
//   its own tensor map and scale pointer, passed by value in the
//   kernel's parameters (5 KB at 8 blocks: past the 4 KB of toolkits
//   before 12.1). The o and down stages tile each block on its own, the
//   last tile of a block ragged (blocks of any multiple of 16 columns:
//   Qwen2.5-7B's 448 over an 8-card axis), as int4_matmul's split-K
//   route does; gate/up's item pairs a gate box with its up box I
//   columns on, and takes blocks of a multiple of 128. The sums of
//   squares behind the RMSNorm are one partial per 16 columns by global
//   column, summed in an order that H alone sets. So the shards are read
//   in place, in one launch, with the whole weight's splits and sums
//   (bit-equal output). A
//   block may also lie on a peer card of the launching one (a `model` axis
//   over distinct cards, after comorag_enable_peer_access): its tensor
//   map and scale copies address it in the unified address space, so the
//   TMA boxes and bulk copies read it over NVLink, in place, into the
//   same ring, with the same items and sums (bit-equal to the blocks on
//   one card). Over 4 cards 3/4 of the weight bytes cross NVLink (450
//   GB/s into a card against 3.35 TB/s from its own memory), so that is
//   the bound there; nothing is copied to the launching card first.
//   int4_matmul's split-K route runs this stage code as its PRODUCT
//   stage, and so reads a peer card's blocks the same way.
// The rounding points are the TPU kernel's: ctx -> bf16, xmid and the
// norm in fp32, xn -> bf16, gate/up in fp32, h -> bf16, down in fp32 plus
// xmid. Grid-wide barriers separate the o product, the RMSNorm, gate/up
// and down.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"
#include "tma_sm90.cuh"
#include "wgmma_sm90.cuh"

// splitk::Args, the fused tail's and the split-K product's parameters, holds
// 36 tensor maps at 8 column blocks a weight: kernel parameters past 4 KB,
// which CUDA 12.1 and later take on Volta and newer (up to 32,764 bytes)
#if CUDART_VERSION < 12010
#error "csrc/int4.cu needs CUDA 12.1 or later (kernel parameters past 4 KB)"
#endif

namespace cg = cooperative_groups;
using namespace comorag;
using bf16 = __nv_bfloat16;

namespace {

constexpr int KT = 64;         // K values per staged slab (a group holds gs / KT slabs)
constexpr int XLD = KT + 8;    // x stage row stride in bf16 (16 bytes of padding)

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int STAGES_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int STAGES = STAGES_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MF = WM / 16, NF = WN / 8;
  static constexpr int PLD = BN + 16;  // packed stage row stride in bytes
  static constexpr int X_BYTES = BM * XLD * 2;
  static constexpr int P_BYTES = (KT / 2) * PLD;
  static constexpr int STAGE_BYTES = X_BYTES + P_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BN % 16 == 0, "tiling");
  static_assert(X_BYTES % 16 == 0 && P_BYTES % 16 == 0, "stage alignment");
};

using CfgDecode = Cfg<16, 64, 1, 4, 4>;     // M <= 16
using CfgMid = Cfg<64, 64, 2, 2, 4>;        // 16 < M <= 64
using CfgPrefill = Cfg<128, 128, 2, 4, 3>;  // M > 64

// The two nibbles of one packed byte as a bf16 pair: low nibble (the even
// input row) in the low half, both sign-extended from 4 bits.
__device__ __forceinline__ uint32_t nibbles_bf16(uint8_t b) {
  const int v = static_cast<int>(static_cast<int8_t>(b));
  const int lo = ((v & 15) ^ 8) - 8;
  const int hi = v >> 4;
  return pack_bf16(static_cast<float>(lo), static_cast<float>(hi));
}

// Copies slab j (x rows m0.. of K columns j*KT.., packed rows j*KT/2.. of
// columns n0..) into one stage; rows past M and columns past N are zeros.
template <class C>
__device__ __forceinline__ void load_stage(unsigned char* stage, const bf16* __restrict__ A, int M,
                                           int K, int m0, const int8_t* __restrict__ P, int N,
                                           int n0, int j, bool vec_n) {
  bf16* xs = reinterpret_cast<bf16*>(stage);
  for (int i = threadIdx.x; i < C::BM * (KT / 8); i += C::THREADS) {
    const int r = i / (KT / 8), v = i % (KT / 8);
    bf16* dst = xs + r * XLD + v * 8;
    if (m0 + r < M)
      cp_async16(dst, A + (size_t)(m0 + r) * K + j * KT + v * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  int8_t* ps = reinterpret_cast<int8_t*>(stage + C::X_BYTES);
  for (int i = threadIdx.x; i < (KT / 2) * (C::BN / 16); i += C::THREADS) {
    const int r = i / (C::BN / 16), v = i % (C::BN / 16);
    const int col = n0 + v * 16;
    int8_t* dst = ps + r * C::PLD + v * 16;
    const int8_t* src = P + (size_t)(j * (KT / 2) + r) * N + col;
    if (vec_n && col + 16 <= N) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b) dst[b] = (col + b < N) ? src[b] : static_cast<int8_t>(0);
    }
  }
}

// acc (this warp's fragments of the [BM, BN] tile at (m0, n0)) +=
// sum over groups of (x_g @ W_g) * scale_g, as the TPU kernel orders it.
template <class C>
__device__ __forceinline__ void tile_mma(const bf16* __restrict__ A, int M, int K,
                                         const int8_t* __restrict__ P,
                                         const float* __restrict__ S, int N, int gs, int m0,
                                         int n0, bool vec_n, float (&acc)[C::MF][C::NF][4],
                                         unsigned char* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int slabs = K / KT, spg = gs / KT;
  float gacc[C::MF][C::NF][4];
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int n = 0; n < C::NF; ++n) gacc[i][n][0] = gacc[i][n][1] = gacc[i][n][2] = gacc[i][n][3] = 0.f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < slabs) load_stage<C>(smem + s * C::STAGE_BYTES, A, M, K, m0, P, N, n0, s, vec_n);
    cp_async_commit();
  }
  for (int j = 0; j < slabs; ++j) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // slab j landed for everyone; slab j-1's stage is free
    const int jn = j + C::STAGES - 1;
    if (jn < slabs)
      load_stage<C>(smem + (jn % C::STAGES) * C::STAGE_BYTES, A, M, K, m0, P, N, n0, jn, vec_n);
    cp_async_commit();
    const unsigned char* stage = smem + (j % C::STAGES) * C::STAGE_BYTES;
    const bf16* xs = reinterpret_cast<const bf16*>(stage);
    const uint8_t* ps = stage + C::X_BYTES;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      uint32_t a[C::MF][4];
#pragma unroll
      for (int i = 0; i < C::MF; ++i) ldmatrix_a(a[i], xs + (wm * C::WM + i * 16) * XLD + kk, XLD);
#pragma unroll
      for (int n = 0; n < C::NF; ++n) {
        const int col = wn * C::WN + n * 8 + g8;
        const uint32_t b0 = nibbles_bf16(ps[(kk / 2 + t4) * C::PLD + col]);
        const uint32_t b1 = nibbles_bf16(ps[(kk / 2 + 4 + t4) * C::PLD + col]);
#pragma unroll
        for (int i = 0; i < C::MF; ++i) mma_bf16(gacc[i][n], a[i], b0, b1);
      }
    }
    if ((j + 1) % spg == 0) {
      const float* srow = S + (size_t)(j / spg) * N;
#pragma unroll
      for (int n = 0; n < C::NF; ++n) {
        const int col = n0 + wn * C::WN + n * 8 + 2 * t4;
        const float s0 = col < N ? __ldg(srow + col) : 0.f;
        const float s1 = col + 1 < N ? __ldg(srow + col + 1) : 0.f;
#pragma unroll
        for (int i = 0; i < C::MF; ++i) {
          acc[i][n][0] += gacc[i][n][0] * s0;
          acc[i][n][1] += gacc[i][n][1] * s1;
          acc[i][n][2] += gacc[i][n][2] * s0;
          acc[i][n][3] += gacc[i][n][3] * s1;
          gacc[i][n][0] = gacc[i][n][1] = gacc[i][n][2] = gacc[i][n][3] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring before it is refilled
}

template <class C>
__device__ __forceinline__ void zero(float (&acc)[C::MF][C::NF][4]) {
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int n = 0; n < C::NF; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
}

// Calls f(row, col, v0, v1) for the two horizontally adjacent outputs
// (row, col), (row, col + 1) of each accumulator pair this lane holds.
template <class C, class F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[C::MF][C::NF][4], int m0, int n0,
                                              F&& f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int n = 0; n < C::NF; ++n) {
      const int row = m0 + wm * C::WM + i * 16 + g8;
      const int col = n0 + wn * C::WN + n * 8 + 2 * t4;
      f(row, col, acc[i][n][0], acc[i][n][1]);
      f(row + 8, col, acc[i][n][2], acc[i][n][3]);
    }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS)
int4_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ P,
                   const float* __restrict__ S, float* __restrict__ out, int M, int N, int K,
                   int gs, int vec_n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  float acc[C::MF][C::NF][4];
  zero<C>(acc);
  tile_mma<C>(x, M, K, P, S, N, gs, m0, n0, vec_n != 0, acc, smem);
  for_each_pair<C>(acc, m0, n0, [&](int row, int col, float v0, float v1) {
    if (row >= M) return;
    float* o = out + (size_t)row * N + col;
    if (col + 1 < N && (N % 2) == 0) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      if (col < N) o[0] = v0;
      if (col + 1 < N) o[1] = v1;
    }
  });
}

template <class C>
int launch_matmul(const void* x, const void* packed, const void* scales, void* out, int M, int N,
                  int K, int gs, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(int4_matmul_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int vec_n = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(packed) % 16 == 0);
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  int4_matmul_kernel<C><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scales), static_cast<float*>(out), M, N, K, gs, vec_n);
  return cudaGetLastError();
}

__device__ __forceinline__ float activation(float g, int act) {
  if (act == 0) return g / (1.f + expf(-g));  // silu = g * sigmoid(g)
  if (act == 1) {                              // gelu, tanh approximation
    const float c = 0.7978845608028654f;       // sqrt(2 / pi)
    return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
  }
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));  // exact gelu
}

// ------------------------------------------------------------- fused tail
namespace splitk {

constexpr int KS = 64;                // inputs per pipeline step (one step never straddles a group)
constexpr int BN = 128;               // output columns per work item (gate/up: 128 of each)
constexpr int BOX = (KS / 2) * BN;    // one packed-weight TMA box: 32 rows x 128 bytes
constexpr int MAX_TOKENS = 64;

// NT token tiles of 8 per warp, WT warps along the tokens, 4 warps of 32
// columns along the 128-column tile; STAGES steps in the ring. A stage
// holds the step's x box ([MP tokens][64 inputs] bf16, rows past M read
// as zeros), up to two packed-weight boxes (gate and up; a product item's
// two) and their scale rows, the boxes 128-byte swizzled by TMA.
template <int NT_, int WT_, int STAGES_, int BLOCKS_>
struct Cfg {
  static constexpr int NT = NT_, WT = WT_, STAGES = STAGES_;
  static constexpr int BLOCKS = BLOCKS_;  // blocks an SM is to hold (the launch asks the occupancy query)
  static constexpr int WARPS = 4 * WT, THREADS = 32 * WARPS;
  static constexpr int MP = 8 * NT * WT;
  static constexpr int X_BYTES = MP * 128;
  static constexpr int W_BYTES = 2 * BOX;
  static constexpr int S_BYTES = 2 * BN * 4;
  static constexpr int STAGE = (X_BYTES + W_BYTES + S_BYTES + 1023) / 1024 * 1024;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
  static_assert(X_BYTES % 1024 == 0, "boxes 1024-byte aligned");
};

// two blocks of 4 warps an SM up to 32 tokens (the unpack and product
// chain of a step needs more than one warp per scheduler to hide its
// latency), one block of 8 warps above
using Cfg8 = Cfg<1, 1, 10, 2>;   // M <= 8
using Cfg16 = Cfg<2, 1, 9, 2>;   // M <= 16
using Cfg32 = Cfg<4, 1, 7, 2>;   // M <= 32
using Cfg64 = Cfg<4, 2, 10, 1>;  // M <= 64

__device__ __forceinline__ uint32_t ld32s(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Byte j of a packed word as the bf16 pair (low nibble, high nibble) of
// signed values: PRMT puts the byte's low nibble in bits 0-3 and its high
// nibble in bits 16-19, one LOP3 masks them, flips bit 3 (two's complement
// -> offset binary) and ORs in bf16 128.0 (0x4300), giving 128 + (n ^ 8) =
// n + 136; one HSUB2 of (136, 136) leaves n. Every step is exact, so the
// tensor cores sum n * x as the TPU kernel does.
template <int J>
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, uint32_t w_hi) {
  constexpr uint32_t sel = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);
  const uint32_t biased = (__byte_perm(w, w_hi, sel) & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A weight arrives as `blocks` column blocks of `bw` columns each (one
// block: the whole weight; more: a model axis's column shards, each its
// own [K/2, bw] packed tensor and [K/gs, bw] scales, read in place).
// Global output column c lies in block c / bw at local column c % bw.
// PRODUCT and the tail's o and down stages take bw a multiple of
// BLOCK_UNIT and tile each block on its own (block_tiles items a block,
// the last one ragged where bw is no multiple of its span); gate/up takes
// bw a multiple of BN and tiles the whole I, so neither of an item's two
// boxes (at n0 and I + n0) straddles two blocks. Up to 8 blocks: a
// `model` axis as wide as an 8-card node (Llama-3.1-8B's shards there:
// qkv 768, o and down 512, gate/up 3,584 columns; the head 16,032;
// Qwen2.5-7B's: qkv 576, o and down 448, gate/up 4,736, the head 19,008).
constexpr int MAX_BLOCKS = 8;

struct Gemm {
  const float* S[MAX_BLOCKS];  // per block: [K/gs, bw] scales
  int K, N;
  int bw;              // columns of a block (N for a whole weight)
  int second;          // column offset of the second half (gate/up: I), else -1
  int span;            // output columns a tile advances (a product item's boxes lie side by side)
  int block_tiles;     // tiles a block, ceil(bw / span); GATE_UP: 0 (tiles over the whole I)
  int tiles, splits;
  float* ws;           // [splits, M, N] fp32 partials, by global column
  unsigned* tickets;   // [tiles], 0 between launches
};

// The tail's three stages, and PRODUCT: out = x @ W alone (int4_matmul's
// decode route, one stage in a launch of its own), whose items are
// PRODUCT_NB boxes of BN columns side by side (wider runs of each packed
// row)
enum Stage { O_PROJ = 0, GATE_UP = 1, DOWN = 2, PRODUCT = 3 };
constexpr int PRODUCT_NB = 2;  // a stage holds two boxes
constexpr int PRODUCT_TILE = PRODUCT_NB * BN;
// The block width unit of PRODUCT, O_PROJ and DOWN: a block's last item
// may end any multiple of 16 columns into a box (the scale row's bulk
// copy of cols * 4 bytes, at least 64, and the float4 stores stop there).
// 16 is the floor: a block's packed map has a row stride of bw bytes, and
// a tensor map takes strides in multiples of 16 bytes only. It is also
// the width of a sum-of-squares partial (Args::sq)
constexpr int BLOCK_UNIT = 16;
// The product's rings: at M <= 8 more blocks of fewer stages stream
// faster (5 x 4 and 4 x 4 beat the tail's 2 x 10 at lm_head: PERF.md); above,
// the tail's, untuned
using P8 = Cfg<1, 1, 4, 5>;
using P16 = Cfg16;
using P32 = Cfg32;
using P64 = Cfg64;

struct Args {
  CUtensorMap xmap[4];              // per stage: x [M, K] bf16 (ctx, xn, h; the product's x), boxes [MP][64]
  CUtensorMap pmap[4][MAX_BLOCKS];  // per stage and block: packed [K/2, bw] int8, boxes [32][128]
  const float* xres;
  const float* norm_w;
  float* out;     // [M, H] fp32 (the product: [M, N])
  float* xmid;    // [M, H] fp32
  bf16* xn;       // [M, H]
  bf16* h;        // [M, I]
  float* sq;      // [H / BLOCK_UNIT, M] sums of squares of xmid, one per 16 columns by global column
  Gemm g[4];
  int M, H, I, gs, unit_offset, act;
  float eps;
};
// 36 tensor maps and the rest, 5,184 bytes, passed by value
// (__grid_constant__, so that &A.pmap[s][b] stays a parameter-space address
// for TMA): past 4 KB, inside the 32,764 bytes of CUDA 12.1 and later
static_assert(sizeof(Args) <= 32764, "kernel parameters exceed 32,764 bytes");

// Walks the steps of this block's work items (item = blockIdx.x + r * gridDim.x;
// tile = item % tiles, split = item / tiles; split s holds the groups
// [s * G / splits, (s + 1) * G / splits) of G = K / gs, as ops/int4.tail_plan).
struct Cursor {
  int item, total, tiles, splits, groups, gs, k, kend;
  __device__ Cursor(const Gemm& g, int gs_)
      : item(blockIdx.x), total(g.tiles * g.splits), tiles(g.tiles), splits(g.splits), groups(g.K / gs_),
        gs(gs_) {
    begin();
  }
  __device__ void begin() {
    if (item >= total) return;
    const int s = item / tiles;
    k = (s * groups / splits) * gs;
    kend = ((s + 1) * groups / splits) * gs;
  }
  __device__ bool valid() const { return item < total; }
  __device__ bool last() const { return k + KS >= kend; }
  __device__ int tile() const { return item % tiles; }
  __device__ int split() const { return item / tiles; }
  __device__ void next() {
    k += KS;
    if (k >= kend) {
      item += gridDim.x;
      begin();
    }
  }
};

// Output column of column `col` of a staged row ([0, BN): the first
// block at n0, [BN, 2 BN): the second block; without a second block the
// boxes lie side by side from n0)
__device__ __forceinline__ int out_col(const Gemm& g, int n0, int col) {
  return (col < BN || g.second < 0 ? n0 : g.second + n0 - BN) + col;
}

// A tile's place: its block, its first column in that block, its first
// output column n0 and its columns inside the block (its block's tiles
// run from the block's column 0, so the last may hold fewer than span;
// GATE_UP: tiles of span columns over the whole I, block found per box)
struct Place {
  int block, local, n0, cols;
};
template <int STAGE_ID>
__device__ __forceinline__ Place place_of(const Gemm& g, int tile) {
  if constexpr (STAGE_ID != GATE_UP) {
    const int b = tile / g.block_tiles, local = (tile - b * g.block_tiles) * g.span;
    return {b, local, b * g.bw + local, min(g.span, g.bw - local)};
  } else {
    return {-1, -1, tile * g.span, g.span};
  }
}

// Where a work item's NB packed boxes lie: each box's block map, its
// column within the block and its block's scales. The loader finds them
// once per item, not per step: the block of a global column costs a
// division and indexed parameter loads, and whatever the loader spends on
// a step delays the whole block, whose steps end in a barrier.
template <int NB>
struct Boxes {
  const CUtensorMap* map[NB];
  const float* S[NB];
  int col[NB];
  int cols[NB];  // the box's columns inside its block (a multiple of BLOCK_UNIT up to BN, or 0; GATE_UP: BN)
  int item = -1;
  template <int STAGE_ID>
  __device__ __forceinline__ void find(const Args& A, const Gemm& g, const Cursor& c) {
    if (c.item == item) return;
    item = c.item;
    if constexpr (STAGE_ID != GATE_UP) {
      const Place p = place_of<STAGE_ID>(g, c.tile());
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        map[cb] = &A.pmap[STAGE_ID][p.block];
        S[cb] = g.S[p.block];
        col[cb] = p.local + cb * BN;
        cols[cb] = max(0, min(BN, p.cols - cb * BN));
      }
    } else {
      const int n0 = c.tile() * g.span;
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        const int global = out_col(g, n0, cb * BN), b = global / g.bw;
        map[cb] = &A.pmap[STAGE_ID][b];
        S[cb] = g.S[b];
        col[cb] = global - b * g.bw;
        cols[cb] = BN;
      }
    }
  }
};

// One step into a ring stage, issued by one thread: the x box, NB packed
// boxes and NB scale rows, all completing on the stage's barrier. A box
// that runs past its block's edge, or is wider than its block, is loaded
// whole (TMA fills the columns past the edge with zeros
// and counts the whole box's bytes) beside the scales of its columns
// inside the block, a multiple of 16 (64 bytes and up); a box wholly past
// the edge is not loaded. Either way the stage's columns past the edge
// hold stale bytes, which reach only sums that are never stored.
template <class C, int NB, int STAGE_ID>
__device__ __forceinline__ void issue_step(unsigned char* stage, uint64_t* bar, const Args& A, const Cursor& c,
                                           Boxes<NB>& bx) {
  const Gemm& g = A.g[STAGE_ID];
  bx.template find<STAGE_ID>(A, g, c);
  uint32_t bytes = C::X_BYTES;
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
    if (bx.cols[cb] > 0) bytes += BOX + bx.cols[cb] * 4;
  mbar_expect_tx(bar, bytes);
  tma_load_2d(stage, &A.xmap[STAGE_ID], bar, c.k, 0);
  const size_t row = (size_t)(c.k / A.gs) * g.bw;  // the step's scale row in its block
#pragma unroll
  for (int cb = 0; cb < NB; ++cb) {
    const int cols = bx.cols[cb];
    if (cols == 0) continue;
    tma_load_2d(stage + C::X_BYTES + cb * BOX, bx.map[cb], bar, bx.col[cb], c.k / 2);
    bulk_copy(stage + C::X_BYTES + C::W_BYTES + cb * BN * 4, bx.S[cb] + row + bx.col[cb], cols * 4, bar);
  }
}

// Accumulators of one warp: [column block][tile A/B][token tile][4]. Of
// the warp's 32 columns, tile A of a lane covers columns 4g, 4g+1 (rows g,
// g+8 of the m16n8k16 product W^T x^T), tile B columns 4g+2, 4g+3; a lane
// holds tokens 2t, 2t+1 of each token tile.
template <class C, int NB>
struct Acc {
  float v[NB][2][C::NT][4];
  __device__ void zero() {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int n = 0; n < C::NT; ++n) v[b][a][n][0] = v[b][a][n][1] = v[b][a][n][2] = v[b][a][n][3] = 0.f;
  }
};

template <class C, int NB>
__device__ __forceinline__ void compute_step(const unsigned char* stage, const Cursor& c, int gs,
                                             Acc<C, NB>& acc, Acc<C, NB>& gacc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3, ng = warp % 4, wt = warp / 4;
  const unsigned char* wsm = stage + C::X_BYTES;
#pragma unroll
  for (int s = 0; s < KS / 16; ++s) {
    uint32_t b[C::NT][2];
#pragma unroll
    for (int n = 0; n < C::NT; ++n) {
      const int row = wt * 8 * C::NT + n * 8 + g8, byte = (s * 16 + 2 * t4) * 2;
      b[n][0] = ld32s(stage + swizzle128(row, byte));
      b[n][1] = ld32s(stage + swizzle128(row, byte + 16));
    }
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      const unsigned char* box = wsm + cb * BOX;
      const uint32_t w0 = ld32s(box + swizzle128(s * 8 + t4, ng * 32 + 4 * g8));
      const uint32_t w1 = ld32s(box + swizzle128(s * 8 + t4 + 4, ng * 32 + 4 * g8));
      const uint32_t h0 = w0 >> 4, h1 = w1 >> 4;
      const uint32_t aA[4] = {nibble_pair<0>(w0, h0), nibble_pair<1>(w0, h0), nibble_pair<0>(w1, h1),
                              nibble_pair<1>(w1, h1)};
      const uint32_t aB[4] = {nibble_pair<2>(w0, h0), nibble_pair<3>(w0, h0), nibble_pair<2>(w1, h1),
                              nibble_pair<3>(w1, h1)};
#pragma unroll
      for (int n = 0; n < C::NT; ++n) {
        mma_bf16(gacc.v[cb][0][n], aA, b[n][0], b[n][1]);
        mma_bf16(gacc.v[cb][1][n], aB, b[n][0], b[n][1]);
      }
    }
  }
  if ((c.k + KS) % gs == 0) {  // the group's last step: apply its scales
    const float* ss = reinterpret_cast<const float*>(stage + C::X_BYTES + C::W_BYTES);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      const float4 sc = *reinterpret_cast<const float4*>(ss + cb * BN + ng * 32 + 4 * g8);
#pragma unroll
      for (int n = 0; n < C::NT; ++n) {
        float* a = acc.v[cb][0][n];
        float* b2 = acc.v[cb][1][n];
        float* ga = gacc.v[cb][0][n];
        float* gb = gacc.v[cb][1][n];
        a[0] += ga[0] * sc.x; a[1] += ga[1] * sc.x; a[2] += ga[2] * sc.y; a[3] += ga[3] * sc.y;
        b2[0] += gb[0] * sc.z; b2[1] += gb[1] * sc.z; b2[2] += gb[2] * sc.w; b2[3] += gb[3] * sc.w;
        ga[0] = ga[1] = ga[2] = ga[3] = gb[0] = gb[1] = gb[2] = gb[3] = 0.f;
      }
    }
  }
}

// Writes this warp's part of the item's partial to the workspace and
// takes a ticket; the tile's last split sums the workspace in split order
// and finishes the stage's function there. A product of one split writes
// its sums to out directly (no workspace, no ticket). No stage writes a
// column past its block's edge.
template <class C, int NB, int STAGE_ID>
__device__ void finish_item(const Args& A, const Cursor& c, const Acc<C, NB>& acc, unsigned* flag) {
  const Gemm& g = A.g[STAGE_ID];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3, ng = warp % 4, wt = warp / 4;
  const Place p = place_of<STAGE_ID>(g, c.tile());
  const int M = A.M, n0 = p.n0;
  const bool direct = STAGE_ID == PRODUCT && g.splits == 1;
  float* ws = direct ? A.out : g.ws + (size_t)c.split() * M * g.N;
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int n = 0; n < C::NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = wt * 8 * C::NT + n * 8 + 2 * t4 + e, col = cb * BN + ng * 32 + 4 * g8;
        if (tok < M && (STAGE_ID == GATE_UP || col < p.cols))
          *reinterpret_cast<float4*>(ws + (size_t)tok * g.N + out_col(g, n0, col)) =
              make_float4(acc.v[cb][0][n][e], acc.v[cb][0][n][2 + e], acc.v[cb][1][n][e], acc.v[cb][1][n][2 + e]);
      }
  if (direct) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicInc(g.tickets + c.tile(), g.splits - 1) == (unsigned)(g.splits - 1);
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  auto split_sum = [&](int tok, int col) {  // 4 columns' partials summed in split order
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int s = 0; s < g.splits; ++s) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(g.ws + ((size_t)s * M + tok) * g.N + col));
      v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
    }
    return v;
  };
  constexpr int Q4 = BN / 4;  // float4 columns of a whole tile
  const int q = p.cols / 4;   // float4 columns of the tile inside its block
  if (STAGE_ID == O_PROJ) {
    // xmid = x_res + ctx @ O for this tile's columns, and the sums of
    // squares of each 16 of them per token, by global column (the same
    // partials whatever the blocks): a warp per token, a lane per 4
    // columns, four lanes a partial
    static_assert(Q4 == 32 && BLOCK_UNIT == 16, "one float4 column per lane, four lanes a partial");
    for (int tok = warp; tok < M; tok += C::WARPS) {
      const int col = n0 + 4 * lane;
      const bool inside = lane < q;
      float sq = 0.f;
      if (inside) {
        const size_t o = (size_t)tok * A.H + col;
        const float4 r = *reinterpret_cast<const float4*>(A.xres + o), s = split_sum(tok, col);
        const float4 v = make_float4(r.x + s.x, r.y + s.y, r.z + s.z, r.w + s.w);
        *reinterpret_cast<float4*>(A.xmid + o) = v;
        sq = v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      }
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      if (inside && lane % 4 == 0) A.sq[(col / BLOCK_UNIT) * M + tok] = sq;
    }
  } else if (STAGE_ID == GATE_UP) {
    for (int i = threadIdx.x; i < M * Q4; i += C::THREADS) {
      const int tok = i / Q4, col = n0 + 4 * (i % Q4);
      const float4 gt = split_sum(tok, col), up = split_sum(tok, g.second + col);
      bf16* h = A.h + (size_t)tok * A.I + col;
      *reinterpret_cast<uint32_t*>(h) = pack_bf16(activation(gt.x, A.act) * up.x, activation(gt.y, A.act) * up.y);
      *reinterpret_cast<uint32_t*>(h + 2) =
          pack_bf16(activation(gt.z, A.act) * up.z, activation(gt.w, A.act) * up.w);
    }
  } else if (STAGE_ID == PRODUCT) {
    for (int i = threadIdx.x; i < M * q; i += C::THREADS) {
      const int tok = i / q, col = n0 + 4 * (i % q);
      *reinterpret_cast<float4*>(A.out + (size_t)tok * g.N + col) = split_sum(tok, col);
    }
  } else {
    for (int i = threadIdx.x; i < M * q; i += C::THREADS) {
      const int tok = i / q, col = n0 + 4 * (i % q);
      const size_t o = (size_t)tok * A.H + col;
      const float4 x = __ldcg(reinterpret_cast<const float4*>(A.xmid + o)), p = split_sum(tok, col);
      *reinterpret_cast<float4*>(A.out + o) = make_float4(x.x + p.x, x.y + p.y, x.z + p.z, x.w + p.w);
    }
  }
}

// One product stage over all of this block's work items, with the ring
// running across item boundaries (the next item's loads overlap this
// item's finish). `steps` counts the ring's steps over the whole launch
// (slot steps % STAGES, barrier parity (steps / STAGES) & 1).
template <class C, int NB, int STAGE_ID>
__device__ void run_stage(const Args& A, unsigned char* ring, uint64_t* full, int& steps, unsigned* flag) {
  const Gemm& g = A.g[STAGE_ID];
  Acc<C, NB> acc, gacc;
  acc.zero();
  gacc.zero();
  Cursor ld(g, A.gs), cs(g, A.gs);
  Boxes<NB> bx;  // the loader's
  const bool loader = threadIdx.x == 0;
  int issued = steps;
  for (int s = 0; s < C::STAGES - 1 && ld.valid(); ++s, ++issued, ld.next())
    if (loader)
      issue_step<C, NB, STAGE_ID>(ring + (issued % C::STAGES) * C::STAGE, &full[issued % C::STAGES], A, ld, bx);
  for (; cs.valid(); ++steps) {
    const int slot = steps % C::STAGES;
    mbar_wait(&full[slot], (steps / C::STAGES) & 1);
    __syncthreads();  // everyone is past the previous step: its slot may be refilled
    if (ld.valid()) {
      if (loader)
        issue_step<C, NB, STAGE_ID>(ring + (issued % C::STAGES) * C::STAGE, &full[issued % C::STAGES], A, ld, bx);
      ++issued;
      ld.next();
    }
    compute_step<C, NB>(ring + slot * C::STAGE, cs, A.gs, acc, gacc);
    if (cs.last()) {
      finish_item<C, NB, STAGE_ID>(A, cs, acc, flag);
      acc.zero();
    }
    cs.next();
  }
  __syncthreads();
}

// The ring in dynamic shared memory (1024-byte aligned for the swizzled
// boxes), its barriers set up before any copy is issued
template <class C>
__device__ __forceinline__ unsigned char* ring_setup(unsigned char* smem_raw, uint64_t* full) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::BLOCKS) fused_tail_kernel(const __grid_constant__ Args A) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ unsigned flag;
  __shared__ __align__(8) uint64_t full[C::STAGES];
  unsigned char* ring = ring_setup<C>(smem_raw, full);
  cg::grid_group grid = cg::this_grid();
  int steps = 0;

  // 1. xmid = x_res + ctx @ O (the tile's last split), sums of squares per 16 columns
  run_stage<C, 1, O_PROJ>(A, ring, full, steps, &flag);
  grid.sync();

  // 2. xn = RMSNorm(xmid) -> bf16: items of (token, 512 columns). Each
  // warp sums the token's H / 16 partials in an order that H alone sets
  // (lane l: partials l, l + 32, ...; then a butterfly, which leaves every
  // lane the same sum), so the norm does not depend on the blocks
  const int chunks = A.H / 512, parts = A.H / BLOCK_UNIT, lane = threadIdx.x & 31;
  for (int item = blockIdx.x; item < A.M * chunks; item += gridDim.x) {
    const int tok = item / chunks, c0 = (item % chunks) * 512;
    float total = 0.f;
    for (int t = lane; t < parts; t += 32) total += __ldcg(A.sq + t * A.M + tok);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
    const float inv = rsqrtf(total / A.H + A.eps);
    for (int c = c0 + threadIdx.x; c < c0 + 512; c += C::THREADS) {
      const float normed = __ldcg(A.xmid + (size_t)tok * A.H + c) * inv;
      const float w = A.norm_w[c];
      A.xn[(size_t)tok * A.H + c] = __float2bfloat16(A.unit_offset ? normed * (1.f + w) : normed * w);
    }
  }
  // xn is read next by the copy engine: order these generic writes first
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  grid.sync();

  // 3. h = act(xn @ gate) * (xn @ up) -> bf16, gate and up read in one K walk
  run_stage<C, 2, GATE_UP>(A, ring, full, steps, &flag);
  asm volatile("fence.proxy.async.global;\n" ::: "memory");  // h, as xn
  grid.sync();

  // 4. out = xmid + h @ down (the tile's last split)
  run_stage<C, 1, DOWN>(A, ring, full, steps, &flag);
}

// int4_matmul's decode route: one PRODUCT stage over a persistent grid.
// It needs no grid barrier, so it is an ordinary launch.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::BLOCKS) product_kernel(const __grid_constant__ Args A) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ unsigned flag;
  __shared__ __align__(8) uint64_t full[C::STAGES];
  unsigned char* ring = ring_setup<C>(smem_raw, full);
  int steps = 0;
  run_stage<C, PRODUCT_NB, PRODUCT>(A, ring, full, steps, &flag);
}

template <class C, bool PROD>
const void* kernel_of() {
  if constexpr (PROD)
    return reinterpret_cast<const void*>(product_kernel<C>);
  else
    return reinterpret_cast<const void*>(fused_tail_kernel<C>);
}

// Per device and kernel, once: its shared-memory limit and how many blocks
// an SM holds (the persistent grid is that times the SM count).
template <class C, bool PROD>
cudaError_t blocks_per_sm(int* blocks) {
  static int per_sm[64] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (per_sm[device] == 0) {
    const void* k = kernel_of<C, PROD>();
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[device], k, C::THREADS, C::SMEM);
    if (err != cudaSuccess) return err;
    if (per_sm[device] <= 0) return cudaErrorCooperativeLaunchTooLarge;
  }
  *blocks = per_sm[device];
  return cudaSuccess;
}

template <class C>
int launch(Args& A, int sm_count, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = blocks_per_sm<C, false>(&blocks);
  if (err != cudaSuccess) return err;
  void* args[] = {&A};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_tail_kernel<C>), dim3(blocks * sm_count),
                                    dim3(C::THREADS), args, C::SMEM, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class C>
int launch_product(const Args& A, int sm_count, cudaStream_t stream) {
  int blocks = 0;
  const cudaError_t err = blocks_per_sm<C, true>(&blocks);
  if (err != cudaSuccess) return err;
  const int items = A.g[PRODUCT].tiles * A.g[PRODUCT].splits;
  product_kernel<C><<<items < blocks * sm_count ? items : blocks * sm_count, C::THREADS, C::SMEM, stream>>>(A);
  return cudaGetLastError();
}

// Blocks an SM holds at M tokens, of the fused tail or of the product
template <bool PROD>
cudaError_t blocks_at(int M, int* blocks) {
  if constexpr (PROD)
    return M <= 8    ? blocks_per_sm<P8, true>(blocks)
           : M <= 16 ? blocks_per_sm<P16, true>(blocks)
           : M <= 32 ? blocks_per_sm<P32, true>(blocks)
                     : blocks_per_sm<P64, true>(blocks);
  return M <= 8    ? blocks_per_sm<Cfg8, false>(blocks)
         : M <= 16 ? blocks_per_sm<Cfg16, false>(blocks)
         : M <= 32 ? blocks_per_sm<Cfg32, false>(blocks)
                   : blocks_per_sm<Cfg64, false>(blocks);
}

int token_rows(int M) { return M <= 8 ? Cfg8::MP : M <= 16 ? Cfg16::MP : M <= 32 ? Cfg32::MP : Cfg64::MP; }

// The step's x box ([rows][64] bf16 of [M, K]) and packed-weight box
// ([32][128] bytes of [K/2, N])
cudaError_t x_map(CUtensorMap* map, const void* x, int M, int K) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M}, strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {KS, (cuuint32_t)token_rows(M)};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dims, strides, box);
}
cudaError_t p_map(CUtensorMap* map, const void* packed, int K, int N) {
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K / 2}, strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {BN, KS / 2};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, packed, dims, strides, box);
}

// Stage `id` of A over a [K, N] weight that arrives as `blocks` column
// blocks (P[b], S[b]: block b's packed [K/2, N/blocks] bytes and [K/gs,
// N/blocks] scales): its Gemm and one packed-weight map a block. Tiles of
// `span` columns are laid out block by block, ceil(bw / span) a block,
// over blocks of a multiple of BLOCK_UNIT columns; GATE_UP's tile the
// whole I (`second`) and take blocks of a multiple of BN, so that an
// item's box at I + n0 lies in one block too. Refuses other widths.
cudaError_t set_stage(Args& A, int id, const void* const* P, const void* const* S, int blocks, int K, int N,
                      int second, int span, int splits, float* ws, unsigned* tickets) {
  const int unit = id == GATE_UP ? BN : BLOCK_UNIT;
  if (P == nullptr || S == nullptr || blocks < 1 || blocks > MAX_BLOCKS || N % blocks != 0 ||
      (N / blocks) % unit != 0 || (id == GATE_UP && (second % BN != 0 || N != 2 * second)))
    return cudaErrorInvalidValue;
  Gemm& g = A.g[id];
  g = Gemm{};
  g.K = K;
  g.N = N;
  g.bw = N / blocks;
  g.second = second;
  g.span = span;
  g.block_tiles = id == GATE_UP ? 0 : (g.bw + span - 1) / span;
  g.tiles = id == GATE_UP ? second / span : blocks * g.block_tiles;
  g.splits = splits;
  g.ws = ws;
  g.tickets = tickets;
  for (int b = 0; b < blocks; ++b) {
    if (P[b] == nullptr || S[b] == nullptr) return cudaErrorInvalidValue;
    g.S[b] = static_cast<const float*>(S[b]);
    const cudaError_t err = p_map(&A.pmap[id][b], P[b], K, g.bw);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Workspace layout (bytes, each part 16-byte aligned): xmid, sq, the three
// partial buffers, xn, h.
struct Layout {
  size_t xmid, sq, ws[3], xn, h, total;
  Layout(int M, int H, int I, const int* splits) {
    size_t at = 0;
    auto take = [&](size_t bytes) {
      const size_t here = at;
      at += (bytes + 15) / 16 * 16;
      return here;
    };
    xmid = take((size_t)M * H * 4);
    sq = take((size_t)(H / BLOCK_UNIT) * M * 4);
    ws[O_PROJ] = take((size_t)splits[0] * M * H * 4);
    ws[GATE_UP] = take((size_t)splits[1] * M * 2 * I * 4);
    ws[DOWN] = take((size_t)splits[2] * M * H * 4);
    xn = take((size_t)M * H * 2);
    h = take((size_t)M * I * 2);
    total = at;
  }
};

bool valid_shape(int M, int H, int I, int gs, const int* splits) {
  if (M <= 0 || M > MAX_TOKENS || H % 512 != 0 || I % 512 != 0 || gs <= 0 || gs % KS != 0 || H % gs != 0 ||
      I % gs != 0)
    return false;
  const int groups[3] = {H / gs, H / gs, I / gs};
  for (int s = 0; s < 3; ++s)
    if (splits[s] < 1 || splits[s] > groups[s]) return false;
  return true;
}

}  // namespace splitk

// ------------------------------------------- prefill: wgmma, weights in registers
namespace prefill {

constexpr int BT = 128;                   // tokens of an output tile: wgmma's N
constexpr int BN = 128;                   // output columns of a tile: two consumers of 64 (wgmma's M)
constexpr int KS = 64;                    // inputs of a ring stage (a group holds gs / KS stages)
constexpr int X_BYTES = BT * KS * 2;      // x box [128 tokens][64] bf16, K-major, 128-byte swizzled
constexpr int P_BYTES = (KS / 2) * BN;    // packed box [32 rows][128 bytes], 128-byte swizzled
constexpr int S_BYTES = BN * 4;           // the stage's scale row (a ragged tile fills its columns in the block)
constexpr int STAGE = (X_BYTES + P_BYTES + S_BYTES + 1023) / 1024 * 1024;
constexpr int STAGES = 7;
constexpr int OLD = 68;                   // staged output row stride in floats (conflict-free float2 writes)
constexpr int OUT_BYTES = BT * OLD * 4;   // one consumer's staged [128 tokens][64 columns] fp32
constexpr int OFF_OUT = STAGES * STAGE;
constexpr int OFF_BAR = OFF_OUT + 2 * OUT_BYTES;
constexpr int SMEM = OFF_BAR + 2 * STAGES * 8 + 1024;  // + alignment slack
constexpr int THREADS = 384;              // producer warpgroup + two consumers
// setmaxnreg: a thread starts with CAP registers (what the launch bounds
// leave, one block an SM); the producer keeps 40 and the consumers share
// the rest
constexpr int CAP = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = (CAP * THREADS - 128 * PRODUCER_REGS) / 256 / 8 * 8;
static_assert(SMEM <= 232448, "shared-memory plan exceeds a block's 227 KB");

// Item w: token tile m0 and column tile w % tn of the weight's tn =
// blocks x bt, tiled block by block (bt = ceil(bw / BN) tiles a block from
// its column 0, the last of a block ragged where bw is no multiple of BN):
// block b, first column `local` in the block. Items walk the column tiles
// of a token tile first, so blocks running side by side share their x
// tile in L2.
struct Tile {
  int m0, b, local;
  __device__ Tile(int w, int tn, int bt) : m0((w / tn) * BT), b((w % tn) / bt), local(((w % tn) % bt) * BN) {}
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The packed bytes of a stage's four 16-deep steps for this lane, with one
// ldmatrix. Warp w's A rows g and g + 8 are columns 16w + 2g and 16w + 2g + 1
// of the consumer's 64 (a permutation the epilogue undoes), so a lane's two
// columns are one 16-bit element of a packed row, and step ks needs rows
// 8ks + t (k 2t, 2t + 1) and 8ks + t + 4 (k 2t + 8, 2t + 9) of it. Matrix ks
// of an .x4 .trans load has those rows as its rows 2t and 2t + 1 and the
// warp's 8 elements as its columns, so lane (g, t) receives one word whose
// bytes are A's rows g, g + 8 at k 2t.. and rows g, g + 8 at k 2t + 8..
__device__ __forceinline__ void load_words(uint32_t (&w)[4], const unsigned char* box, int chunk, int lane) {
  const int r = lane % 8;
  const uint32_t addr = smem_u32(box + swizzle128(8 * (lane / 8) + r / 2 + 4 * (r % 2), chunk));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "r"(addr)
               : "memory");
}

// The A fragments of the four steps from load_words' words: byte j of a
// word is fragment register j (nibble_pair<j>)
__device__ __forceinline__ void unpack_words(uint32_t (&a)[4][4], const uint32_t (&w)[4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t h = w[ks] >> 4;
    a[ks][0] = splitk::nibble_pair<0>(w[ks], h);
    a[ks][1] = splitk::nibble_pair<1>(w[ks], h);
    a[ks][2] = splitk::nibble_pair<2>(w[ks], h);
    a[ks][3] = splitk::nibble_pair<3>(w[ks], h);
  }
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products and their waits
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc += g times this lane's two column scales (accumulator rows g8 and
// g8 + 8: i / 2 even and odd)
__device__ __forceinline__ void fold(float (&acc)[64], const float (&g)[64], float2 sc) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] += g[i] * ((i / 2) % 2 ? sc.y : sc.x);
}

// The weight as 1 to splitk::MAX_BLOCKS column blocks of bw columns each
// (one block: the whole weight; more: a model axis's column shards, each
// its own [K/2, bw] packed tensor and [K/gs, bw] scales, read in place).
// bw is a multiple of splitk::BLOCK_UNIT (16), and each block is tiled on
// its own (Tile), so a tile's columns lie in one block.
struct Blocks {
  CUtensorMap pmap[splitk::MAX_BLOCKS];  // per block: packed [K/2, bw] int8, boxes [32][128]
  const float* S[splitk::MAX_BLOCKS];    // per block: [K/gs, bw] scales
  int bw;
};

__global__ void __launch_bounds__(THREADS, 1)
matmul_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ Blocks W, float* __restrict__ out,
              int M, int N, int K, int gs) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;
  const int bt = (W.bw + BN - 1) / BN, tn = N / W.bw * bt, items = (M + BT - 1) / BT * tn, kbs = K / KS;
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
      const Tile u(w, tn, bt);
      // the tile's block, once a tile: its map at the local column, its
      // scales, and the bytes of its scale row inside the block. A ragged
      // tile's packed box runs past the block's edge (TMA fills those
      // columns with zeros and counts the whole box's bytes); its scale
      // copy stops at the edge (a multiple of 16 columns: 64 bytes and up),
      // so the stage's scales past it are stale. A column's sums and scales
      // meet only in that column's accumulators, which the epilogue drops.
      const CUtensorMap* pmap = &W.pmap[u.b];
      const float* S = W.S[u.b] + u.local;
      const uint32_t s_bytes = min(BN, W.bw - u.local) * 4;
      for (int kb = 0; kb < kbs; ++kb, ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], X_BYTES + P_BYTES + s_bytes);
        unsigned char* st = smem + s * STAGE;
        tma_load_2d(st, &xmap, &full[s], kb * KS, u.m0);
        tma_load_2d(st + X_BYTES, pmap, &full[s], u.local, kb * (KS / 2));
        bulk_copy(st + X_BYTES + P_BYTES, S + (size_t)(kb * KS / gs) * W.bw, s_bytes, &full[s]);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int byte = 64 * c + 16 * warp + 2 * g8;  // this lane's two columns of the tile
  const uint32_t base = smem_u32(smem);
  float* staged = reinterpret_cast<float*>(smem + OFF_OUT + c * OUT_BYTES);
  // Scale group j sums into gacc[j % 2], and is folded into the running sum
  // while group j + 1's first products run. A stage's products are waited
  // for before the next stage's A registers are written (wgmma reads them
  // asynchronously); the next stage's words are loaded, and the previous
  // group folded, while they run.
  float gacc[2][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) gacc[0][i] = gacc[1][i] = 0.f;
  const int groups = K / gs, spg = gs / KS;
  int it = 0;  // stages consumed so far
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Tile u(w, tn, bt);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float2 sc = make_float2(0.f, 0.f);  // the scales of the last group finished, for its fold
    uint32_t words[KS / 16];
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    load_words(words, smem + (it % STAGES) * STAGE + X_BYTES, 64 * c + 16 * warp, lane);
    auto group = [&](int j, auto buf) {
      constexpr int B = decltype(buf)::value;
      for (int q = 0; q < spg; ++q, ++it) {
        const int s = it % STAGES;
        const unsigned char* st = smem + s * STAGE;
        uint32_t a[KS / 16][4];
        unpack_words(a, words);
        fence_operands(gacc[B]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS / 16; ++ks)
          wgmma_rs128(gacc[B], a[ks], sw128_desc(base + s * STAGE + ks * 32, 16, 8 * 128), !(q == 0 && ks == 0));
        wgmma_commit();
        if (q == 0 && j > 0) fold(acc, gacc[B ^ 1], sc);
        if (q + 1 == spg) sc = *reinterpret_cast<const float2*>(st + X_BYTES + P_BYTES + 4 * byte);
        if (j * spg + q + 1 < kbs) {
          const int n = (it + 1) % STAGES;
          mbar_wait(&full[n], ((it + 1) / STAGES) & 1);
          load_words(words, smem + n * STAGE + X_BYTES, 64 * c + 16 * warp, lane);
        }
        wgmma_wait<0>();
        fence_operands(gacc[0]);
        fence_operands(gacc[1]);
        mbar_arrive(&empty[s]);  // the stage's products are done: it goes back to the producer
      }
    };
    for (int j = 0; j < groups; j += 2) {
      group(j, std::integral_constant<int, 0>{});
      if (j + 1 < groups) group(j + 1, std::integral_constant<int, 1>{});
    }
    if ((groups - 1) % 2)
      fold(acc, gacc[1], sc);
    else
      fold(acc, gacc[0], sc);

    // acc[4j + 2h + e] is column 16 warp + 2 g8 + h of this consumer's 64,
    // token 8j + 2 t4 + e: staged as [token][column], then stored as rows of
    // 16-byte pieces, rows past M and columns past the block's edge dropped
    // (a ragged tile ends on a multiple of 16 columns, so a piece lies
    // wholly on one side; a consumer wholly past the edge computed on the
    // zeros TMA filled in, and stores nothing)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(staged + (8 * j + 2 * t4 + e) * OLD + 16 * warp + 2 * g8) =
            make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
    bar_sync(1 + c, 128);
    const int first = u.local + 64 * c, inside = W.bw - first;  // this consumer's first column in the block
    float* dst = out + (size_t)u.b * W.bw + first;
    for (int i = t; i < BT * 16; i += 128) {
      const int tok = i / 16, q = i % 16;
      if (u.m0 + tok < M && 4 * q < inside)
        *reinterpret_cast<float4*>(dst + (size_t)(u.m0 + tok) * N + 4 * q) =
            *reinterpret_cast<const float4*>(staged + tok * OLD + 4 * q);
    }
    bar_sync(1 + c, 128);  // the staging is read before the next tile writes it
  }
}

// Per device, once: the shared-memory limit, and the check that the kernel
// was compiled to CAP registers (setmaxnreg.inc would wait forever if the
// block started with fewer than it hands round).
cudaError_t prepare() {
  static bool ready[64] = {false};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (ready[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, matmul_kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs != CAP) return cudaErrorInvalidConfiguration;
  ready[device] = true;
  return cudaSuccess;
}

// Work items of a launch over `blocks` column blocks of N / blocks columns
// each: a token tile times ceil(bw / BN) column tiles a block. -1 for a
// shape the route refuses: blocks of unequal width, or of a width that is
// no multiple of splitk::BLOCK_UNIT (a tensor map's row stride of bw bytes
// needs 16), more than splitk::MAX_BLOCKS blocks.
long long item_count(int M, int N, int blocks) {
  if (M <= 0 || N <= 0 || blocks < 1 || blocks > splitk::MAX_BLOCKS || N % blocks != 0 ||
      (N / blocks) % splitk::BLOCK_UNIT != 0)
    return -1;
  const int bw = N / blocks;
  return (long long)((M + BT - 1) / BT) * blocks * ((bw + BN - 1) / BN);
}

// One launch over the weight's `blocks` column blocks (P[b], S[b]: block
// b's packed [K/2, N/blocks] bytes and [K/gs, N/blocks] scales). Refuses
// what `item_count` refuses.
int launch(const void* x, const void* const* P, const void* const* S, int blocks, void* out, int M, int N, int K,
           int gs, int sm_count, cudaStream_t stream) {
  const long long work = item_count(M, N, blocks);
  if (P == nullptr || S == nullptr || work < 0 || work > (1ll << 31) - 1) return cudaErrorInvalidValue;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return err;
  CUtensorMap xmap;
  Blocks W{};
  W.bw = N / blocks;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M}, strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {KS, BT};
  err = make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dims, strides, box);
  for (int b = 0; b < blocks && err == cudaSuccess; ++b) {
    if (P[b] == nullptr || S[b] == nullptr) return cudaErrorInvalidValue;
    W.S[b] = static_cast<const float*>(S[b]);
    err = splitk::p_map(&W.pmap[b], P[b], K, W.bw);
  }
  if (err != cudaSuccess) return err;
  matmul_kernel<<<(int)(work < sm_count ? work : sm_count), THREADS, SMEM, stream>>>(
      xmap, W, static_cast<float*>(out), M, N, K, gs);
  return cudaGetLastError();
}

}  // namespace prefill
}  // namespace

extern "C" const char* comorag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// int4_matmul, one entry per route (ops/int4.int4_matmul picks by shape).
// x: [M, K] bf16 (16-byte aligned rows); out: [M, N] fp32. K a multiple
// of gs, gs a multiple of 64. Each returns a cudaError_t (0 on success),
// launches on `stream` and never syncs.
//
// The mma.sync route: any M and N; packed: [K/2, N] int8; scales: [K/gs,
// N] fp32.
extern "C" int comorag_int4_matmul(const void* x, const void* packed, const void* scales,
                                   void* out, int M, int N, int K, int gs, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || gs <= 0 || gs % KT != 0 || K % gs != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16) return launch_matmul<CfgDecode>(x, packed, scales, out, M, N, K, gs, st);
  if (M <= 64) return launch_matmul<CfgMid>(x, packed, scales, out, M, N, K, gs, st);
  return launch_matmul<CfgPrefill>(x, packed, scales, out, M, N, K, gs, st);
}

// The split-K and wgmma routes take the weight as `blocks` column blocks
// (1 to comorag_int4_matmul_max_blocks: the whole weight, or a model
// axis's column shards in order, block b holding columns [b N / blocks,
// (b + 1) N / blocks), of equal width: a multiple of 16 on both), given
// as arrays of packed [K/2, N/blocks] int8 and scale
// [K/gs, N/blocks] fp32 pointers read in place; every pointer 16-byte
// aligned. One launch, whatever the blocks: at the same K splits the
// output equals the whole weight's bit for bit.
extern "C" int comorag_int4_matmul_max_blocks() { return splitk::MAX_BLOCKS; }

// The decode route: M <= 64, each block's width a multiple of 16. Items
// of comorag_int4_matmul_splitk_tile_n columns run block by block,
// ceil(N / blocks / tile_n) a block (the last one of a block ragged where
// its width is no multiple of tile_n). splits: K splits on group
// boundaries, 1 <= splits <= K / gs (ops/int4.matmul_plan: the whole
// weight's, which give its sums bit for bit). workspace: splits * M * N fp32; tickets: one unsigned int per
// item column tile, zero before the first launch (each launch leaves
// them zero); at one split neither is read (may be null). sm_count: SMs
// for the persistent grid.
extern "C" int comorag_int4_matmul_splitk(const void* x, const void* const* P, const void* const* S, int blocks,
                                          void* out, void* workspace, void* tickets, int M, int N, int K, int gs,
                                          int splits, int sm_count, void* stream) {
  if (M <= 0 || M > splitk::MAX_TOKENS || N <= 0 || gs <= 0 || gs % splitk::KS != 0 || K <= 0 || K % gs != 0 ||
      splits < 1 || splits > K / gs || sm_count <= 0)
    return cudaErrorInvalidValue;
  splitk::Args A{};
  A.out = static_cast<float*>(out);
  A.M = M;
  A.gs = gs;
  cudaError_t err = splitk::set_stage(A, splitk::PRODUCT, P, S, blocks, K, N, -1, splitk::PRODUCT_TILE, splits,
                                      static_cast<float*>(workspace), static_cast<unsigned*>(tickets));
  if (err == cudaSuccess) err = splitk::x_map(&A.xmap[splitk::PRODUCT], x, M, K);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) return splitk::launch_product<splitk::P8>(A, sm_count, st);
  if (M <= 16) return splitk::launch_product<splitk::P16>(A, sm_count, st);
  if (M <= 32) return splitk::launch_product<splitk::P32>(A, sm_count, st);
  return splitk::launch_product<splitk::P64>(A, sm_count, st);
}

// The decode route's geometry, for ops/int4.matmul_plan: output columns of
// one item, and blocks an SM holds at M tokens (a negative cudaError_t on
// failure).
extern "C" int comorag_int4_matmul_splitk_tile_n() { return splitk::PRODUCT_TILE; }

extern "C" int comorag_int4_matmul_splitk_blocks_per_sm(int M) {
  if (M <= 0 || M > splitk::MAX_TOKENS) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = splitk::blocks_at<true>(M, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The prefill route: each block's width a multiple of 16 (any M; ops/int4
// sends it M > 64). Tiles of 128 tokens x 128 columns, laid out block by
// block, the last of a block ragged where its width is no multiple of
// 128; no K split, so a column's sum is the whole weight's whatever its
// tile. sm_count: SMs for the persistent grid.
extern "C" int comorag_int4_matmul_wgmma(const void* x, const void* const* P, const void* const* S, int blocks,
                                         void* out, int M, int N, int K, int gs, int sm_count, void* stream) {
  if (M <= 0 || N <= 0 || gs <= 0 || gs % prefill::KS != 0 || K <= 0 || K % gs != 0 || sm_count <= 0)
    return cudaErrorInvalidValue;
  return prefill::launch(x, P, S, blocks, out, M, N, K, gs, sm_count, static_cast<cudaStream_t>(stream));
}

// The prefill route's work items at M rows over N columns in `blocks`
// column blocks (for ops/int4.wgmma_items), or a negative cudaError_t for
// a shape comorag_int4_matmul_wgmma refuses.
extern "C" long long comorag_int4_matmul_wgmma_items(int M, int N, int blocks) {
  const long long work = prefill::item_count(M, N, blocks);
  return work < 0 ? -static_cast<long long>(cudaErrorInvalidValue) : work;
}

// ctx: [M, H] bf16; xres, out: [M, H] fp32; norm_w: [H] fp32; o: [H/2, H]
// int8 + [H/gs, H]; gu: [H/2, 2I] + [H/gs, 2I]; down: [I/2, H] + [I/gs, H];
// each weight as o_blocks / gu_blocks / d_blocks column blocks (1 to
// comorag_int4_tail_max_blocks: the whole weight, or a model axis's column
// shards in order, block b holding columns [b N / blocks, (b + 1) N /
// blocks); o and down blocks a multiple of comorag_int4_block_unit
// columns wide, gate/up blocks of comorag_int4_tail_tile_n), given as
// arrays of packed and scale pointers read in place, each block on the
// current device or on a peer card it may read (comorag_enable_peer_access),
// everything else on the current device; every pointer 16-byte aligned.
// M <= 64; H and I multiples of 512; gs a multiple of 64 dividing H and I.
// splits: the K splits of the o, gate/up and down stages (ops/int4.tail_plan;
// the whole weights' splits give the whole weights' sums, bit for bit).
// workspace: comorag_int4_tail_workspace_bytes bytes; tickets: one a tile,
// o_blocks ceil(H / o_blocks / 128) + I / 128 + d_blocks ceil(H / d_blocks /
// 128) unsigned ints, zero before the first launch (each launch leaves
// them zero). act: 0 silu, 1 gelu (tanh), 2
// gelu (erf). One cooperative launch on `stream`, whatever the blocks.
extern "C" long long comorag_int4_tail_workspace_bytes(int M, int H, int I, int so, int sgu, int sd) {
  const int splits[3] = {so, sgu, sd};
  return static_cast<long long>(splitk::Layout(M, H, I, splits).total);
}

// The work items' geometry, for ops/int4.tail_plan: output columns of one
// item, and blocks an SM holds at M tokens on the current device (a
// negative cudaError_t on failure).
extern "C" int comorag_int4_tail_tile_n() { return splitk::BN; }

extern "C" int comorag_int4_block_unit() { return splitk::BLOCK_UNIT; }

extern "C" int comorag_int4_tail_max_blocks() { return splitk::MAX_BLOCKS; }

extern "C" int comorag_int4_tail_blocks_per_sm(int M) {
  if (M <= 0 || M > splitk::MAX_TOKENS) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = splitk::blocks_at<false>(M, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Lets kernels launched on `device` read `peer`'s memory in place
// (cudaDeviceEnablePeerAccess from `device`), for the fused tail's blocks
// on a peer card. Access already enabled counts as success, its error
// cleared so that the next cudaGetLastError stays clean. The current
// device is restored. Returns a cudaError_t (0 on success).
extern "C" int comorag_enable_peer_access(int device, int peer) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err != cudaSuccess) cudaGetLastError();
    if (err == cudaErrorPeerAccessAlreadyEnabled) err = cudaSuccess;
  }
  const cudaError_t restored = cudaSetDevice(current);
  return err != cudaSuccess ? err : restored;
}

extern "C" int comorag_int4_fused_layer_tail(const void* ctx, const void* xres, const void* norm_w,
                                             const void* const* oP, const void* const* oS, int o_blocks,
                                             const void* const* guP, const void* const* guS, int gu_blocks,
                                             const void* const* dP, const void* const* dS, int d_blocks,
                                             void* out, void* workspace, void* tickets, int M, int H,
                                             int I, int gs, int so, int sgu, int sd, float eps,
                                             int unit_offset, int act, int sm_count, void* stream) {
  const int splits[3] = {so, sgu, sd};
  if (!splitk::valid_shape(M, H, I, gs, splits) || act < 0 || act > 2 || sm_count <= 0)
    return cudaErrorInvalidValue;
  using splitk::BN;
  const splitk::Layout L(M, H, I, splits);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  unsigned* tk = static_cast<unsigned*>(tickets);
  splitk::Args A{};
  A.xres = static_cast<const float*>(xres);
  A.norm_w = static_cast<const float*>(norm_w);
  A.out = static_cast<float*>(out);
  A.xmid = reinterpret_cast<float*>(ws + L.xmid);
  A.sq = reinterpret_cast<float*>(ws + L.sq);
  A.xn = reinterpret_cast<bf16*>(ws + L.xn);
  A.h = reinterpret_cast<bf16*>(ws + L.h);
  A.M = M; A.H = H; A.I = I; A.gs = gs; A.unit_offset = unit_offset; A.act = act; A.eps = eps;
  // each stage's tickets follow the previous stage's tiles
  cudaError_t err = splitk::set_stage(A, splitk::O_PROJ, oP, oS, o_blocks, H, H, -1, BN, so,
                                      reinterpret_cast<float*>(ws + L.ws[splitk::O_PROJ]), tk);
  if (err == cudaSuccess)
    err = splitk::set_stage(A, splitk::GATE_UP, guP, guS, gu_blocks, H, 2 * I, I, BN, sgu,
                            reinterpret_cast<float*>(ws + L.ws[splitk::GATE_UP]), tk + A.g[splitk::O_PROJ].tiles);
  if (err == cudaSuccess)
    err = splitk::set_stage(A, splitk::DOWN, dP, dS, d_blocks, I, H, -1, BN, sd,
                            reinterpret_cast<float*>(ws + L.ws[splitk::DOWN]),
                            tk + A.g[splitk::O_PROJ].tiles + A.g[splitk::GATE_UP].tiles);
  if (err == cudaSuccess) err = splitk::x_map(&A.xmap[splitk::O_PROJ], ctx, M, H);
  if (err == cudaSuccess) err = splitk::x_map(&A.xmap[splitk::GATE_UP], A.xn, M, H);
  if (err == cudaSuccess) err = splitk::x_map(&A.xmap[splitk::DOWN], A.h, M, I);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) return splitk::launch<splitk::Cfg8>(A, sm_count, st);
  if (M <= 16) return splitk::launch<splitk::Cfg16>(A, sm_count, st);
  if (M <= 32) return splitk::launch<splitk::Cfg32>(A, sm_count, st);
  return splitk::launch<splitk::Cfg64>(A, sm_count, st);
}
