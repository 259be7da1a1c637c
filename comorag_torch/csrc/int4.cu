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
// What the design does about it: a block owns a [BM, BN] output tile and
// walks K in slabs of 64 through a cp.async ring of shared-memory stages
// (the x rows as bf16, the packed bytes as they are: each byte crosses
// device memory once). The m16n8k16 B fragment of a lane is (k 2t, 2t+1;
// n g) and (k 2t+8, 2t+9; n g): exactly the two nibbles of packed bytes
// (t, g) and (t+4, g), so a lane turns one shared-memory byte into one
// bf16 pair in registers and the tensor cores never wait on a dequantized
// copy. Tiles: 16 x 64 for M <= 16, 64 x 64 up to 64 rows, 128 x 128
// above. First version: mma.sync, no wgmma or TMA, no split of K for the
// decode shapes whose column tiles do not fill 132 SMs.
//
// The fused layer tail, x_res + FFN(RMSNorm(x_res + ctx @ O)), is one
// cooperative launch (the TPU kernel exists to be one invocation instead
// of three): every block of a grid that fits the card at once walks the
// column tiles of each stage, with a grid-wide barrier between the o
// product (+ residual into an fp32 xmid workspace), the RMSNorm (into a
// bf16 xn workspace), the gate/up tiles (act(gate) * up into a bf16 h
// workspace) and the down tiles (+ xmid). The rounding points are the TPU
// kernel's: ctx -> bf16, xmid and the norm in fp32, xn -> bf16, gate/up in
// fp32, h -> bf16, down in fp32 plus xmid.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

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

template <class C>
__global__ void __launch_bounds__(C::THREADS)
fused_tail_kernel(const bf16* __restrict__ ctx, const float* __restrict__ xres,
                  const float* __restrict__ norm_w, const int8_t* __restrict__ oP,
                  const float* __restrict__ oS, const int8_t* __restrict__ guP,
                  const float* __restrict__ guS, const int8_t* __restrict__ dP,
                  const float* __restrict__ dS, float* __restrict__ out,
                  float* __restrict__ xmid, bf16* __restrict__ xn, bf16* __restrict__ h, int M,
                  int H, int I, int gs, float eps, int unit_offset, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[C::THREADS / 32];
  cg::grid_group grid = cg::this_grid();
  float acc[C::MF][C::NF][4];

  // 1. xmid = x_res + ctx @ O
  for (int tile = blockIdx.x; tile < H / C::BN; tile += gridDim.x) {
    const int n0 = tile * C::BN;
    zero<C>(acc);
    tile_mma<C>(ctx, M, H, oP, oS, H, gs, 0, n0, true, acc, smem);
    for_each_pair<C>(acc, 0, n0, [&](int row, int col, float v0, float v1) {
      if (row >= M) return;
      const size_t o = (size_t)row * H + col;
      xmid[o] = v0 + xres[o];
      xmid[o + 1] = v1 + xres[o + 1];
    });
  }
  grid.sync();

  // 2. xn = RMSNorm(xmid) -> bf16, one block per row
  for (int row = blockIdx.x; row < M; row += gridDim.x) {
    const float* xr = xmid + (size_t)row * H;
    float sq = 0.f;
    for (int c = threadIdx.x; c < H; c += C::THREADS) sq += xr[c] * xr[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = sq;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < C::THREADS / 32; ++w) total += red[w];
    __syncthreads();
    const float inv = rsqrtf(total / H + eps);
    for (int c = threadIdx.x; c < H; c += C::THREADS) {
      const float normed = xr[c] * inv;
      const float w = norm_w[c];
      xn[(size_t)row * H + c] = __float2bfloat16(unit_offset ? normed * (1.f + w) : normed * w);
    }
  }
  grid.sync();

  // 3. h = act(xn @ gate) * (xn @ up) -> bf16; gate and up are the column
  //    halves [0, I) and [I, 2I) of the fused gate/up weight
  for (int tile = blockIdx.x; tile < I / C::BN; tile += gridDim.x) {
    const int n0 = tile * C::BN;
    float up[C::MF][C::NF][4];
    zero<C>(acc);
    zero<C>(up);
    tile_mma<C>(xn, M, H, guP, guS, 2 * I, gs, 0, n0, true, acc, smem);
    tile_mma<C>(xn, M, H, guP, guS, 2 * I, gs, 0, I + n0, true, up, smem);
#pragma unroll
    for (int i = 0; i < C::MF; ++i)
#pragma unroll
      for (int n = 0; n < C::NF; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = activation(acc[i][n][e], act) * up[i][n][e];
    for_each_pair<C>(acc, 0, n0, [&](int row, int col, float v0, float v1) {
      if (row >= M) return;
      *reinterpret_cast<uint32_t*>(h + (size_t)row * I + col) = pack_bf16(v0, v1);
    });
  }
  grid.sync();

  // 4. out = xmid + h @ down
  for (int tile = blockIdx.x; tile < H / C::BN; tile += gridDim.x) {
    const int n0 = tile * C::BN;
    zero<C>(acc);
    tile_mma<C>(h, M, I, dP, dS, H, gs, 0, n0, true, acc, smem);
    for_each_pair<C>(acc, 0, n0, [&](int row, int col, float v0, float v1) {
      if (row >= M) return;
      const size_t o = (size_t)row * H + col;
      out[o] = v0 + xmid[o];
      out[o + 1] = v1 + xmid[o + 1];
    });
  }
}

template <class C>
int launch_tail(const void* ctx, const void* xres, const void* norm_w, const void* oP,
                const void* oS, const void* guP, const void* guS, const void* dP, const void* dS,
                void* out, void* xmid, void* xn, void* h, int M, int H, int I, int gs, float eps,
                int unit_offset, int act, int sm_count, cudaStream_t stream) {
  auto kernel = fused_tail_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::THREADS, C::SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
  const dim3 grid(per_sm * sm_count);
  void* args[] = {&ctx, &xres, &norm_w, &oP, &oS, &guP, &guS, &dP, &dS, &out, &xmid, &xn,
                  &h, &M, &H, &I, &gs, &eps, &unit_offset, &act};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid, dim3(C::THREADS),
                                    args, C::SMEM, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* comorag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [M, K] bf16 (16-byte aligned rows); packed: [K/2, N] int8; scales:
// [K/gs, N] fp32; out: [M, N] fp32. K a multiple of gs, gs a multiple of
// 64. Returns a cudaError_t (0 on success); launches on `stream`, never
// syncs.
extern "C" int comorag_int4_matmul(const void* x, const void* packed, const void* scales,
                                   void* out, int M, int N, int K, int gs, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || gs <= 0 || gs % KT != 0 || K % gs != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16) return launch_matmul<CfgDecode>(x, packed, scales, out, M, N, K, gs, st);
  if (M <= 64) return launch_matmul<CfgMid>(x, packed, scales, out, M, N, K, gs, st);
  return launch_matmul<CfgPrefill>(x, packed, scales, out, M, N, K, gs, st);
}

// ctx: [M, H] bf16; xres, xmid, out: [M, H] fp32; norm_w: [H] fp32;
// o: [H/2, H] int8 + [H/gs, H]; gu: [H/2, 2I] + [H/gs, 2I]; down: [I/2, H]
// + [I/gs, H]; xn: [M, H] bf16 and h: [M, I] bf16 workspaces. M <= 64;
// H and I multiples of 64; gs a multiple of 64 dividing H and I. act: 0
// silu, 1 gelu (tanh), 2 gelu (erf). One cooperative launch on `stream`.
extern "C" int comorag_int4_fused_layer_tail(const void* ctx, const void* xres, const void* norm_w,
                                             const void* oP, const void* oS, const void* guP,
                                             const void* guS, const void* dP, const void* dS,
                                             void* out, void* xmid, void* xn, void* h, int M,
                                             int H, int I, int gs, float eps, int unit_offset,
                                             int act, int sm_count, void* stream) {
  if (M <= 0 || M > 64 || H % 64 != 0 || I % 64 != 0 || gs <= 0 || gs % KT != 0 || H % gs != 0 ||
      I % gs != 0 || act < 0 || act > 2 || sm_count <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16)
    return launch_tail<CfgDecode>(ctx, xres, norm_w, oP, oS, guP, guS, dP, dS, out, xmid, xn, h,
                                  M, H, I, gs, eps, unit_offset, act, sm_count, st);
  return launch_tail<CfgMid>(ctx, xres, norm_w, oP, oS, guP, guS, dP, dS, out, xmid, xn, h, M, H,
                             I, gs, eps, unit_offset, act, sm_count, st);
}
