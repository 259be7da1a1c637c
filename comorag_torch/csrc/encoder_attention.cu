// Bidirectional encoder self-attention for Hopper (sm_90a), bf16 in/out.
//
// Replaces: comorag_tpu/ops/pallas_attention.py:73 flash_encoder_attention
// (kernel _attn_kernel :49). Same contract: q, k, v and the context are
// [B, S, H] in the projections' native layout (H = heads * dh, head h is
// the column slice [h*dh, (h+1)*dh)), so no transpose exists anywhere in
// the layer; padded keys get a -1e30 bias in fp32; the softmax is exact
// and runs in fp32; p is cast to bf16 for the p @ v product, whose fp32
// sum is divided by the fp32 row sum, as the TPU kernel does.
//
// What bounds it on the H100: at bert-base shapes (S = 512, dh = 64) the
// two products are 4*B*heads*S*S*dh FLOPs (51.5 GFLOP at B = 64) against
// ~4*B*S*H bytes of q/k/v/ctx, far above the card's ~295 FLOP/byte ridge:
// tensor-core bound. The [B, heads, S, S] score tensor (805 MB fp32 at
// B = 64) is what a plain implementation moves through device memory.
//
// What the design does about it (the FlashAttention-2 structure): one
// block of 4 warps per (64-query tile, head, batch row); each warp owns 16
// query rows. K/V tiles of 64 keys stream through a double-buffered
// shared-memory ring with cp.async, so the next tile's load overlaps this
// tile's math. Both products run on mma.sync m16n8k16 bf16 with fp32
// accumulators held in registers: the score fragments are rescaled by the
// online softmax (running max and sum per row) and re-packed in place as
// the A operand of p @ v, and v's B fragments come from ldmatrix.trans,
// so scores, probabilities and the context never touch shared memory.
// Rows are padded by 16 bytes against bank conflicts; the head dim is
// zero-padded to a multiple of 16 (q.k and p@v unchanged), so any dh up
// to 256 is taken. wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

using namespace comorag;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64;            // query rows per block: 4 warps x 16 rows
constexpr int BK = 64;            // keys per shared-memory tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;            // bf16 elements (16 bytes) of row padding
constexpr float MASKED = -1e30f;  // pallas_attention.py:55

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [row0, row0 + 64) of one head's [S, dh] slice into a [64, LD]
// shared tile. Rows past S and columns past dh are left as they are (the
// caller zeroes the buffers once; stale rows are masked out by -inf).
template <int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int row0,
                                          int S, int H, int dh, bool vec) {
  if (vec) {  // dh % 8 == 0: 16-byte cp.async chunks
    const int per_row = dh / 8;
    for (int i = threadIdx.x; i < 64 * per_row; i += THREADS) {
      const int r = i / per_row, c = (i % per_row) * 8;
      if (row0 + r < S) cp_async16(dst + r * LD + c, src + (size_t)(row0 + r) * H + c);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * dh; i += THREADS) {
      const int r = i / dh, c = i % dh;
      if (row0 + r < S) dst[r * LD + c] = src[(size_t)(row0 + r) * H + c];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ mask,
                 bf16* __restrict__ out, int S, int H, int dh, float scale) {
  constexpr int LD = DP + PAD;
  constexpr int NT = BK / 8;   // 8-key score tiles per warp row block
  constexpr int ND = DP / 8;   // 8-wide context column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [BQ, LD]
  bf16* sK = sQ + BQ * LD;                    // 2 x [BK, LD]
  bf16* sV = sK + 2 * BK * LD;                // 2 x [BK, LD]
  float* sBias = reinterpret_cast<float*>(sV + 2 * BK * LD);  // 2 x [BK]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column pair
  const size_t base = (size_t)b * S * H + (size_t)h * dh;
  const bool vec = (dh % 8) == 0;
  const int n_tiles = (S + BK - 1) / BK;

  // zero every tile once: padded columns and never-loaded rows stay finite
  for (int i = threadIdx.x; i < (BQ + 4 * BK) * LD / 8; i += THREADS)
    reinterpret_cast<uint4*>(sQ)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  auto load_tile = [&](int kt, int buf) {
    load_rows<LD>(sK + buf * BK * LD, k + base, kt * BK, S, H, dh, vec);
    load_rows<LD>(sV + buf * BK * LD, v + base, kt * BK, S, H, dh, vec);
    for (int j = threadIdx.x; j < BK; j += THREADS) {
      const int key = kt * BK + j;
      // keys past S do not exist (exp -> 0); masked keys keep -1e30
      sBias[buf * BK + j] = key < S ? (mask[(size_t)b * S + key] > 0 ? 0.0f : MASKED) : -INFINITY;
    }
    cp_async_commit();
  };

  load_rows<LD>(sQ, q + base, q0, S, H, dh, vec);
  load_tile(0, 0);

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.0f, 0.0f};            // this thread's partial row sums
  const bf16* qrow = sQ + (warp * 16 + g) * LD + 2 * t;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      load_tile(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tK = sK + buf * BK * LD;
    const bf16* tV = sV + buf * BK * LD;
    const float* tB = sBias + buf * BK;

    // scores [16, BK] = Q[16, DP] @ K^T, fp32 in registers
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const uint32_t a[4] = {ld32(qrow + kk), ld32(qrow + 8 * LD + kk), ld32(qrow + kk + 8),
                             ld32(qrow + 8 * LD + kk + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* krow = tK + (j * 8 + g) * LD + kk + 2 * t;
        mma_bf16(s[j], a, ld32(krow), ld32(krow + 8));
      }
    }

    // online softmax over this tile (rows g and g + 8; 4 lanes share a row)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = tB[j * 8 + 2 * t], b1 = tB[j * 8 + 2 * t + 1];
      s[j][0] = s[j][0] * scale + b0;
      s[j][1] = s[j][1] * scale + b1;
      s[j][2] = s[j][2] * scale + b0;
      s[j][3] = s[j][3] * scale + b1;
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);  // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = expf(s[j][0] - m_run[0]);
      s[j][1] = expf(s[j][1] - m_run[0]);
      s[j][2] = expf(s[j][2] - m_run[1]);
      s[j][3] = expf(s[j][3] - m_run[1]);
      l_run[0] += s[j][0] + s[j][1];
      l_run[1] += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // context[16, DP] += P[16, BK] (bf16) @ V[BK, DP]
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t bv[4];  // B fragments of context columns n*8.. and n*8 + 8..
        ldmatrix_b_trans(bv, tV + kk * 16 * LD + n * 8, LD);
        mma_bf16(o[n], a, bv[0], bv[1]);
        mma_bf16(o[n + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles from now
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.0f / l;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    bf16* dst = out + base + (size_t)row * H;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < dh) dst[c] = __float2bfloat16(o[n][2 * r] * inv[r]);
      if (c + 1 < dh) dst[c + 1] = __float2bfloat16(o[n][2 * r + 1] * inv[r]);
    }
  }
}

template <int DP>
size_t smem_bytes() {
  return (size_t)(BQ + 4 * BK) * (DP + PAD) * sizeof(bf16) + 2 * BK * sizeof(float);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
           int S, int H, int heads, int dh, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, heads, B);
  attention_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(mask), static_cast<bf16*>(out), S, H, dh,
      1.0f / sqrtf(static_cast<float>(dh)));
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* comorag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, out: [B, S, H] bf16 contiguous, 16-byte aligned; mask: [B, S]
// int32 (1 = valid key); head dim H / heads <= 256. Returns a cudaError_t
// (0 on success). Launches on `stream`, never syncs.
extern "C" int comorag_encoder_attention_bf16(const void* q, const void* k, const void* v,
                                              const void* mask, void* out, int B, int S,
                                              int H, int heads, void* stream) {
  if (B <= 0 || S <= 0 || heads <= 0 || H % heads != 0) return cudaErrorInvalidValue;
  if (B > 65535 || heads > 65535) return cudaErrorInvalidValue;
  const int dh = H / heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((dh + 15) / 16) {
#define COMORAG_DP_CASE(n) \
    case n: return launch<16 * n>(q, k, v, mask, out, B, S, H, heads, dh, st);
    COMORAG_DP_CASE(1) COMORAG_DP_CASE(2) COMORAG_DP_CASE(3) COMORAG_DP_CASE(4)
    COMORAG_DP_CASE(5) COMORAG_DP_CASE(6) COMORAG_DP_CASE(7) COMORAG_DP_CASE(8)
    COMORAG_DP_CASE(9) COMORAG_DP_CASE(10) COMORAG_DP_CASE(11) COMORAG_DP_CASE(12)
    COMORAG_DP_CASE(13) COMORAG_DP_CASE(14) COMORAG_DP_CASE(15) COMORAG_DP_CASE(16)
#undef COMORAG_DP_CASE
    default: return cudaErrorInvalidValue;
  }
}
