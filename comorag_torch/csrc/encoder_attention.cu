// Bidirectional encoder self-attention for Hopper (sm_90a), bf16 in/out.
//
// Replaces: comorag_tpu/ops/pallas_attention.py:73 flash_encoder_attention
// (kernel _attn_kernel :49). Same contract: q, k, v and the context are
// [B, S, H] in the projections' native layout (H = heads * dh, head h is
// the column slice [h*dh, (h+1)*dh)), so no transpose exists anywhere in
// the layer; padded keys get a -1e30 bias in fp32, keys past S are -inf;
// the softmax runs in fp32; p is cast to bf16 for the p @ v product, whose
// fp32 sum is divided by the fp32 row sum, as the TPU kernel does. The
// softmax is online (FlashAttention): p is cast relative to the running
// row max, not the row's global max as the TPU kernel's single pass does;
// the two differ by bf16 roundings of p, inside the bf16 rule.
//
// What bounds it on the H100: at bert-base shapes (S = 512, dh = 64) the
// two products are 4*B*heads*S*S*dh FLOPs (51.5 GFLOP at B = 64) against
// ~4*B*S*H bytes of q/k/v/ctx, far above the card's ~295 FLOP/byte ridge:
// tensor-core bound, and at dh = 64 the exponentials (16 per SM clock on
// the MUFU unit) cost about as much SM time as the products.
//
// What the design does about it (FlashAttention-3's structure):
// - both products on wgmma: S = Q K^T as m64n64k16 from shared memory (Q
//   and K K-major), O += P V with P from registers (the fp32 scores turned
//   into bf16 A fragments in place) and V as an MN-major operand;
// - a block owns 128 query rows of one (batch row, head): one producer
//   warp and two consumer warpgroups of 64 rows each. The producer keeps a
//   ring of K/V tiles in flight with TMA (a 4-D tensor map over [B, S,
//   heads, dh] per head, 128-byte swizzle, so rows past S and columns past
//   dh land as zeros) and mbarriers; setmaxnreg moves its registers to the
//   consumers;
// - each consumer issues this tile's S product and the previous tile's
//   P V product back to back, then runs the softmax while the tensor cores
//   work; a pair of named barriers makes the two consumers take turns at
//   issuing (ping-pong), so one warpgroup's softmax overlaps the other's
//   products;
// - the softmax works in log2 units: s * (scale * log2 e) + bias * log2 e,
//   then exp2 (ex2.approx), with the row max and sum in registers and
//   quad shuffles;
// - key tiles after a batch row's last valid key are skipped: their
//   probabilities are exactly 0 in fp32 (exp of -1e30 below the row max),
//   so a padded batch costs its valid length, not S.
// The head dim is zero-padded to a multiple of 64 (the 128-byte swizzle
// atom); any dh up to 256 is taken. TMA needs rows of a multiple of 16
// bytes: where dh is not a multiple of 8 the producer warp writes the
// same swizzled tiles with plain loads and stores instead.

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

constexpr int BQ = 64;              // query rows per consumer warpgroup
constexpr float MASKED = -1e30f;    // pallas_attention.py:55
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ATOM_ROW = 128;       // bytes of one swizzled row: 64 bf16 columns

// ------------------------------------------------------------ primitives
// named barriers 1 and 2: the consumers' turns at the tensor cores
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -------------------------------------------------------------- the kernel
// D: head dim padded to a multiple of 64 (A = D / 64 swizzle atoms per
// row); BK: keys per tile; STAGES: K/V tiles in the ring; CONS: consumer
// warpgroups (64 query rows each) beside the producer warpgroup.
template <int D_, int BK_, int STAGES_, int CONS_>
struct Cfg {
  static constexpr int D = D_, BK = BK_, STAGES = STAGES_, CONS = CONS_;
  static constexpr int A = D / 64;
  static constexpr int THREADS = 128 * (1 + CONS);
  static constexpr int MIN_BLOCKS = CONS == 1 ? 3 : 1;  // blocks per SM the registers allow
  // setmaxnreg: a thread starts with CAP registers (what the launch bounds
  // leave); the producer keeps 40 and the consumers share the rest
  static constexpr int CAP = 65536 / (MIN_BLOCKS * THREADS) / 8 * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = (CAP * THREADS - 128 * PRODUCER_REGS) / (128 * CONS) / 8 * 8;
  static constexpr int Q_BYTES = BQ * D * 2;   // one consumer's Q tile
  static constexpr int KV_BYTES = BK * D * 2;  // one K (or V) tile
  static constexpr int OFF_K = CONS * Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BIAS = OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_BIAS + STAGES * BK * 4;
  static constexpr int OFF_TILES = OFF_BAR + (2 * STAGES + 2) * 8;   // two units' tile counts
  static constexpr int SMEM = OFF_TILES + 2 * 4 + 1024;               // + alignment slack
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* mask;
  bf16* out;
  int B, S, H, heads, dh;
  float scale_log2;  // scale * log2(e)
  int use_tma;
};

// The producer warp's plain-load path (dh % 8 != 0): rows [row0, row0 +
// rows) of one head into a tile of A swizzle atoms [rows][64], laid out as
// TMA writes them, zeros past S and past dh.
__device__ __forceinline__ void load_rows_plain(bf16* dst, const bf16* __restrict__ src, int row0, int rows,
                                                int cols, const Params& p) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < rows * cols; i += 32) {
    const int r = i / cols, c = i % cols;
    bf16 v = __float2bfloat16(0.f);
    if (row0 + r < p.S && c < p.dh) v = src[(size_t)(row0 + r) * p.H + c];
    dst[(c >> 6) * rows * 64 + swizzle128(r, (c & 63) * 2) / 2] = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
}

// S = Q K^T for the K tile at k_stage (shared addresses), one m64nBK
// product per 16-deep step (BK = 64 or 128); committed as one wgmma group.
// Column c of the scores is sc[c / 8 * 4 + ...] in the accumulator layout.
template <class C>
__device__ __forceinline__ void qk(float (&sc)[C::BK / 2], uint32_t q_addr, uint32_t k_stage) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::D / 16; ++kk) {
    const uint64_t a = sw128_desc(q_addr + (kk / 4) * BQ * ATOM_ROW + (kk % 4) * 32, 16, 8 * ATOM_ROW);
    const uint64_t b = sw128_desc(k_stage + (kk / 4) * C::BK * ATOM_ROW + (kk % 4) * 32, 16, 8 * ATOM_ROW);
    if constexpr (C::BK == 128)
      wgmma_ss128(sc, a, b, kk > 0);
    else
      wgmma_ss(sc, a, b, kk > 0);
  }
  wgmma_commit();
}

// O = O * alpha + P V, P in registers (bf16 A fragments), V the ring
// stage at v_stage; committed as one wgmma group.
template <class C>
__device__ __forceinline__ void pv(float (&o)[C::A][32], const float (&alpha)[2],
                                   const uint32_t (&pa)[C::BK / 16][4], uint32_t v_stage) {
#pragma unroll
  for (int a = 0; a < C::A; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] *= alpha[(i >> 1) & 1];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
    for (int a = 0; a < C::A; ++a)
      wgmma_rs(o[a], pa[kk],
               sw128_desc(v_stage + a * C::BK * ATOM_ROW + kk * 16 * ATOM_ROW, C::BK * ATOM_ROW, 8 * ATOM_ROW));
  wgmma_commit();
}

// Online softmax of one score tile in log2 units. This thread holds keys
// 8j + 2t (+1) of rows g and g + 8; the scores become exp2(x - m)
// in place, m and l are updated and alpha = exp2(m_old - m_new).
template <class C>
__device__ __forceinline__ void softmax(float (&sc)[C::BK / 2], const float* bias, float scale_log2, int t4,
                                        float (&m_run)[2], float (&l_run)[2], float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < C::BK / 8; ++j) {
    const float2 bj = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * t4);
    float* x = sc + 4 * j;
    x[0] = fmaf(x[0], scale_log2, bj.x);
    x[1] = fmaf(x[1], scale_log2, bj.y);
    x[2] = fmaf(x[2], scale_log2, bj.x);
    x[3] = fmaf(x[3], scale_log2, bj.y);
    mx[0] = fmaxf(mx[0], fmaxf(x[0], x[1]));
    mx[1] = fmaxf(mx[1], fmaxf(x[2], x[3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    alpha[r] = ex2(m_run[r] - m_new);  // 0 on the first tile
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < C::BK / 8; ++j) {
    float* x = sc + 4 * j;
    x[0] = ex2(x[0] - m_run[0]);
    x[1] = ex2(x[1] - m_run[0]);
    x[2] = ex2(x[2] - m_run[1]);
    x[3] = ex2(x[3] - m_run[1]);
    l_run[0] += x[0] + x[1];
    l_run[1] += x[2] + x[3];
  }
}

// The probabilities as the A fragments of P V: keys 16kk.. are the
// accumulator columns 8(2kk).. and 8(2kk+1)..
template <class C>
__device__ __forceinline__ void to_fragments(const float (&sc)[C::BK / 2], uint32_t (&pa)[C::BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
    const float* x = sc + 8 * kk;
    pa[kk][0] = pack_bf16(x[0], x[1]);
    pa[kk][1] = pack_bf16(x[2], x[3]);
    pa[kk][2] = pack_bf16(x[4], x[5]);
    pa[kk][3] = pack_bf16(x[6], x[7]);
  }
}

// A work unit is (query tile of 64 * CONS rows, head, batch row); units of
// one (batch row, head) are consecutive, so blocks running side by side
// share their K/V in L2. The grid is persistent: a block walks units
// blockIdx.x, + gridDim.x, ..., and its producer runs ahead into the next
// unit (its Q and first K/V tiles) while the consumers finish this one.
struct Unit {
  int q0, h, b;
  __device__ Unit(int w, int q_tiles, int heads, int rows) {
    q0 = (w % q_tiles) * rows;
    h = (w / q_tiles) % heads;
    b = w / (q_tiles * heads);
  }
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
attention_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + C::OFF_K);
  bf16* sV = reinterpret_cast<bf16*>(smem + C::OFF_V);
  float* sBias = reinterpret_cast<float*>(smem + C::OFF_BIAS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qfull = empty + C::STAGES;
  uint64_t* qempty = qfull + 1;
  int* unit_tiles = reinterpret_cast<int*>(smem + C::OFF_TILES);  // by unit parity

  constexpr int ROWS = BQ * C::CONS;
  const int q_tiles = (p.S + ROWS - 1) / ROWS;
  const int units = q_tiles * p.heads * p.B;
  const int all_tiles = (p.S + C::BK - 1) / C::BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * C::CONS);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 128 * C::CONS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int it = 0;  // K/V tiles loaded so far
    for (int w = blockIdx.x, n = 0; w < units; w += gridDim.x, ++n) {
      const Unit u(w, q_tiles, p.heads, ROWS);
      const size_t head0 = (size_t)u.b * p.S * p.H + (size_t)u.h * p.dh;
      mbar_wait(qempty, (n & 1) ^ 1);
      // key tiles past the row's last valid key add exp2(-1e30 * log2 e - m)
      // = 0 to every sum when the row has a valid key: they are skipped
      int last = -1;
      for (int j = lane; j < p.S; j += 32)
        if (p.mask[(size_t)u.b * p.S + j] > 0) last = j;
      last = __reduce_max_sync(0xffffffffu, last);
      const int n_tiles = last >= 0 ? last / C::BK + 1 : all_tiles;
      if (lane == 0) unit_tiles[n & 1] = n_tiles;
      __syncwarp();
      if (p.use_tma) {
        if (lane == 0) {
          mbar_expect_tx(qfull, C::CONS * C::Q_BYTES);
          for (int c = 0; c < C::CONS; ++c)
            for (int a = 0; a < C::A; ++a)
              tma_load_4d(reinterpret_cast<unsigned char*>(sQ) + c * C::Q_BYTES + a * BQ * ATOM_ROW, &qmap, qfull,
                          64 * a, u.h, u.q0 + c * BQ, u.b);
        }
      } else {
        for (int c = 0; c < C::CONS; ++c)
          load_rows_plain(sQ + c * BQ * C::D, p.q + head0, u.q0 + c * BQ, BQ, C::D, p);
        __syncwarp();
        if (lane == 0) mbar_arrive(qfull);
      }
      for (int kt = 0; kt < n_tiles; ++kt, ++it) {
        const int s = it % C::STAGES;
        mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        for (int j = lane; j < C::BK; j += 32) {  // bias in log2 units
          const int key = kt * C::BK + j;
          sBias[s * C::BK + j] =
              key < p.S ? (p.mask[(size_t)u.b * p.S + key] > 0 ? 0.f : MASKED * LOG2E) : -INFINITY;
        }
        if (p.use_tma) {
          __syncwarp();
          if (lane == 0) {
            mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
            unsigned char* dk = reinterpret_cast<unsigned char*>(sK) + s * C::KV_BYTES;
            unsigned char* dv = reinterpret_cast<unsigned char*>(sV) + s * C::KV_BYTES;
            for (int a = 0; a < C::A; ++a) {
              tma_load_4d(dk + a * C::BK * ATOM_ROW, &kmap, &full[s], 64 * a, u.h, kt * C::BK, u.b);
              tma_load_4d(dv + a * C::BK * ATOM_ROW, &vmap, &full[s], 64 * a, u.h, kt * C::BK, u.b);
            }
          }
        } else {
          load_rows_plain(sK + s * C::BK * C::D, p.k + head0, kt * C::BK, C::BK, C::D, p);
          load_rows_plain(sV + s * C::BK * C::D, p.v + head0, kt * C::BK, C::BK, C::D, p);
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
  const int c = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const uint32_t q_addr = smem_u32(sQ) + c * C::Q_BYTES;
  const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV);
  // Turns: consumer c waits on barrier 1 + c before it issues a tile's
  // products and hands over on barrier 2 - c after. Both walk the same
  // units and read the same tile counts, so the turns alternate strictly;
  // consumer 1's opening hand-over gives consumer 0 the first turn, and
  // consumer 0 takes consumer 1's last one after its loop.
  constexpr bool turns = C::CONS == 2;
  if (turns && c == 1) bar_arrive(1, 256);
  int it = 0;  // K/V tiles consumed so far

  for (int w = blockIdx.x, n = 0; w < units; w += gridDim.x, ++n) {
    const Unit u(w, q_tiles, p.heads, ROWS);
    float o[C::A][32];
#pragma unroll
    for (int a = 0; a < C::A; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[a][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // rows g8 and g8 + 8 of this warp's 16
    float l_run[2] = {0.f, 0.f};
    float alpha[2];
    uint32_t pa[C::BK / 16][4];  // the previous tile's P as bf16 A fragments
    float sc[C::BK / 2];

    // tile 0: its scores alone
    mbar_wait(qfull, n & 1);
    const int n_tiles = unit_tiles[n & 1];
    mbar_wait(&full[it % C::STAGES], (it / C::STAGES) & 1);
    if (turns) bar_sync(1 + c, 256);
    qk<C>(sc, q_addr, k_addr + (it % C::STAGES) * C::KV_BYTES);
    if (turns) bar_arrive(2 - c, 256);
    wgmma_wait<0>();
    softmax<C>(sc, sBias + (it % C::STAGES) * C::BK, p.scale_log2, t4, m_run, l_run, alpha);
    to_fragments<C>(sc, pa);
    ++it;

    // tile kt's scores and tile kt-1's P V go to the tensor cores together;
    // the softmax of tile kt runs while P V does
    for (int kt = 1; kt < n_tiles; ++kt, ++it) {
      const int s = it % C::STAGES, prev = (it - 1) % C::STAGES;
      mbar_wait(&full[s], (it / C::STAGES) & 1);
      if (turns) bar_sync(1 + c, 256);
      qk<C>(sc, q_addr, k_addr + s * C::KV_BYTES);
      pv<C>(o, alpha, pa, v_addr + prev * C::KV_BYTES);
      if (turns) bar_arrive(2 - c, 256);
      wgmma_wait<1>();
      softmax<C>(sc, sBias + s * C::BK, p.scale_log2, t4, m_run, l_run, alpha);
      wgmma_wait<0>();  // tile kt-1's P V is done: its stage is free
      mbar_arrive(&empty[prev]);
      to_fragments<C>(sc, pa);
    }
    mbar_arrive(qempty);  // every score product of this unit is done: Q may be refilled
    const int last = (it - 1) % C::STAGES;
    pv<C>(o, alpha, pa, v_addr + last * C::KV_BYTES);
    wgmma_wait<0>();
    mbar_arrive(&empty[last]);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.0f / l;
    }
    const bool pairs = (p.dh % 2) == 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = u.q0 + c * BQ + warp * 16 + g8 + 8 * r;
      if (row >= p.S) continue;
      bf16* dst = p.out + ((size_t)u.b * p.S + row) * p.H + (size_t)u.h * p.dh;
#pragma unroll
      for (int a = 0; a < C::A; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * a + 8 * j + 2 * t4;
          const float v0 = o[a][4 * j + 2 * r] * inv[r], v1 = o[a][4 * j + 2 * r + 1] * inv[r];
          if (pairs && col + 1 < p.dh) {
            *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(v0, v1);
          } else {
            if (col < p.dh) dst[col] = __float2bfloat16(v0);
            if (col + 1 < p.dh) dst[col + 1] = __float2bfloat16(v1);
          }
        }
    }
  }
  if (turns && c == 0) bar_sync(1, 256);  // consumer 1's last hand-over
}

// --------------------------------------------------------------- host side
// A 4-D map over one of q/k/v seen as [B][S][heads][dh] (innermost first:
// dh, heads, S, B), boxes of [rows][64] of one head with 128-byte swizzle;
// reads past S or past dh fill zeros.
cudaError_t head_map(CUtensorMap* map, const void* base, int B, int S, int H, int heads, int dh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)H * 2, (cuuint64_t)S * H * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box);
}

template <class C>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int S, int H,
           int heads, int dh, cudaStream_t stream) {
  Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
           static_cast<const int*>(mask), static_cast<bf16*>(out), B, S, H, heads, dh,
           LOG2E / sqrtf(static_cast<float>(dh)), dh % 8 == 0};
  CUtensorMap qmap{}, kmap{}, vmap{};
  if (p.use_tma) {
    cudaError_t err = head_map(&qmap, q, B, S, H, heads, dh, BQ);
    if (err == cudaSuccess) err = head_map(&kmap, k, B, S, H, heads, dh, C::BK);
    if (err == cudaSuccess) err = head_map(&vmap, v, B, S, H, heads, dh, C::BK);
    if (err != cudaSuccess) return err;
  }
  // per device, once: the SM count and the kernel's shared-memory limit
  static int sm_count[64] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (sm_count[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attention_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    sm_count[device] = sms;
  }
  const int sms = sm_count[device];
  const long long units = (long long)((S + BQ * C::CONS - 1) / (BQ * C::CONS)) * heads * B;
  if (units > (1ll << 31) - 1) return cudaErrorInvalidValue;
  const int grid = (int)(units < (long long)sms * C::MIN_BLOCKS ? units : (long long)sms * C::MIN_BLOCKS);
  attention_kernel<C><<<grid, C::THREADS, C::SMEM, stream>>>(qmap, kmap, vmap, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* comorag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, out: [B, S, H] bf16 contiguous, 16-byte aligned; mask: [B, S]
// int32 (1 = valid key); head dim H / heads <= 256. Returns a cudaError_t
// (0 on success). Launches on `stream`, never syncs.
extern "C" int comorag_encoder_attention_bf16(const void* q, const void* k, const void* v, const void* mask,
                                              void* out, int B, int S, int H, int heads, void* stream) {
  if (B <= 0 || S <= 0 || heads <= 0 || H % heads != 0) return cudaErrorInvalidValue;
  const int dh = H / heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one consumer (64 query rows a block, three blocks an SM) where a second
  // would hold no query row
  const bool one = S <= BQ;
  switch ((dh + 63) / 64) {
    case 1:
      return one ? launch<Cfg<64, 64, 2, 1>>(q, k, v, mask, out, B, S, H, heads, dh, st)
                 : launch<Cfg<64, 128, 3, 2>>(q, k, v, mask, out, B, S, H, heads, dh, st);
    case 2: return launch<Cfg<128, 64, 4, 2>>(q, k, v, mask, out, B, S, H, heads, dh, st);
    case 3: return launch<Cfg<192, 64, 3, 2>>(q, k, v, mask, out, B, S, H, heads, dh, st);
    case 4: return launch<Cfg<256, 64, 2, 2>>(q, k, v, mask, out, B, S, H, heads, dh, st);
    default: return cudaErrorInvalidValue;
  }
}
