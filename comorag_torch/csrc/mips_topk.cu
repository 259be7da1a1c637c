// Exact inner-product top-k streamed over an fp32, bf16 or int8 corpus, for
// Hopper (sm_90a).
//
// Replaces: comorag_tpu/ops/pallas_topk.py:121 pallas_mips_topk (kernel
// _mips_kernel :75, selection _extract_topk :50) and :210
// pallas_mips_topk_int8 (kernel _mips_kernel_int8 :173). Same contract: for
// each query the k largest inner products over the corpus rows, sorted by
// (score descending, row id ascending), so ties go to the lowest id; the
// [P, N] score matrix never reaches device memory. fp32 rows are scored
// exactly to fp32 on the TF32 tensor cores (3xTF32): each operand is split
// into tf32 hi + lo and a score is lo.hi + hi.lo + hi.hi with fp32 sums
// (the dropped lo.lo and the split's remainder are ~2^-22 of each product;
// the TPU kernel's bf16x3 split keeps ~16 bits of each operand). The sums
// are the tensor cores' own, which on the H100 measure as truncated, not
// rounded to nearest: at phase 6's shape a score lies up to 4.3e-7 from
// float64 (P = 16), about what an emulation rounding each mma sum toward
// zero gives (5.2e-7) and 6x one rounding to nearest (6.8e-8;
// scripts/tf32_emulation_error.py). That is within ops/mips.check_topk's
// 1e-5 rule; tests/test_torch_cuda.py holds the card to it. Calls outside
// that route's limits use FFMA with true fp32 products. bf16 and int8 rows
// are scored as the TPU kernels score them: the query rounded to bf16
// once, the row converted exactly (int8 -> float is exact), exact products,
// fp32 sums, and for int8 the per-row fp32 scale applied after the sum
// (ops/topk.py _int8_scan_dot).
//
// What bounds it on the H100: at the serving shape (P = 16 queries, N =
// 100,000 rows, d = 1024, k = 50) the fp32 kernel reads 410 MB of corpus for
// 3.3 GFLOP (8 FLOP/byte, far below the card's ridge), so it is bound by
// memory bandwidth (~0.12 ms at 3.35 TB/s); the int8 kernel reads 102 MB
// (~0.03 ms). At 256 queries the int8 rows need 52 GFLOP: 0.053 ms on the
// bf16 tensor cores; the fp32 rows need three tf32 products of it, 0.32 ms
// at the dense TF32 peak (495 TFLOP/s), where FFMA would take 0.78 ms.
// mma.sync reaches well under that peak on this card (PERF.md: ~40 % in
// m16n8k8 tf32), so at 256 queries the tf32 scan is bound by its products.
//
// What the design does about it. The TPU kernel walks the corpus axis in
// order for each query block and carries the running top-k in scratch; at
// P = 16 that is one grid row, about 1 % of this card. Here the corpus is
// split over blocks (blockIdx.y) so that each SM holds several blocks; the
// query blocks of one split are neighbours in the grid (blockIdx.x) and so
// read its rows from L2 together. Each query keeps an exact running top-k
// in shared memory plus a threshold (its current k-th best): a score that
// does not beat the threshold is dropped with one compare, and the few that
// do are appended and merged by one warp per query. Three scans fill the
// per-split lists, chosen by the caller (ops/mips.scan_route) and refused
// outside their limits. Two of them share one body (ring_scan): a [128
// rows x 32 queries] tile on mma.sync tensor cores, rows and queries
// streamed by TMA through a ring of stages, and merges (in registers) only
// of the candidate buffers that overflow. mma_scan_kernel (int8 rows, k <=
// 64, d % 16 == 0) multiplies in bf16, converting each int8 exactly at
// fragment load; tf32_scan_kernel (fp32 rows, k <= 64, d % 4 == 0, aligned
// rows and queries) multiplies in 3xTF32, splitting each row element at
// fragment load and each query once per call. scan_kernel (every other
// call: bf16 rows, k > 64, unaligned rows or d % 4 != 0) streams rows
// straight from L2 into registers, four rows and 8 queries per thread, and
// merges with the shared-memory warp_merge. A second kernel merges the
// splits, one block per query, reading the splits' lists rank by rank and
// stopping at the first rank where no list still beats the threshold.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"
#include "tma_sm90.cuh"

namespace {

constexpr int QB = 8;               // queries per block
constexpr int THREADS = 128;        // scan block
constexpr int ROWS = 4;             // corpus rows per thread per tile
constexpr int TILE = THREADS * ROWS;
constexpr int WARPS = THREADS / 32;
constexpr int DCH = 256;            // query features staged in shared memory at a time
constexpr int BLOCKS_PER_SM = 4;    // resident scan blocks per SM at k <= 64
constexpr int MERGE_THREADS = 128;  // second pass: candidates examined per step
constexpr int NONE_ID = 0x7fffffff; // id of an empty slot (score -inf)
// the tensor-core scans (ring_scan): [WBN rows x WQB queries] tiles, 8
// warps of 16 MMI rows x 32 queries, k bound WKMAX
constexpr int WQB = 32;             // queries per block
constexpr int WBN = 128;            // corpus rows per tile
constexpr int WKMAX = 64;           // k bound of the tensor-core scans
constexpr int WBLOCKS_PER_SM = 2;
constexpr int MMI = 1;                     // m16 row tiles a warp (2, 4 warps of 32 rows: slower)
constexpr int MTHREADS = WBN / (16 * MMI) * 32;  // warps of 16 MMI rows x 32 queries
constexpr int MSZ = WKMAX + WBN;           // slots a query: the top-k, one tile's appends
// int8 rows (mma_scan_kernel): bf16 query boxes (128-byte rows, swizzled)
// and int8 row boxes (64-byte rows)
constexpr int MBK = 64;                    // features per stage
constexpr int MSTAGES = 3;                 // stages in the ring
// fp32 rows (tf32_scan_kernel): the queries' tf32 hi and lo planes and the
// fp32 rows, TBK * 4-byte rows (swizzled at 128 bytes)
constexpr int TBK = 32;                    // features per stage (16 in rings of 3-5: slower)
constexpr int TSTAGES = 2;                 // stages in the ring (the most that fits two blocks an SM)
enum Route { ROUTE_SCAN = 0, ROUTE_TF32 = 1, ROUTE_MMA = 2 };  // ops/mips.SCAN_ROUTES

// (score desc, id asc): true when entry a ranks before entry b
__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__device__ __forceinline__ void compare_exchange(float* S, int* I, int lo, int hi, bool first) {
  const float sl = S[lo], sh = S[hi];
  const int il = I[lo], ih = I[hi];
  if (first ? better(sh, ih, sl, il) : better(sl, il, sh, ih)) {
    S[lo] = sh; S[hi] = sl;
    I[lo] = ih; I[hi] = il;
  }
}

// Bitonic sort of n (a power of two) (score, id) entries in shared memory,
// best first, by one warp.
__device__ void warp_sort(float* S, int* I, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < n / 2; t += 32) {
        const int lo = 2 * t - (t & (stride - 1));
        compare_exchange(S, I, lo, lo + stride, (lo & size) == 0);
      }
      __syncwarp();
    }
  }
}

// Entries of the sorted run R[0 .. n) that rank before (s, id).
__device__ __forceinline__ int rank_in(const float* RS, const int* RI, int n, float s, int id) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(RS[mid], RI[mid], s, id)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One query's slots: the sorted top-k list at [0, k), m <= APPEND unsorted
// candidates appended at [KMAX, KMAX + m), scratch at [KMAX + APPEND,
// KMAX + APPEND + k); every other slot empty. By one warp: sort the
// candidates, place each entry of either run at its index plus the number
// of entries of the other run that rank before it (merge path, by binary
// search), keep the first k, and empty the candidate slots again.
template <int KMAX, int APPEND>
__device__ void warp_merge(float* S, int* I, int k, int m, int lane) {
  float* cs = S + KMAX;
  int* ci = I + KMAX;
  float* ts = S + KMAX + APPEND;
  int* ti = I + KMAX + APPEND;
  int n2 = 1;
  while (n2 < m) n2 <<= 1;
  warp_sort(cs, ci, n2, lane);
  for (int j = lane; j < k; j += 32) {
    const int pos = j + rank_in(cs, ci, m, S[j], I[j]);
    if (pos < k) {
      ts[pos] = S[j];
      ti[pos] = I[j];
    }
  }
  for (int i = lane; i < m; i += 32) {
    const int pos = i + rank_in(S, I, k, cs[i], ci[i]);
    if (pos < k) {
      ts[pos] = cs[i];
      ti[pos] = ci[i];
    }
  }
  __syncwarp();
  for (int j = lane; j < k; j += 32) {
    S[j] = ts[j];
    I[j] = ti[j];
  }
  for (int i = lane; i < n2; i += 32) {
    cs[i] = -INFINITY;
    ci[i] = NONE_ID;
  }
  __syncwarp();
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[r][qq] += x[r] . q[qq][j .. j+3] for the thread's rows and the
// block's queries: one shared-memory load feeds 4 * ROWS FFMA
__device__ __forceinline__ void fma4(float (&acc)[ROWS][QB], const float4 (&x)[ROWS], const float* qs,
                                     int j) {
#pragma unroll
  for (int qq = 0; qq < QB; ++qq) {
    const float4 qv = *reinterpret_cast<const float4*>(qs + qq * DCH + j);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      acc[r][qq] = fmaf(x[r].x, qv.x, acc[r][qq]);
      acc[r][qq] = fmaf(x[r].y, qv.y, acc[r][qq]);
      acc[r][qq] = fmaf(x[r].z, qv.z, acc[r][qq]);
      acc[r][qq] = fmaf(x[r].w, qv.w, acc[r][qq]);
    }
  }
}

__device__ __forceinline__ void fma1(float (&acc)[ROWS][QB], const float (&x)[ROWS], const float* qs,
                                     int j) {
#pragma unroll
  for (int qq = 0; qq < QB; ++qq) {
    const float qv = qs[qq * DCH + j];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r][qq] = fmaf(x[r], qv, acc[r][qq]);
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ float4 bf16x4(uint32_t lo, uint32_t hi) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 int8x4(uint32_t w) {
  return make_float4(static_cast<float>(static_cast<int8_t>(w & 0xff)),
                     static_cast<float>(static_cast<int8_t>((w >> 8) & 0xff)),
                     static_cast<float>(static_cast<int8_t>((w >> 16) & 0xff)),
                     static_cast<float>(static_cast<int8_t>(w >> 24)));
}

// Features [4g, 4g + 4) of a 16-byte word of a row, as floats (exact).
__device__ __forceinline__ float4 word_group(const uint4 w, int, float) {
  return make_float4(__uint_as_float(w.x), __uint_as_float(w.y), __uint_as_float(w.z),
                     __uint_as_float(w.w));
}
__device__ __forceinline__ float4 word_group(const uint4 w, int g, __nv_bfloat16) {
  return g == 0 ? bf16x4(w.x, w.y) : bf16x4(w.z, w.w);
}
__device__ __forceinline__ float4 word_group(const uint4 w, int g, int8_t) {
  return int8x4(g == 0 ? w.x : g == 1 ? w.y : g == 2 ? w.z : w.w);
}

// acc[r] += rows[r][0 .. len) . qs[:, 0 .. len). VEC: rows are 16-byte
// aligned and len is a multiple of the 16-byte width; four words of each
// row are loaded before their products (64 bytes per row in flight).
template <typename RowT, bool VEC>
__device__ __forceinline__ void accumulate(float (&acc)[ROWS][QB], const RowT* const (&rows)[ROWS],
                                           int len, const float* qs) {
  if (VEC) {
    constexpr int W = 16 / sizeof(RowT);  // features per word
    constexpr int G = W / 4;              // float4 groups per word
    int j = 0;
    for (; j + 4 * W <= len; j += 4 * W) {
      uint4 w[4][ROWS];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) w[u][r] = __ldg(reinterpret_cast<const uint4*>(rows[r] + j) + u);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float4 x[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) x[r] = word_group(w[u][r], g, RowT());
          fma4(acc, x, qs, j + u * W + 4 * g);
        }
    }
    for (; j < len; j += W) {
      uint4 w[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) w[r] = __ldg(reinterpret_cast<const uint4*>(rows[r] + j));
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float4 x[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) x[r] = word_group(w[r], g, RowT());
        fma4(acc, x, qs, j + 4 * g);
      }
    }
  } else {
    for (int j = 0; j < len; ++j) {
      float x[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) x[r] = to_float(rows[r][j]);
      fma1(acc, x, qs, j);
    }
  }
}

// Stage features [d0, d0 + len) of the block's queries in shared memory
// (rounded to bf16 for bf16 / int8 rows; absent queries are zero). QVEC:
// d % 4 == 0 and q is 16-byte aligned, so every thread issues all of its
// 16-byte loads before its first store.
template <bool ROUND>
__device__ __forceinline__ void load_queries(float* qs, const float* __restrict__ q, int qb0, int nq,
                                             int d, int d0, int len, bool qvec) {
  if (qvec) {
    constexpr int PER = QB * DCH / 4 / THREADS;
    float4 v[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = (u * THREADS + threadIdx.x) * 4;
      const int qq = e / DCH, j = e % DCH;
      v[u] = (qq < nq && j < len)
                 ? __ldg(reinterpret_cast<const float4*>(q + (size_t)(qb0 + qq) * d + d0 + j))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      if (ROUND) {
        v[u].x = round_bf16(v[u].x);
        v[u].y = round_bf16(v[u].y);
        v[u].z = round_bf16(v[u].z);
        v[u].w = round_bf16(v[u].w);
      }
      *reinterpret_cast<float4*>(qs + (u * THREADS + threadIdx.x) * 4) = v[u];
    }
  } else {
    for (int e = threadIdx.x; e < QB * DCH; e += THREADS) {
      const int qq = e / DCH, j = e % DCH;
      float v = 0.f;
      if (qq < nq && j < len) {
        v = q[(size_t)(qb0 + qq) * d + d0 + j];
        if (ROUND) v = round_bf16(v);
      }
      qs[e] = v;
    }
  }
}

// slots per query: the running top-k, one round of appends, merge scratch
template <int KMAX, int APPEND = THREADS>
__host__ __device__ constexpr int scan_slots() { return 2 * KMAX + APPEND; }

template <int KMAX>
size_t scan_smem_bytes() {
  return (size_t)QB * DCH * sizeof(float) + (size_t)QB * scan_slots<KMAX>() * 8 + 3 * QB * 4;
}

// Pass 1: grid (query blocks, splits). Writes the split's k best rows per
// query, best first, to cand_[s|i][P, splits, k] (empty slots: -inf,
// NONE_ID).
template <typename RowT, bool VEC, int KMAX>
__global__ void __launch_bounds__(THREADS, 4)
scan_kernel(const float* __restrict__ q, const RowT* __restrict__ corpus,
            const float* __restrict__ scales, int P, int N, int d, int k, int rows_per_split,
            float* __restrict__ cand_s, int* __restrict__ cand_i) {
  constexpr int SZ = scan_slots<KMAX>();
  constexpr bool ROUND = sizeof(RowT) != sizeof(float);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [QB][DCH]
  float* ls = qs + QB * DCH;                        // [QB][SZ] list scores
  int* li = reinterpret_cast<int*>(ls + QB * SZ);   // [QB][SZ] list ids
  float* th_s = reinterpret_cast<float*>(li + QB * SZ);
  int* th_i = reinterpret_cast<int*>(th_s + QB);
  int* cnt = th_i + QB;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qb0 = blockIdx.x * QB;
  const int nq = min(QB, P - qb0);
  const int split = blockIdx.y, splits = gridDim.y;
  const int row0 = split * rows_per_split;
  const int row_end = min(N, row0 + rows_per_split);
  const bool qvec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;

  // slots [0, k): the running top-k; [KMAX, KMAX + THREADS): one round's
  // appended candidates; then the merge scratch (warp_merge)
  for (int e = tid; e < QB * SZ; e += THREADS) {
    ls[e] = -INFINITY;
    li[e] = NONE_ID;
  }
  if (tid < QB) {
    th_s[tid] = -INFINITY;
    th_i[tid] = NONE_ID;
    cnt[tid] = 0;
  }
  const bool one_chunk = d <= DCH;
  if (one_chunk) load_queries<ROUND>(qs, q, qb0, nq, d, 0, d, qvec);
  __syncthreads();

  for (int t0 = row0; t0 < row_end; t0 += TILE) {
    float acc[ROWS][QB];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int qq = 0; qq < QB; ++qq) acc[r][qq] = 0.f;
    for (int d0 = 0; d0 < d; d0 += DCH) {
      const int len = min(DCH, d - d0);
      if (!one_chunk) {
        __syncthreads();
        load_queries<ROUND>(qs, q, qb0, nq, d, d0, len, qvec);
        __syncthreads();
      }
      // rows past the split's end read its last row; their sums are dropped
      const RowT* rp[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        rp[r] = corpus + (size_t)min(t0 + r * THREADS + tid, row_end - 1) * d + d0;
      accumulate<RowT, VEC>(acc, rp, len, qs);
    }
    // one append + merge round per row of the thread: at most THREADS
    // appends per query between merges
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = t0 + r * THREADS + tid;
      if (row < row_end) {
        const float scale = scales != nullptr ? scales[row] : 1.f;
#pragma unroll
        for (int qq = 0; qq < QB; ++qq) {
          const float s = scales != nullptr ? acc[r][qq] * scale : acc[r][qq];
          if (qq < nq && better(s, row, th_s[qq], th_i[qq])) {
            const int pos = atomicAdd(&cnt[qq], 1);
            ls[qq * SZ + KMAX + pos] = s;
            li[qq * SZ + KMAX + pos] = row;
          }
        }
      }
      __syncthreads();
      for (int qq = warp; qq < nq; qq += WARPS) {
        const int m = cnt[qq];
        if (m > 0) {
          float* S = ls + qq * SZ;
          int* I = li + qq * SZ;
          warp_merge<KMAX, THREADS>(S, I, k, m, lane);
          if (lane == 0) {
            th_s[qq] = S[k - 1];
            th_i[qq] = I[k - 1];
            cnt[qq] = 0;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int qq = 0; qq < nq; ++qq) {
    const size_t base = ((size_t)(qb0 + qq) * splits + split) * k;
    for (int e = tid; e < k; e += THREADS) {
      cand_s[base + e] = ls[qq * SZ + e];
      cand_i[base + e] = li[qq * SZ + e];
    }
  }
}

// Four int8 values (bytes of w, the lowest first) as two bf16 pairs, exactly:
// each byte b becomes the fp32 2^23 + (b + 128) by its bits, minus
// 2^23 + 128; an integer of at most 8 significant bits is exact in bf16, so
// its bf16 is the fp32's upper half. lo = (byte 0, byte 1), hi = (2, 3),
// the lower byte in the low half.
__device__ __forceinline__ void int8x4_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // b + 128, unsigned
  constexpr float MAGIC = 8388736.f;   // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - MAGIC;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - MAGIC;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - MAGIC;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - MAGIC;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Compare-exchange of an entry held by this lane with the entry of the
// same register in lane ^ stride (a bitonic network over shuffles): the lane
// keeps the better of the two when want_better, else the worse.
__device__ __forceinline__ void lane_exchange(float& s, int& i, int stride, bool want_better) {
  const float os = __shfl_xor_sync(0xffffffffu, s, stride);
  const int oi = __shfl_xor_sync(0xffffffffu, i, stride);
  if (better(s, i, os, oi) != want_better) {
    s = os;
    i = oi;
  }
}

// One query's merge by one warp, in registers: the m <= 128 appended
// candidates at slots [KMAX, KMAX + m) are sorted best first by a bitonic
// network over 4 registers a lane (element r * 32 + lane), their best 64
// are merged with the sorted top-k at [0, KMAX) (empty slots -inf) by one
// bitonic half-cleaner and a 64-element bitonic merge, and the first k
// written back. The same result as warp_merge, whose shared-memory
// sort and binary-search ranks cost the tensor-core scan half its time;
// the candidate slots are not emptied (the caller's count says which are
// live). Not inlined: one copy of the network serves both call sites
// (measured on the H100, PERF.md: the fp32 tensor-core scan 7 % faster at
// P = 256, the int8 one level).
template <int KMAX>
__device__ __noinline__ void warp_merge_regs(float* S, int* I, int k, int m, int lane) {
  static_assert(KMAX == 64, "two list entries a lane");
  float v[4];
  int id[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = 32 * r + lane;
    v[r] = e < m ? S[KMAX + e] : -INFINITY;
    id[r] = e < m ? I[KMAX + e] : NONE_ID;
  }
#pragma unroll
  for (int size = 2; size <= 128; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int R = stride >> 5;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r & R) continue;
          const bool best_first = ((32 * r) & size) == 0;
          if (better(v[r | R], id[r | R], v[r], id[r]) == best_first) {
            const float ts = v[r];
            const int ti = id[r];
            v[r] = v[r | R];
            id[r] = id[r | R];
            v[r | R] = ts;
            id[r | R] = ti;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const bool best_first = ((32 * r + lane) & size) == 0;
          lane_exchange(v[r], id[r], stride, ((lane & stride) == 0) == best_first);
        }
      }
    }
  }
  // the list (best first) followed by the candidates' best 64 reversed is
  // bitonic: the better of entries i and i + 64 are the best 64 of both
  float ms[2];
  int mi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float cs = __shfl_sync(0xffffffffu, v[1 - r], 31 - lane);
    const int ci = __shfl_sync(0xffffffffu, id[1 - r], 31 - lane);
    const float s = S[32 * r + lane];
    const int i = I[32 * r + lane];
    const bool keep = better(s, i, cs, ci);
    ms[r] = keep ? s : cs;
    mi[r] = keep ? i : ci;
  }
  if (better(ms[1], mi[1], ms[0], mi[0])) {
    const float ts = ms[0];
    const int ti = mi[0];
    ms[0] = ms[1];
    mi[0] = mi[1];
    ms[1] = ts;
    mi[1] = ti;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) lane_exchange(ms[r], mi[r], stride, (lane & stride) == 0);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (32 * r + lane < k) {
      S[32 * r + lane] = ms[r];
      I[32 * r + lane] = mi[r];
    }
  __syncwarp();
}

// Queries rounded to bf16 once, for the int8 scan's TMA boxes (n a multiple
// of 4, both pointers 16-byte aligned).
__global__ void bf16_queries_kernel(const float* __restrict__ q, __nv_bfloat16* __restrict__ out, int n) {
  for (int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x); i < n; i += 4 * gridDim.x * blockDim.x) {
    const float4 v = *reinterpret_cast<const float4*>(q + i);
    uint2 packed;
    packed.x = comorag::pack_bf16(v.x, v.y);
    packed.y = comorag::pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(out + i) = packed;
  }
}

// Queries split once into their tf32 hi and lo planes, for the tf32 scan's
// TMA boxes (n a multiple of 4, the pointers 16-byte aligned).
__global__ void tf32_queries_kernel(const float* __restrict__ q, float* __restrict__ hi, float* __restrict__ lo,
                                    int n) {
  for (int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x); i < n; i += 4 * gridDim.x * blockDim.x) {
    const float4 v = *reinterpret_cast<const float4*>(q + i);
    uint4 h, l;
    comorag::split_tf32(v.x, h.x, l.x);
    comorag::split_tf32(v.y, h.y, l.y);
    comorag::split_tf32(v.z, h.z, l.z);
    comorag::split_tf32(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + i) = h;
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

// A stage of the tensor-core scans' ring, by row type: BK features of the
// block's WQB queries (Q_BYTES: bf16 for int8 rows; the tf32 hi plane, then
// the lo plane, for fp32 rows), then of its WBN rows (X_BYTES).
template <typename RowT>
struct Stage;
template <>
struct Stage<int8_t> {
  static constexpr int BK = MBK, COUNT = MSTAGES;
  static constexpr int Q_ROW = BK * 2, X_ROW = BK;  // bytes of a query row and a corpus row
  static constexpr int Q_BYTES = WQB * Q_ROW, X_BYTES = WBN * X_ROW;
};
template <>
struct Stage<float> {
  static constexpr int BK = TBK, COUNT = TSTAGES;
  static constexpr int Q_ROW = BK * 4, X_ROW = BK * 4;
  static constexpr int Q_BYTES = 2 * WQB * Q_ROW, X_BYTES = WBN * X_ROW;
};

// Byte offset of 16-byte piece `piece` of row r in a box of ROW-byte rows
// as TMA writes it: 128-byte rows with CU_TENSOR_MAP_SWIZZLE_128B (the box
// 1024-byte aligned), narrower rows unswizzled. Either way the quarter warp
// of lanes (g, t), g in {0, 1}, reading piece (128 / ROW) t + p of rows g and
// g + 1 (mod 8) hits every bank once.
template <int ROW>
__device__ __forceinline__ int box_at(int r, int piece) {
  static_assert(ROW == 128 || ROW == 64, "rows of 64 or 128 bytes");
  return ROW == 128 ? comorag::swizzle128(r, 16 * piece) : r * ROW + 16 * piece;
}
constexpr CUtensorMapSwizzle box_swizzle(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
}

template <typename RowT>
constexpr size_t ring_smem_bytes() {
  return (size_t)Stage<RowT>::COUNT * (Stage<RowT>::Q_BYTES + Stage<RowT>::X_BYTES) + (size_t)WQB * MSZ * 8 +
         3 * WQB * 4 + 2 * Stage<RowT>::COUNT * 8 + 1024;  // + alignment slack
}
static_assert(Stage<int8_t>::Q_BYTES % 1024 == 0 && (Stage<int8_t>::Q_BYTES + Stage<int8_t>::X_BYTES) % 1024 == 0 &&
                  Stage<float>::Q_BYTES % 1024 == 0 && (Stage<float>::Q_BYTES + Stage<float>::X_BYTES) % 1024 == 0,
              "swizzled boxes 1024-byte aligned");
static_assert((3 * WQB * 4) % 8 == 0 && (WQB * MSZ * 8) % 8 == 0, "barriers 8-byte aligned");
static_assert(WBLOCKS_PER_SM * (ring_smem_bytes<int8_t>() + 1024) <= 233472 &&
                  WBLOCKS_PER_SM * (ring_smem_bytes<float>() + 1024) <= 233472,
              "WBLOCKS_PER_SM tensor-core scan blocks an SM");

// int8 rows: the products of one stage on mma.sync m16n8k16 bf16 tiles. The
// K order is permuted, the same for A and B: lane (g, t) loads 16 bytes of
// each of its rows (features 16t .. 16t + 15, conflict-free: a quarter warp
// reads two whole 64-byte rows) and 32 bytes of its query from the 128-byte
// swizzled box (conflict-free), and k step s of the chunk takes features
// 16t + 4s .. 16t + 4s + 3 as the k pairs (2t, 2t + 1) and (2t + 8, 2t + 9);
// only the order of the sum changes. int8 -> bf16 is exact (int8x4_bf16),
// once per element per block, at fragment load: the bytes cross L2 at 1
// byte a feature. release() once the warp's fragments are in registers.
template <class Release>
__device__ __forceinline__ void chunk_products(float (&acc)[MMI][4][4], float (&)[MMI][4][4], const unsigned char* st,
                                               int r0, int q_tiles, int g, int t, Release release, int8_t) {
  uint4 xa[MMI][2];  // rows r0 + 16 mi + 8h, bytes 16t .. 16t + 15
#pragma unroll
  for (int mi = 0; mi < MMI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      xa[mi][h] = *reinterpret_cast<const uint4*>(st + Stage<int8_t>::Q_BYTES + (r0 + 16 * mi + 8 * h) * MBK + 16 * t);
  uint4 qf[4][2];  // query 8 nj + g, features 16t .. 16t + 7 and 16t + 8 .. 16t + 15
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
    if (nj < q_tiles) {
      qf[nj][0] = *reinterpret_cast<const uint4*>(st + comorag::swizzle128(8 * nj + g, 32 * t));
      qf[nj][1] = *reinterpret_cast<const uint4*>(st + comorag::swizzle128(8 * nj + g, 32 * t + 16));
    }
  release();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t a[MMI][4];
#pragma unroll
    for (int mi = 0; mi < MMI; ++mi) {
      // row g: k (2t, 2t + 1), (2t + 8, 2t + 9); row g + 8: the same
      int8x4_bf16(reinterpret_cast<const uint32_t*>(&xa[mi][0])[s], a[mi][0], a[mi][2]);
      int8x4_bf16(reinterpret_cast<const uint32_t*>(&xa[mi][1])[s], a[mi][1], a[mi][3]);
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
      if (nj < q_tiles) {
        const uint32_t* qw = reinterpret_cast<const uint32_t*>(&qf[nj][s >> 1]);
#pragma unroll
        for (int mi = 0; mi < MMI; ++mi) comorag::mma_bf16(acc[mi][nj], a[mi], qw[2 * (s & 1)], qw[2 * (s & 1) + 1]);
      }
  }
}

// fp32 rows: the products of one stage in 3xTF32 on mma.sync m16n8k8 tf32
// tiles: hi.hi into acc, the cross terms lo.hi and hi.lo into a second fp32
// sum (cross), which the caller adds to acc after the tile. Measured on the
// H100 (PERF.md) this holds the scores closer to float64 than CUTLASS's
// order (cross terms before hi.hi into one sum): 5.4e-7 against 1.5e-6 at
// bench shape and P = 256, and no slower: with truncated mma sums, the
// small cross terms lose less in a sum of their own. The K order is permuted, the same for A and
// B: lane (g, t) reads 16-byte piece (TBK / 16) t + p of each of its rows
// and of its query's hi and lo rows (conflict-free, box_at), and k step s
// of the piece takes its features 2s and 2s + 1 as k t and t + 4. Rows are
// split into hi and lo at fragment load, three instructions an element,
// once per element per block: they cross L2 at 4 bytes a feature.
template <class Release>
__device__ __forceinline__ void chunk_products(float (&acc)[MMI][4][4], float (&cross)[MMI][4][4],
                                               const unsigned char* st, int r0, int q_tiles, int g, int t,
                                               Release release, float) {
  constexpr int ROW = Stage<float>::Q_ROW, PIECES = TBK / 16;
  const unsigned char* lo_plane = st + WQB * ROW;
  const unsigned char* rows = st + Stage<float>::Q_BYTES;
#pragma unroll
  for (int p = 0; p < PIECES; ++p) {
    const int piece = PIECES * t + p;
    float4 x[MMI][2], qh[4], ql[4];  // rows r0 + 16 mi + 8h; query 8 nj + g
#pragma unroll
    for (int mi = 0; mi < MMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        x[mi][h] = *reinterpret_cast<const float4*>(rows + box_at<ROW>(r0 + 16 * mi + 8 * h, piece));
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
      if (nj < q_tiles) {
        qh[nj] = *reinterpret_cast<const float4*>(st + box_at<ROW>(8 * nj + g, piece));
        ql[nj] = *reinterpret_cast<const float4*>(lo_plane + box_at<ROW>(8 * nj + g, piece));
      }
    if (p == PIECES - 1) release();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t ahi[MMI][4], alo[MMI][4];
#pragma unroll
      for (int mi = 0; mi < MMI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // a_e: row g + 8 (e & 1), k t + 4 (e >> 1)
          comorag::split_tf32(reinterpret_cast<const float*>(&x[mi][e & 1])[2 * s + (e >> 1)], ahi[mi][e], alo[mi][e]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        if (nj < q_tiles) {
          const uint32_t* h = reinterpret_cast<const uint32_t*>(&qh[nj]) + 2 * s;
          const uint32_t* l = reinterpret_cast<const uint32_t*>(&ql[nj]) + 2 * s;
#pragma unroll
          for (int mi = 0; mi < MMI; ++mi) {
            comorag::mma_tf32(cross[mi][nj], alo[mi], h[0], h[1]);
            comorag::mma_tf32(cross[mi][nj], ahi[mi], l[0], l[1]);
            comorag::mma_tf32(acc[mi][nj], ahi[mi], h[0], h[1]);
          }
        }
    }
  }
}

// Pass 1 on the tensor cores, the body of mma_scan_kernel (int8 rows) and
// tf32_scan_kernel (fp32 rows): a [WBN rows x WQB queries] tile, the rows
// the m16 A operand and the queries the n8 B operand; each of the 8 warps
// owns 16 rows x 32 queries (4 n8 tiles, 16 fp32 sums a thread), and n8
// tiles that hold no query are skipped (P = 16 fills two). The selection is
// what the first design (4 warps, a merge of every query after every tile)
// spent two thirds of its time on (PERF.md): here 8 warps share it, a
// query's buffer is merged only when it overflows, and the merge runs in
// registers (warp_merge_regs). Streaming: thread 0 keeps a ring of stages
// in flight by TMA, each BK features of the rows and of the block's
// queries (prepared once a call by bf16_queries_kernel or
// tf32_queries_kernel) as Stage<RowT> lays them out, completing on a full
// barrier; each warp arrives on the stage's empty barrier once its
// fragments are in registers, and the stage is refilled COUNT chunks
// ahead, across tile ends, so that the next tile's first stages load while
// this tile's scores are merged. TMA, not cp.async: one thread issues a
// stage's boxes with no per-thread address work or registers, and the
// out-of-bounds zero fill pads the last tile's rows, the last chunk's
// features and absent queries. After each tile the scores (int8: times the
// row's fp32 scale) are appended when they beat the threshold of the
// query's last merge; a candidate that finds its buffer full waits in the
// thread's registers while the full buffers are merged, and every buffer
// is merged once at the end. A row's score is the same sequence of
// operations wherever it sits in a tile or a split, so identical rows tie
// exactly and go to the lowest id.
template <typename RowT>
__device__ __forceinline__ void ring_scan(const CUtensorMap& qmap, const CUtensorMap& xmap,
                                          const float* __restrict__ scales, int P, int N, int d, int k,
                                          int rows_per_split, float* __restrict__ cand_s, int* __restrict__ cand_i) {
  using ST = Stage<RowT>;
  constexpr int STAGES = ST::COUNT, STAGE = ST::Q_BYTES + ST::X_BYTES;
  constexpr int SZ = MSZ;
  constexpr int WARPS_M = MTHREADS / 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* ls = reinterpret_cast<float*>(ring + STAGES * STAGE);  // [WQB][SZ] list scores
  int* li = reinterpret_cast<int*>(ls + WQB * SZ);              // [WQB][SZ] list ids
  float* th_s = reinterpret_cast<float*>(li + WQB * SZ);
  int* th_i = reinterpret_cast<int*>(th_s + WQB);
  int* cnt = th_i + WQB;
  uint64_t* full = reinterpret_cast<uint64_t*>(cnt + WQB);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qb0 = blockIdx.x * WQB;
  const int nq = min(WQB, P - qb0);
  const int q_tiles = (nq + 7) / 8;  // n8 tiles that hold a query
  const int split = blockIdx.y, splits = gridDim.y;
  const int row0 = split * rows_per_split;
  const int row_end = min(N, row0 + rows_per_split);
  const int chunks = (d + ST::BK - 1) / ST::BK;  // stages a tile
  const int tiles = (row_end - row0 + WBN - 1) / WBN;
  const int total = tiles * chunks;

  for (int e = tid; e < WQB * SZ; e += MTHREADS) {
    ls[e] = -INFINITY;
    li[e] = NONE_ID;
  }
  if (tid < WQB) {
    th_s[tid] = -INFINITY;
    th_i[tid] = NONE_ID;
    cnt[tid] = 0;
  }
  // chunk c of the block (tile c / chunks, features from (c % chunks) * BK)
  // into stage c % STAGES
  auto issue = [&](int c) {
    unsigned char* st = ring + (c % STAGES) * STAGE;
    uint64_t* bar = &full[c % STAGES];
    const int f0 = (c % chunks) * ST::BK;
    comorag::mbar_expect_tx(bar, STAGE);
    comorag::tma_load_3d(st, &qmap, bar, f0, qb0, 0);
    comorag::tma_load_2d(st + ST::Q_BYTES, &xmap, bar, f0, row0 + (c / chunks) * WBN);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      comorag::mbar_init(&full[s], 1);
      comorag::mbar_init(&empty[s], WARPS_M);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < STAGES && c < total; ++c) issue(c);
  }
  __syncthreads();

  int c = 0;
  for (int t0 = row0; t0 < row_end; t0 += WBN) {
    // lane (g, t) holds rows t0 + r0 + 16 mi + 8h + g and queries 8 nj + 2t + e
    // as acc[mi][nj][2h + e]
    const int r0 = 16 * MMI * warp + g;
    float scale[MMI][2];
#pragma unroll
    for (int mi = 0; mi < MMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = t0 + r0 + 16 * mi + 8 * h;
        scale[mi][h] = scales != nullptr && row < row_end ? __ldg(scales + row) : 1.f;
      }
    float acc[MMI][4][4], cross[MMI][4][4];  // cross: the tf32 products' cross terms (unused for int8)
#pragma unroll
    for (int mi = 0; mi < MMI; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = cross[mi][nj][e] = 0.f;
    for (int ch = 0; ch < chunks; ++ch, ++c) {
      const int slot = c % STAGES;
      const uint32_t parity = (c / STAGES) & 1;
      comorag::mbar_wait(&full[slot], parity);
      chunk_products(acc, cross, ring + slot * STAGE, r0, q_tiles, g, t, [&] {
        __syncwarp();
        if (lane == 0) comorag::mbar_arrive(&empty[slot]);
        if (tid == 0 && c + STAGES < total) {  // refill the stage once every warp has read it
          comorag::mbar_wait(&empty[slot], parity);
          issue(c + STAGES);
        }
        __syncwarp();
      }, RowT());
    }
    if constexpr (sizeof(RowT) == 4) {
#pragma unroll
      for (int mi = 0; mi < MMI; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] += cross[mi][nj][e];
    }
    // appends against the threshold of the query's last merge; a candidate
    // that finds its query's buffer full stays pending, the full buffers
    // are merged, and the pending candidates are tried again
    static_assert(MMI * 16 <= 32, "a pending bit a candidate");
    uint32_t pending = 0;  // bit 16 mi + 4 nj + 2 e + h
#pragma unroll
    for (int mi = 0; mi < MMI; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (8 * nj + 2 * t + e < nq && t0 + r0 + 16 * mi + 8 * h < row_end)
              pending |= 1u << (16 * mi + 4 * nj + 2 * e + h);
    for (;;) {
#pragma unroll
      for (int mi = 0; mi < MMI; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t bit = 1u << (16 * mi + 4 * nj + 2 * e + h);
              if (!(pending & bit)) continue;
              const int qq = 8 * nj + 2 * t + e;
              const int row = t0 + r0 + 16 * mi + 8 * h;
              const float sc = acc[mi][nj][2 * h + e] * scale[mi][h];
              if (!better(sc, row, th_s[qq], th_i[qq])) {
                pending &= ~bit;
                continue;
              }
              const int pos = atomicAdd(&cnt[qq], 1);
              if (pos < WBN) {
                ls[qq * SZ + WKMAX + pos] = sc;
                li[qq * SZ + WKMAX + pos] = row;
                pending &= ~bit;
              }
            }
      if (!__syncthreads_or(pending != 0)) break;
      for (int qq = warp; qq < nq; qq += WARPS_M) {
        if (cnt[qq] > WBN) {
          float* S = ls + qq * SZ;
          int* I = li + qq * SZ;
          warp_merge_regs<WKMAX>(S, I, k, WBN, lane);
          if (lane == 0) {
            th_s[qq] = S[k - 1];
            th_i[qq] = I[k - 1];
            cnt[qq] = 0;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int qq = warp; qq < nq; qq += WARPS_M) {
    const int m = cnt[qq];
    if (m > 0) warp_merge_regs<WKMAX>(ls + qq * SZ, li + qq * SZ, k, m, lane);
  }
  __syncthreads();

  for (int qq = 0; qq < nq; ++qq) {
    const size_t base = ((size_t)(qb0 + qq) * splits + split) * k;
    for (int e = tid; e < k; e += MTHREADS) {
      cand_s[base + e] = ls[qq * SZ + e];
      cand_i[base + e] = li[qq * SZ + e];
    }
  }
}

// Pass 1 over int8 rows (k <= WKMAX, d % 16 == 0, 16-byte aligned rows):
// ring_scan with bf16 products.
__global__ void __launch_bounds__(MTHREADS, WBLOCKS_PER_SM)
mma_scan_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap xmap,
                const float* __restrict__ scales, int P, int N, int d, int k, int rows_per_split,
                float* __restrict__ cand_s, int* __restrict__ cand_i) {
  ring_scan<int8_t>(qmap, xmap, scales, P, N, d, k, rows_per_split, cand_s, cand_i);
}

// Pass 1 over fp32 rows (k <= WKMAX, d % 4 == 0, 16-byte aligned rows and
// queries): ring_scan with 3xTF32 products.
__global__ void __launch_bounds__(MTHREADS, WBLOCKS_PER_SM)
tf32_scan_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap xmap, int P, int N,
                 int d, int k, int rows_per_split, float* __restrict__ cand_s, int* __restrict__ cand_i) {
  ring_scan<float>(qmap, xmap, nullptr, P, N, d, k, rows_per_split, cand_s, cand_i);
}

// Pass 2: one block per query merges the splits' sorted lists into the
// final top-k. Rank r of every list is examined before rank r + 1; once no
// list's rank-r entry beats the threshold, no later entry can.
template <int KMAX>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* __restrict__ cand_s, const int* __restrict__ cand_i, int splits, int k,
             float* __restrict__ out_s, int64_t* __restrict__ out_i) {
  constexpr int SZ = 2 * KMAX + MERGE_THREADS;
  __shared__ float ls[SZ];
  __shared__ int li[SZ];
  __shared__ float th_s;
  __shared__ int th_i;
  __shared__ int cnt;
  const int tid = threadIdx.x;
  const int p = blockIdx.x;
  for (int e = tid; e < SZ; e += MERGE_THREADS) {
    ls[e] = -INFINITY;
    li[e] = NONE_ID;
  }
  if (tid == 0) {
    th_s = -INFINITY;
    th_i = NONE_ID;
    cnt = 0;
  }
  __syncthreads();
  const float* cs = cand_s + (size_t)p * splits * k;
  const int* ci = cand_i + (size_t)p * splits * k;
  for (int r = 0; r < k; ++r) {
    bool merged = false;
    for (int g = 0; g < splits; g += MERGE_THREADS) {
      const int s = g + tid;
      if (s < splits) {
        const float v = cs[(size_t)s * k + r];
        const int id = ci[(size_t)s * k + r];
        if (better(v, id, th_s, th_i)) {
          const int pos = atomicAdd(&cnt, 1);
          ls[KMAX + pos] = v;
          li[KMAX + pos] = id;
        }
      }
      __syncthreads();
      const int m = cnt;
      __syncthreads();  // every thread has read cnt before warp 0 resets it
      if (m > 0) {
        merged = true;
        if (tid < 32) {
          warp_merge<KMAX, MERGE_THREADS>(ls, li, k, m, tid);
          if (tid == 0) {
            th_s = ls[k - 1];
            th_i = li[k - 1];
            cnt = 0;
          }
        }
      }
      __syncthreads();
    }
    if (!merged) break;
  }
  for (int e = tid; e < k; e += MERGE_THREADS) {
    out_s[(size_t)p * k + e] = ls[e];
    out_i[(size_t)p * k + e] = li[e];
  }
}

template <typename RowT, bool VEC, int KMAX>
int launch_scan(const float* q, const RowT* corpus, const float* scales, int P, int N, int d,
                int k, int rows_per_split, int splits, float* cand_s, int* cand_i,
                cudaStream_t stream) {
  const size_t smem = scan_smem_bytes<KMAX>();
  cudaError_t err = cudaFuncSetAttribute(scan_kernel<RowT, VEC, KMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + QB - 1) / QB, splits);
  scan_kernel<RowT, VEC, KMAX><<<grid, THREADS, smem, stream>>>(q, corpus, scales, P, N, d, k,
                                                                rows_per_split, cand_s, cand_i);
  return cudaGetLastError();
}

template <typename RowT, int KMAX>
int run(const float* q, const RowT* corpus, const float* scales, int P, int N, int d, int k,
        int rows_per_split, int splits, bool vec, float* cand_s, int* cand_i, float* out_s,
        int64_t* out_i, cudaStream_t stream) {
  const int rc = vec ? launch_scan<RowT, true, KMAX>(q, corpus, scales, P, N, d, k, rows_per_split,
                                                     splits, cand_s, cand_i, stream)
                     : launch_scan<RowT, false, KMAX>(q, corpus, scales, P, N, d, k,
                                                      rows_per_split, splits, cand_s, cand_i,
                                                      stream);
  if (rc != 0) return rc;
  merge_kernel<KMAX><<<P, MERGE_THREADS, 0, stream>>>(cand_s, cand_i, splits, k, out_s, out_i);
  return cudaGetLastError();
}

// The corpus cut into whole tiles of `tile` rows so that query blocks of
// `qb` x splits fill `per_sm` scan blocks on every SM; returns the split
// count.
int plan_splits(int P, int N, int sm_count, int qb, int tile, int per_sm, int* rows_per_split) {
  const int q_blocks = (P + qb - 1) / qb;
  const int fill = (per_sm * sm_count + q_blocks - 1) / q_blocks;
  const int want = fill > 1 ? fill : 1;
  const int tiles = (N + tile - 1) / tile;
  *rows_per_split = (tiles + want - 1) / want * tile;
  return (N + *rows_per_split - 1) / *rows_per_split;
}

// Bytes of the splits' candidate lists (fp32 scores then int32 ids, [P,
// splits, k] each, for the larger split count of the two tilings), rounded
// up to 128.
size_t list_bytes(int P, int N, int k, int sm_count) {
  int rows_per_split;
  const int narrow = plan_splits(P, N, sm_count, QB, TILE, BLOCKS_PER_SM, &rows_per_split);
  const int ring = plan_splits(P, N, sm_count, WQB, WBN, WBLOCKS_PER_SM, &rows_per_split);
  return ((size_t)P * (narrow > ring ? narrow : ring) * k * 8 + 127) / 128 * 128;
}

// A tensor-core scan's three launches: the queries prepared once (bf16 for
// int8 rows; tf32 hi and lo planes for fp32 rows) into the workspace after
// the candidate lists, the scan, and the merge.
template <typename RowT>
int launch_ring(const float* q, const RowT* corpus, const float* scales, int P, int N, int d, int k, int sm_count,
                void* workspace, float* os, int64_t* oi, cudaStream_t st) {
  using ST = Stage<RowT>;
  constexpr bool TF32 = sizeof(RowT) == 4;
  constexpr int Q_ELEM = TF32 ? 4 : 2;  // bytes of a prepared query feature
  int rows_per_split;
  const int splits = plan_splits(P, N, sm_count, WQB, WBN, WBLOCKS_PER_SM, &rows_per_split);
  float* cs = static_cast<float*>(workspace);
  int* ci = reinterpret_cast<int*>(cs + (size_t)P * splits * k);
  void* qp = static_cast<unsigned char*>(workspace) + list_bytes(P, N, k, sm_count);
  const int n = P * d;
  const int blocks = (n / 4 + 255) / 256;
  const int grid = blocks < 4 * sm_count ? blocks : 4 * sm_count;
  if constexpr (TF32)
    tf32_queries_kernel<<<grid, 256, 0, st>>>(q, static_cast<float*>(qp), static_cast<float*>(qp) + n, n);
  else
    bf16_queries_kernel<<<grid, 256, 0, st>>>(q, static_cast<__nv_bfloat16*>(qp), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, xmap;
  {  // [planes, P, d]: one plane of bf16, or the tf32 hi and lo planes
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)P, TF32 ? 2u : 1u};
    const cuuint64_t strides[2] = {(cuuint64_t)d * Q_ELEM, (cuuint64_t)n * Q_ELEM};
    const cuuint32_t box[3] = {ST::BK, WQB, TF32 ? 2u : 1u};
    if ((err = comorag::make_map(&qmap, TF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                 qp, dims, strides, box, box_swizzle(ST::Q_ROW))) != cudaSuccess)
      return err;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)N};
    const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(RowT)};
    const cuuint32_t box[2] = {ST::BK, WBN};
    if ((err = comorag::make_map(&xmap, TF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                                 corpus, dims, strides, box, box_swizzle(ST::X_ROW))) != cudaSuccess)
      return err;
  }
  constexpr size_t smem = ring_smem_bytes<RowT>();
  const dim3 scan_grid((P + WQB - 1) / WQB, splits);
  if constexpr (TF32) {
    if ((err = cudaFuncSetAttribute(tf32_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return err;
    tf32_scan_kernel<<<scan_grid, MTHREADS, smem, st>>>(qmap, xmap, P, N, d, k, rows_per_split, cs, ci);
  } else {
    if ((err = cudaFuncSetAttribute(mma_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return err;
    mma_scan_kernel<<<scan_grid, MTHREADS, smem, st>>>(qmap, xmap, scales, P, N, d, k, rows_per_split, cs, ci);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  merge_kernel<WKMAX><<<P, MERGE_THREADS, 0, st>>>(cs, ci, splits, k, os, oi);
  return cudaGetLastError();
}

template <typename RowT>
int dispatch(const void* q, const void* corpus, const float* scales, int P, int N, int d, int k, int route,
             int sm_count, void* workspace, void* out_s, void* out_i, void* stream) {
  if (P <= 0 || N <= 0 || d <= 0 || k <= 0 || k > N || k > 256 || sm_count <= 0)
    return cudaErrorInvalidValue;
  // 16-byte row loads where the rows are whole 16-byte words and aligned
  const bool vec = reinterpret_cast<uintptr_t>(corpus) % 16 == 0 && (d * sizeof(RowT)) % 16 == 0;
  const bool aligned = vec && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  // the route's limits (ops/mips.scan_route); a call outside them is refused
  constexpr bool FP32_ROWS = std::is_same<RowT, float>::value, INT8_ROWS = std::is_same<RowT, int8_t>::value;
  if (route == ROUTE_TF32 && !(FP32_ROWS && k <= WKMAX && d % 4 == 0 && aligned)) return cudaErrorInvalidValue;
  if (route == ROUTE_MMA && !(INT8_ROWS && k <= WKMAX && d % 16 == 0 && aligned)) return cudaErrorInvalidValue;
  if (route != ROUTE_SCAN && route != ROUTE_TF32 && route != ROUTE_MMA) return cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const RowT* c = static_cast<const RowT*>(corpus);
  float* cs = static_cast<float*>(workspace);
  float* os = static_cast<float*>(out_s);
  int64_t* oi = static_cast<int64_t*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (FP32_ROWS || INT8_ROWS) {
    if (route != ROUTE_SCAN) return launch_ring<RowT>(qf, c, scales, P, N, d, k, sm_count, workspace, os, oi, st);
  }
  int rows_per_split;
  const int splits = plan_splits(P, N, sm_count, QB, TILE, BLOCKS_PER_SM, &rows_per_split);
  int* ci = reinterpret_cast<int*>(cs + (size_t)P * splits * k);
  if (k <= 64)
    return run<RowT, 64>(qf, c, scales, P, N, d, k, rows_per_split, splits, vec, cs, ci, os, oi, st);
  return run<RowT, 256>(qf, c, scales, P, N, d, k, rows_per_split, splits, vec, cs, ci, os, oi, st);
}

}  // namespace

extern "C" const char* comorag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Scratch bytes a call needs: the splits' candidate lists (list_bytes),
// then the tensor-core scans' queries: bf16 [P, d] (int8 rows) or the tf32
// hi and lo planes [2, P, d] (fp32 rows).
extern "C" long long comorag_mips_topk_workspace_bytes(int P, int N, int d, int k, int sm_count) {
  if (P <= 0 || N <= 0 || d <= 0 || k <= 0 || sm_count <= 0) return 0;
  return (long long)(list_bytes(P, N, k, sm_count) + (size_t)P * d * 8);
}

// Shared arguments. q: [P, d] fp32 contiguous. k: 1 <= k <= min(N, 256).
// route: the scan (ROUTE_SCAN, ROUTE_TF32, ROUTE_MMA; ops/mips.scan_route),
// refused with cudaErrorInvalidValue outside its limits. sm_count: the
// card's SMs; workspace: comorag_mips_topk_workspace_bytes() bytes of
// device scratch, 16-byte aligned. out_s [P, k] fp32 and out_i [P, k]
// int64 receive the top-k, best first. Returns a cudaError_t (0 on
// success); launches on `stream`, never syncs.

// corpus: [N, d] fp32 (bf16 == 0) or bf16 (bf16 != 0) contiguous.
extern "C" int comorag_mips_topk(const void* q, const void* corpus, int bf16, int P, int N, int d, int k,
                                 int route, int sm_count, void* workspace, void* out_s, void* out_i,
                                 void* stream) {
  if (bf16)
    return dispatch<__nv_bfloat16>(q, corpus, nullptr, P, N, d, k, route, sm_count, workspace, out_s,
                                   out_i, stream);
  return dispatch<float>(q, corpus, nullptr, P, N, d, k, route, sm_count, workspace, out_s, out_i, stream);
}

// corpus: [N, d] int8 contiguous; scales: [N] fp32 per-row scales.
extern "C" int comorag_mips_topk_int8(const void* q, const void* corpus, const void* scales, int P, int N,
                                      int d, int k, int route, int sm_count, void* workspace, void* out_s,
                                      void* out_i, void* stream) {
  if (scales == nullptr) return cudaErrorInvalidValue;
  return dispatch<int8_t>(q, corpus, static_cast<const float*>(scales), P, N, d, k, route, sm_count,
                          workspace, out_s, out_i, stream);
}
