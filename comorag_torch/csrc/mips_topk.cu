// Exact inner-product top-k streamed over an fp32, bf16 or int8 corpus, for
// Hopper (sm_90a).
//
// Replaces: comorag_tpu/ops/pallas_topk.py:121 pallas_mips_topk (kernel
// _mips_kernel :75, selection _extract_topk :50) and :210
// pallas_mips_topk_int8 (kernel _mips_kernel_int8 :173). Same contract: for
// each query the k largest inner products over the corpus rows, sorted by
// (score descending, row id ascending), so ties go to the lowest id; the
// [P, N] score matrix never reaches device memory. fp32 rows are scored with
// true fp32 products and fp32 sums (FFMA; the TPU kernel's bf16x3 split is a
// workaround for its matrix unit and is not carried over). bf16 and int8
// rows are scored as the TPU kernels score them: the query rounded to bf16
// once, the row converted exactly (int8 -> float is exact), exact products,
// fp32 sums, and for int8 the per-row fp32 scale applied after the sum
// (ops/topk.py _int8_scan_dot).
//
// What bounds it on the H100: at the serving shape (P = 16 queries, N =
// 100,000 rows, d = 1024, k = 50) the fp32 kernel reads 410 MB of corpus for
// 3.3 GFLOP (8 FLOP/byte, far below the card's ridge), so it is bound by
// memory bandwidth (~0.12 ms at 3.35 TB/s); the int8 kernel reads 102 MB
// (~0.03 ms) for the same FFMA count (~0.05 ms at 67 TFLOP/s), plus one
// exact int8 -> float conversion per element per query block. At the
// 1,000-row query batches of a synonymy sweep the fp32 kernel does 16 FFMA
// per loaded byte and the FFMA rate (67 TFLOP/s) becomes the limit.
//
// What the design does about it. The TPU kernel walks the corpus axis in
// order for each query block and carries the running top-k in scratch; at
// P = 16 that is one grid row, about 1 % of this card. Here the corpus is
// split over blocks (blockIdx.y) so that each SM holds several blocks; the
// query blocks of one split are neighbours in the grid (blockIdx.x) and so
// read its rows from L2 together. Each query keeps an exact running top-k
// in shared memory plus a threshold (its current k-th best): a score that
// does not beat the threshold is dropped with one compare, and the few that
// do are appended and merged by one warp per query (sort the appended
// candidates, place both sorted runs by binary-search ranks). Two scans fill
// the per-split lists. scan_kernel (small query batches, int8 rows, k > 64)
// streams rows straight from L2 into registers, four rows and 8 queries per
// thread. wide_scan_kernel (fp32 rows, 32 queries or more, k <= 64) stages
// [32 queries x 128 rows] tiles in shared memory so that a row read from L2
// serves 32 queries. A second kernel merges the splits, one block per
// query, reading the splits' lists rank by rank and stopping at the first
// rank where no list still beats the threshold. Measured on the H100
// (PERF.md) neither scan reaches its bound yet: 0.34 ms at the serving shape
// against ~0.12 ms of bandwidth; at P = 256 the wide scan runs its products
// at ~23 of the 67 TFLOP/s of FFMA (three 16-byte shared loads per 32 FFMA).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
// the register-tiled scan of wide query batches (wide_scan_kernel)
constexpr int WQB = 32;             // queries per block
constexpr int WBN = 128;            // corpus rows per tile
constexpr int WBK = 32;             // features per shared-memory stage
constexpr int WSTRIDE = WBK + 4;   // floats per staged row (conflict-free 16-byte loads)
constexpr int WTHREADS = 128;       // one staged row per thread
constexpr int WKMAX = 64;           // k bound of the wide scan
constexpr int WBLOCKS_PER_SM = 2;
constexpr int WIDE_MIN_P = 32;      // smallest query batch sent to the wide scan
static_assert(WTHREADS == 128 && WQB == 32 && WBN == 128 && WBK == 32, "wide scan thread layout");

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

// Pass 1 over fp32 rows for query batches of WIDE_MIN_P or more (k <=
// WKMAX, d % 4 == 0, 16-byte aligned rows and queries): the split is
// scored as a register-tiled product. Per stage, WBK features of WQB
// queries and WBN rows are staged in shared memory as rows of WBK + 4
// floats, loaded as float4, neighbouring threads on neighbouring words of a
// row; the next stage's words are loaded into registers while the current
// stage is multiplied. Each thread owns 4 queries x 8 rows of the
// [WQB, WBN] tile: per 4 features, 12 conflict-free 16-byte shared loads
// feed 128 FFMA, and every row read from L2 serves WQB queries. After each
// tile the scores go through the same threshold, append and warp merge as
// in scan_kernel; two blocks per SM let one block's merges overlap the
// other's products.
__global__ void __launch_bounds__(WTHREADS, 2)
wide_scan_kernel(const float* __restrict__ q, const float* __restrict__ corpus, int P, int N, int d,
                 int k, int rows_per_split, float* __restrict__ cand_s, int* __restrict__ cand_i) {
  constexpr int SZ = scan_slots<WKMAX, WBN>();
  constexpr int ROW_WORDS = WBK / 4;                   // float4 of one row per stage
  constexpr int X_WORDS = WBN * ROW_WORDS / WTHREADS;  // row float4 per thread per stage
  constexpr int Q_WORDS = WQB * ROW_WORDS / WTHREADS;  // query float4 per thread per stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);    // [2][WQB][WSTRIDE]
  float* xs = qs + 2 * WQB * WSTRIDE;                 // [2][WBN][WSTRIDE]
  float* ls = xs + 2 * WBN * WSTRIDE;                 // [WQB][SZ] list scores
  int* li = reinterpret_cast<int*>(ls + WQB * SZ);    // [WQB][SZ] list ids
  float* th_s = reinterpret_cast<float*>(li + WQB * SZ);
  int* th_i = reinterpret_cast<int*>(th_s + WQB);
  int* cnt = th_i + WQB;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qg = tid >> 4, rg = tid & 15;  // queries qg*4 + i, rows rg + 16*j of a tile
  const int qb0 = blockIdx.x * WQB;
  const int nq = min(WQB, P - qb0);
  const int split = blockIdx.y, splits = gridDim.y;
  const int row0 = split * rows_per_split;
  const int row_end = min(N, row0 + rows_per_split);

  for (int e = tid; e < WQB * SZ; e += WTHREADS) {
    ls[e] = -INFINITY;
    li[e] = NONE_ID;
  }
  if (tid < WQB) {
    th_s[tid] = -INFINITY;
    th_i[tid] = NONE_ID;
    cnt[tid] = 0;
  }

  float4 xw[X_WORDS], qv[Q_WORDS];
  // float4 u of the thread is float4 (u * WTHREADS + tid) of the stage, row
  // by row. Rows past the split's end read its last row; features past d
  // (d % 4 == 0: a float4 is whole or absent) and absent queries are zero.
  auto load = [&](int t0, int d0) {
    const int len = min(WBK, d - d0);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < X_WORDS; ++u) {
      const int w = u * WTHREADS + tid, r = w / ROW_WORDS, f = 4 * (w % ROW_WORDS);
      const float* row = corpus + (size_t)min(t0 + r, row_end - 1) * d + d0;
      xw[u] = f < len ? __ldg(reinterpret_cast<const float4*>(row + f)) : zero;
    }
#pragma unroll
    for (int u = 0; u < Q_WORDS; ++u) {
      const int w = u * WTHREADS + tid, qq = w / ROW_WORDS, f = 4 * (w % ROW_WORDS);
      qv[u] = qq < nq && f < len ? __ldg(reinterpret_cast<const float4*>(q + (size_t)(qb0 + qq) * d + d0 + f))
                                 : zero;
    }
  };
  auto store = [&](int buf) {
    float* xb = xs + buf * WBN * WSTRIDE;
#pragma unroll
    for (int u = 0; u < X_WORDS; ++u) {
      const int w = u * WTHREADS + tid;
      *reinterpret_cast<float4*>(xb + w / ROW_WORDS * WSTRIDE + 4 * (w % ROW_WORDS)) = xw[u];
    }
    float* qb = qs + buf * WQB * WSTRIDE;
#pragma unroll
    for (int u = 0; u < Q_WORDS; ++u) {
      const int w = u * WTHREADS + tid;
      *reinterpret_cast<float4*>(qb + w / ROW_WORDS * WSTRIDE + 4 * (w % ROW_WORDS)) = qv[u];
    }
  };

  const int stages = (d + WBK - 1) / WBK;
  for (int t0 = row0; t0 < row_end; t0 += WBN) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    load(t0, 0);
    store(0);
    __syncthreads();
    for (int c = 0; c < stages; ++c) {
      const bool more = c + 1 < stages;
      if (more) load(t0, (c + 1) * WBK);
      const float* qb = qs + (c & 1) * WQB * WSTRIDE + qg * 4 * WSTRIDE;
      const float* xb = xs + (c & 1) * WBN * WSTRIDE + rg * WSTRIDE;
#pragma unroll
      for (int f = 0; f < WBK; f += 4) {
        float4 a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qb + i * WSTRIDE + f);
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(xb + 16 * j * WSTRIDE + f);
        // features in order, one fp32 sum per (query, row)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
          }
      }
      if (more) store((c + 1) & 1);
      __syncthreads();
    }
    // appends: at most WBN per query per tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qq = qg * 4 + i;
      if (qq >= nq) continue;
      const float ts = th_s[qq];
      const int ti = th_i[qq];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = t0 + rg + 16 * j;
        if (row >= row_end) continue;
        if (better(acc[i][j], row, ts, ti)) {
          const int pos = atomicAdd(&cnt[qq], 1);
          ls[qq * SZ + WKMAX + pos] = acc[i][j];
          li[qq * SZ + WKMAX + pos] = row;
        }
      }
    }
    __syncthreads();
    for (int qq = warp; qq < nq; qq += WTHREADS / 32) {
      const int m = cnt[qq];
      if (m > 0) {
        float* S = ls + qq * SZ;
        int* I = li + qq * SZ;
        warp_merge<WKMAX, WBN>(S, I, k, m, lane);
        if (lane == 0) {
          th_s[qq] = S[k - 1];
          th_i[qq] = I[k - 1];
          cnt[qq] = 0;
        }
      }
    }
    __syncthreads();
  }

  for (int qq = 0; qq < nq; ++qq) {
    const size_t base = ((size_t)(qb0 + qq) * splits + split) * k;
    for (int e = tid; e < k; e += WTHREADS) {
      cand_s[base + e] = ls[qq * SZ + e];
      cand_i[base + e] = li[qq * SZ + e];
    }
  }
}

size_t wide_smem_bytes() {
  return (size_t)2 * (WQB + WBN) * WSTRIDE * sizeof(float) +
         (size_t)WQB * scan_slots<WKMAX, WBN>() * 8 + 3 * WQB * 4;
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

template <typename RowT>
int dispatch(const void* q, const void* corpus, const float* scales, int P, int N, int d, int k,
             int sm_count, void* workspace, void* out_s, void* out_i, void* stream) {
  if (P <= 0 || N <= 0 || d <= 0 || k <= 0 || k > N || k > 256 || sm_count <= 0)
    return cudaErrorInvalidValue;
  // 16-byte row loads where the rows are whole 16-byte words and aligned
  const bool vec = reinterpret_cast<uintptr_t>(corpus) % 16 == 0 && (d * sizeof(RowT)) % 16 == 0;
  // bf16 and int8 rows stay on scan_kernel: it reads them at 2 or 1 bytes
  // per feature and measured about as fast at every P (PERF.md)
  const bool wide = sizeof(RowT) == 4 && P >= WIDE_MIN_P && k <= WKMAX && vec &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0;
  int rows_per_split;
  const int splits = wide ? plan_splits(P, N, sm_count, WQB, WBN, WBLOCKS_PER_SM, &rows_per_split)
                          : plan_splits(P, N, sm_count, QB, TILE, BLOCKS_PER_SM, &rows_per_split);
  const float* qf = static_cast<const float*>(q);
  const RowT* c = static_cast<const RowT*>(corpus);
  float* cs = static_cast<float*>(workspace);
  int* ci = reinterpret_cast<int*>(cs + (size_t)P * splits * k);
  float* os = static_cast<float*>(out_s);
  int64_t* oi = static_cast<int64_t*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(RowT) == 4) {
    if (wide) {
      const size_t smem = wide_smem_bytes();
      cudaError_t err = cudaFuncSetAttribute(wide_scan_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      wide_scan_kernel<<<dim3((P + WQB - 1) / WQB, splits), WTHREADS, smem, st>>>(
          qf, c, P, N, d, k, rows_per_split, cs, ci);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      merge_kernel<WKMAX><<<P, MERGE_THREADS, 0, st>>>(cs, ci, splits, k, os, oi);
      return cudaGetLastError();
    }
  }
  if (k <= 64)
    return run<RowT, 64>(qf, c, scales, P, N, d, k, rows_per_split, splits, vec, cs, ci, os, oi, st);
  return run<RowT, 256>(qf, c, scales, P, N, d, k, rows_per_split, splits, vec, cs, ci, os, oi, st);
}

}  // namespace

extern "C" const char* comorag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Scratch bytes a call needs: the splits' candidate lists, fp32 scores
// then int32 ids, [P, splits, k] each (for the larger of the two scans'
// split counts).
extern "C" long long comorag_mips_topk_workspace_bytes(int P, int N, int k, int sm_count) {
  if (P <= 0 || N <= 0 || k <= 0 || sm_count <= 0) return 0;
  int rows_per_split;
  const int narrow = plan_splits(P, N, sm_count, QB, TILE, BLOCKS_PER_SM, &rows_per_split);
  const int wide = plan_splits(P, N, sm_count, WQB, WBN, WBLOCKS_PER_SM, &rows_per_split);
  return (long long)P * (narrow > wide ? narrow : wide) * k * 8;
}

// Shared arguments. q: [P, d] fp32 contiguous. k: 1 <= k <= min(N, 256).
// sm_count: the card's SMs; workspace: comorag_mips_topk_workspace_bytes()
// bytes of device scratch. out_s [P, k] fp32 and out_i [P, k] int64 receive
// the top-k, best first. Returns a cudaError_t (0 on success); launches on
// `stream`, never syncs.

// corpus: [N, d] fp32 (bf16 == 0) or bf16 (bf16 != 0) contiguous.
extern "C" int comorag_mips_topk(const void* q, const void* corpus, int bf16, int P, int N, int d,
                                 int k, int sm_count, void* workspace, void* out_s, void* out_i,
                                 void* stream) {
  if (bf16)
    return dispatch<__nv_bfloat16>(q, corpus, nullptr, P, N, d, k, sm_count, workspace, out_s,
                                   out_i, stream);
  return dispatch<float>(q, corpus, nullptr, P, N, d, k, sm_count, workspace, out_s, out_i, stream);
}

// corpus: [N, d] int8 contiguous; scales: [N] fp32 per-row scales.
extern "C" int comorag_mips_topk_int8(const void* q, const void* corpus, const void* scales, int P,
                                      int N, int d, int k, int sm_count, void* workspace,
                                      void* out_s, void* out_i, void* stream) {
  if (scales == nullptr) return cudaErrorInvalidValue;
  return dispatch<int8_t>(q, corpus, static_cast<const float*>(scales), P, N, d, k, sm_count,
                          workspace, out_s, out_i, stream);
}
