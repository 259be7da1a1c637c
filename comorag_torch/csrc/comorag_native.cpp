// comorag_native — host-side native runtime (the port's copy of
// native/comorag_native.cpp).
//
// TPU-native counterpart of the reference's third-party native components
// (SURVEY.md §2.2): igraph's C core (graph materialization,
// the reference's ComoRAG.py:768-834) and PRPACK's C++ personalized
// PageRank solver (ComoRAG.py:1086-1105). The device path
// (comorag_tpu/ops/ppr.py) handles large graphs / large probe batches;
// this library is the low-latency host path for small graphs — a single
// blocking host<->device round-trip can cost more than the whole solve —
// and the independent oracle the JAX solver is validated against.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Build CSR adjacency from an arc list (counting sort by src).
// indptr: [n_nodes + 1], indices/data: [n_arcs] — caller-allocated.
void build_csr(int32_t n_nodes, int64_t n_arcs, const int32_t* src,
               const int32_t* dst, const float* w, int32_t* indptr,
               int32_t* indices, float* data) {
  std::vector<int64_t> counts(n_nodes + 1, 0);
  for (int64_t e = 0; e < n_arcs; ++e) counts[src[e] + 1]++;
  indptr[0] = 0;
  for (int32_t i = 0; i < n_nodes; ++i)
    indptr[i + 1] = indptr[i] + static_cast<int32_t>(counts[i + 1]);
  std::vector<int32_t> cursor(indptr, indptr + n_nodes);
  for (int64_t e = 0; e < n_arcs; ++e) {
    int32_t pos = cursor[src[e]]++;
    indices[pos] = dst[e];
    data[pos] = w[e];
  }
}

// Weighted personalized PageRank, PRPACK-compatible fixed point:
//   x <- (1-a) r + a (P^T x + dangling_mass * r)
// with P row-normalized by weighted out-strength. Batched over B reset
// vectors, one thread per reset vector.
//
// resets: [B, n] (need not be normalized; negatives/NaN treated as 0)
// out:    [B, n]
// Returns the max iteration count used across the batch.
int32_t ppr_csr(int32_t n, const int32_t* indptr, const int32_t* indices,
                const float* data, int32_t batch, const float* resets,
                float alpha, float tol, int32_t max_iters, float* out) {
  // Row strengths (weighted out-degree).
  std::vector<double> strength(n, 0.0);
  for (int32_t u = 0; u < n; ++u)
    for (int32_t e = indptr[u]; e < indptr[u + 1]; ++e) strength[u] += data[e];

  std::atomic<int32_t> max_used{0};
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int n_threads = std::max(1, std::min(batch, hw > 0 ? hw : 1));

  auto solve_one = [&](int32_t b) {
    const float* reset_raw = resets + static_cast<int64_t>(b) * n;
    std::vector<double> r(n), x(n), nx(n);
    double rsum = 0.0;
    for (int32_t i = 0; i < n; ++i) {
      double v = reset_raw[i];
      if (!(v > 0.0)) v = 0.0;  // negatives and NaN -> 0
      r[i] = v;
      rsum += v;
    }
    if (rsum <= 0.0) {  // uniform fallback (igraph semantics: reset required;
      for (int32_t i = 0; i < n; ++i) r[i] = 1.0 / n;  // we mirror ops/ppr.py)
    } else {
      for (int32_t i = 0; i < n; ++i) r[i] /= rsum;
    }
    x = r;
    int32_t it = 0;
    for (; it < max_iters; ++it) {
      std::fill(nx.begin(), nx.end(), 0.0);
      double dangling = 0.0;
      for (int32_t u = 0; u < n; ++u) {
        if (strength[u] <= 0.0) {
          dangling += x[u];
          continue;
        }
        double scale = x[u] / strength[u];
        if (scale == 0.0) continue;
        for (int32_t e = indptr[u]; e < indptr[u + 1]; ++e)
          nx[indices[e]] += scale * data[e];
      }
      double err = 0.0;
      for (int32_t i = 0; i < n; ++i) {
        double v = (1.0 - alpha) * r[i] + alpha * (nx[i] + dangling * r[i]);
        err += std::fabs(v - x[i]);
        x[i] = v;
      }
      if (err <= tol) {
        ++it;
        break;
      }
    }
    int32_t cur = max_used.load();
    while (it > cur && !max_used.compare_exchange_weak(cur, it)) {
    }
    float* o = out + static_cast<int64_t>(b) * n;
    for (int32_t i = 0; i < n; ++i) o[i] = static_cast<float>(x[i]);
  };

  if (n_threads <= 1) {
    for (int32_t b = 0; b < batch; ++b) solve_one(b);
  } else {
    std::vector<std::thread> pool;
    std::atomic<int32_t> next{0};
    for (int t = 0; t < n_threads; ++t)
      pool.emplace_back([&]() {
        for (int32_t b = next.fetch_add(1); b < batch; b = next.fetch_add(1))
          solve_one(b);
      });
    for (auto& th : pool) th.join();
  }
  return max_used.load();
}

// Exact top-k inner products on host (fallback when no accelerator):
// queries [P, d] x corpus [N, d] -> scores/ids [P, k], descending.
void mips_topk(int32_t p, int32_t n, int32_t d, int32_t k,
               const float* queries, const float* corpus, float* out_scores,
               int32_t* out_ids) {
  const int32_t kk = std::min(k, n);  // the heap holds at most n entries
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int n_threads = std::max(1, std::min(p, hw > 0 ? hw : 1));
  auto run_q = [&](int32_t qi) {
    const float* q = queries + static_cast<int64_t>(qi) * d;
    // (score, id) min-heap of size k over all corpus rows
    std::vector<std::pair<float, int32_t>> heap;
    heap.reserve(kk + 1);
    for (int32_t row = 0; row < n; ++row) {
      const float* c = corpus + static_cast<int64_t>(row) * d;
      float s = 0.f;
      for (int32_t j = 0; j < d; ++j) s += q[j] * c[j];
      if (static_cast<int32_t>(heap.size()) < kk) {
        heap.emplace_back(s, row);
        std::push_heap(heap.begin(), heap.end(), std::greater<>());
      } else if (s > heap.front().first) {
        std::pop_heap(heap.begin(), heap.end(), std::greater<>());
        heap.back() = {s, row};
        std::push_heap(heap.begin(), heap.end(), std::greater<>());
      }
    }
    std::sort_heap(heap.begin(), heap.end(), std::greater<>());
    for (int32_t j = 0; j < k; ++j) {
      // rows beyond kk (k > n) are zero-filled, never read out of bounds
      out_scores[static_cast<int64_t>(qi) * k + j] = j < kk ? heap[j].first : 0.f;
      out_ids[static_cast<int64_t>(qi) * k + j] = j < kk ? heap[j].second : 0;
    }
  };
  std::vector<std::thread> pool;
  std::atomic<int32_t> next{0};
  for (int t = 0; t < n_threads; ++t)
    pool.emplace_back([&]() {
      for (int32_t qi = next.fetch_add(1); qi < p; qi = next.fetch_add(1))
        run_q(qi);
    });
  for (auto& th : pool) th.join();
}

}  // extern "C"
