"""comorag_torch's MipsIndex against the JAX MipsIndex on the same corpus.

At N=2048 both indexes serve the certified int8 two-pass (scan "auto"):
ids must be exactly equal, ties go to the lowest id, scores agree to 1e-5.
``resolve_route`` must give the (method, scan_dtype) the JAX index resolves
to, on the CPU and on "cuda" (the JAX index's on-TPU branch).
"""

import numpy as np
import pytest
import torch

from comorag_torch.retrieval.index import MipsIndex as TorchIndex
from comorag_torch.retrieval.index import resolve_route
from comorag_tpu.retrieval.index import MipsIndex as JaxIndex

N, D = 2048, 64


def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _queries(p, seed=1):
    return np.random.default_rng(seed).standard_normal((p, D)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    corpus = _corpus()
    return TorchIndex(corpus, device="cpu"), JaxIndex(corpus)


def test_topk_and_topk_many_match_jax(pair):
    t, j = pair
    assert j.scan_dtype == t.scan_dtype == "int8"  # both really are the two-pass
    q = _queries(13)
    (st, it), (sj, ij) = t.topk(q, 10), j.topk(q, 10)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, atol=1e-5, rtol=0)
    batches = [q[:3], q[3:8], q[8]]
    for (st, it), (sj, ij) in zip(t.topk_many(batches, 7), j.topk_many(batches, 7)):
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_allclose(st, sj, atol=1e-5, rtol=0)


def test_dense_topk_matches_jax():
    from comorag_torch.ops.topk import dense_topk
    from comorag_tpu.ops.topk import dense_topk as jax_dense_topk

    corpus, q = _corpus(seed=3)[:700], _queries(5, seed=4)
    st, it = dense_topk(torch.as_tensor(q), torch.as_tensor(corpus), 12)
    sj, ij = jax_dense_topk(q, corpus, np.int32(len(corpus)), 12)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5, rtol=0)


def test_topk_min_scores_and_stats_match_jax(pair):
    t, j = pair
    q = _queries(6, seed=2)
    for got, want in zip(t.topk_min_async(q, 5).result(), j.topk_min_async(q, 5).result()):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t.topk_min_async(q, 5).result()[1], j.topk_min_async(q, 5).result()[1])
    np.testing.assert_allclose(t.scores(q), j.scores(q), atol=1e-5, rtol=0)
    ht, hj = t.scores_stats_async(q, 9), j.scores_stats_async(q, 9)
    (vt, it, mt, sumt), (vj, ij, mj, sumj) = ht.stats(), hj.stats()
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(vt, vj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(mt, mj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(sumt, sumj, atol=1e-4, rtol=0)  # sum of 2048 terms
    np.testing.assert_allclose(ht.result_rows(np.array([4, 1])), hj.result_rows(np.array([4, 1])),
                               atol=1e-5, rtol=0)
    dev, p, n = ht.device_scores()
    assert isinstance(dev, torch.Tensor) and (p, n) == (6, N)


def test_duplicate_rows_tie_to_lowest_id():
    """120 exact copies of one row scattered through the corpus: the JAX
    two-pass flags and rescues the tied rows; both must return the five
    LOWEST duplicate ids, in order."""
    corpus = _corpus(seed=5) * 0.25
    rng = np.random.default_rng(6)
    dup_ids = np.sort(rng.choice(N, 120, replace=False))
    base = corpus[dup_ids[0]] / np.linalg.norm(corpus[dup_ids[0]])
    corpus[dup_ids] = base
    q = np.stack([base, -base]).astype(np.float32)
    t, j = TorchIndex(corpus, device="cpu"), JaxIndex(corpus)
    (st, it), (sj, ij) = t.topk(q, 5), j.topk(q, 5)
    np.testing.assert_array_equal(it[0], dup_ids[:5])
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, atol=1e-5, rtol=0)


def test_bf16_storage_and_device_queries_match_jax():
    corpus = _corpus(seed=7)
    q = _queries(4, seed=8)
    t = TorchIndex(corpus, device="cpu", dtype="bfloat16")
    j = JaxIndex(corpus, dtype="bfloat16")
    (st, it), (sj, ij) = t.topk(torch.as_tensor(q), 10), j.topk(q, 10)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, atol=1e-5, rtol=0)


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
@pytest.mark.parametrize("scan", ["auto", "int8", "bfloat16", None])
@pytest.mark.parametrize("method", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n", [0, 511, 512, 1023, 1024, 4096])
def test_resolve_route_matches_jax(monkeypatch, n, dtype, method, scan, device_type):
    import jax

    if device_type == "cuda":  # the JAX index's on-TPU branch (index.py:279)
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    j = JaxIndex(np.ones((n, 2), np.float32), dtype=dtype, method=method, scan_dtype=scan)
    assert resolve_route(n, dtype, method, scan, device_type) == (j.method, j.scan_dtype)


def test_pallas_and_int8_serve_plain_on_cpu():
    """The CPU resolves method="pallas" to the plain route, as JAX resolves
    it off the TPU; int8 storage with method="xla" is served by plain
    torch on every device (``resolve_route`` gives ("xla", None) on CUDA)."""
    corpus = _corpus()[:600]
    q = _queries(3, seed=9)
    t = TorchIndex(corpus, device="cpu", method="pallas")
    j = JaxIndex(corpus, method="pallas")
    assert t.method == j.method == "xla"
    np.testing.assert_array_equal(t.topk(q, 8)[1], j.topk(q, 8)[1])
    t8, j8 = TorchIndex(corpus, device="cpu", dtype="int8"), JaxIndex(corpus, dtype="int8")
    np.testing.assert_allclose(t8.scores(q), j8.scores(q), atol=1e-5, rtol=0)
    (st, it), (sj, ij) = t8.topk(q, 8), j8.topk(q, 8)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, atol=1e-5, rtol=0)
    assert resolve_route(600, "int8", "xla", "auto", "cuda") == ("xla", None)


def test_exact_scan_candidates_and_tile_n_are_accepted(pair):
    """``exact=False`` is served exact (JAX's approximate selection exists
    only on the TPU); ``scan_candidates`` widens the two-pass pool as in
    JAX; ``tile_n`` rounds as JAX rounds it."""
    corpus = _corpus(seed=10)
    q = _queries(5, seed=11)
    t = TorchIndex(corpus, device="cpu", scan_candidates=200, tile_n=100)
    j = JaxIndex(corpus, scan_candidates=200, tile_n=100)
    assert t.tile_n == j.tile_n == 128 and t.scan_candidates == 200
    (st, it), (sj, ij) = t.topk(q, 10, exact=False), j.topk(q, 10, exact=True)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, atol=1e-5, rtol=0)
    for (st, it), (sj, ij) in zip(t.topk_many([q[:2], q[2:]], 6, exact=False), j.topk_many([q[:2], q[2:]], 6)):
        np.testing.assert_array_equal(it, ij)
    tp, jp = pair
    np.testing.assert_array_equal(tp.topk_async(q, 4, exact=False).result()[1], jp.topk(q, 4)[1])


def test_empty_index():
    t = TorchIndex(np.zeros((0, D), np.float32), device="cpu")
    s, i = t.topk(_queries(2), 5)
    assert s.shape == (2, 0) and i.shape == (2, 0)
    vals, idx, row_min = t.topk_min_async(_queries(2), 5).result()
    assert vals.shape == (2, 0) and row_min.shape == (2,)
