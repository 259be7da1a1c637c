"""comorag_torch's PPRGraph against the JAX device solver and the float64
dense reference, on the same random graph and resets.

Tolerance: max abs 1e-6 between the two fp32 device solvers (same fixed
point, same fp32 stopping rule, sums in another order); top-50 ranking
agreement 1.0 against the float64 reference.
"""

import numpy as np
import pytest

from comorag_torch.ops import ppr as tppr
from comorag_tpu.ops import ppr as jppr


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(11)
    n, e = 500, 3000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    return src, dst, w, n


def _top(x, k=50):
    return np.argsort(-x, kind="stable")[:k]


def test_query_matches_jax_and_dense_reference(graph):
    src, dst, w, n = graph
    rng = np.random.default_rng(3)
    resets = (rng.random((5, n)) * (rng.random((5, n)) > 0.9)).astype(np.float32)
    t = tppr.PPRGraph(src, dst, w, n, max_iters=256, tol=1e-8, backend="device", device="cpu")
    j = jppr.PPRGraph(src, dst, w, n, max_iters=256, tol=1e-8, backend="device")
    got, want = t.query(resets), j.query(resets)
    assert np.abs(got - want).max() < 1e-6
    for row in range(5):
        ref = tppr.ppr_dense_reference(src, dst, w, n, resets[row])
        np.testing.assert_allclose(ref, jppr.ppr_dense_reference(src, dst, w, n, resets[row]))
        assert set(_top(got[row]).tolist()) == set(_top(ref).tolist())


def test_query_topk_matches_jax(graph):
    src, dst, w, n = graph
    rng = np.random.default_rng(4)
    b, s_pad, k = 5, 8, 10
    passage_idxs = np.arange(200, dtype=np.int64)
    seed_idx = rng.integers(200, n, (b, s_pad)).astype(np.int32)
    seed_w = (rng.random((b, s_pad)) * (rng.random((b, s_pad)) > 0.3)).astype(np.float32)
    prior = rng.random((b, len(passage_idxs))).astype(np.float32) * 0.005
    t = tppr.PPRGraph(src, dst, w, n, max_iters=256, tol=1e-8, backend="device", device="cpu")
    j = jppr.PPRGraph(src, dst, w, n, max_iters=256, tol=1e-8, backend="device")
    st, pt = t.query_topk(seed_idx, seed_w, passage_idxs, prior, k=k)
    sj, pj = j.query_topk(seed_idx, seed_w, passage_idxs, prior, k=k)
    np.testing.assert_array_equal(pt, pj)
    assert np.abs(st - sj).max() < 1e-6


def test_native_route_and_crossover_rule_match_jax(graph):
    src, dst, w, n = graph
    t = tppr.PPRGraph(src, dst, w, n, device="cpu")
    j = jppr.PPRGraph(src, dst, w, n)
    for b in (1, 16, 64, 6000):
        assert t.routes_device(b) == j.routes_device(b)
    resets = np.zeros((2, n), np.float32)
    resets[0, 7] = resets[1, 42] = 1.0
    np.testing.assert_array_equal(t.query(resets), j.query(resets))  # the same native solver
    with pytest.raises(ValueError):
        t.query(np.zeros((1, n), np.float32))
