"""The certified two-pass of comorag_torch against comorag_tpu's.

Build-time scan copies bit for bit (their bounds to 1e-12 relative), the
scan to 1e-5, the (scores, ids, flag) of one two-pass call, and the
index-level scenarios of tests/test_topk.py run through both indexes:
the same ids, the same flagged rows, the same adaptive-margin sequence and
fp32 fallback, the same ``two_pass.*`` counter deltas. Scores agree to 1e-5
(fp32 sums in another order).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from comorag_torch.ops import topk as ttopk
from comorag_torch.retrieval.index import MipsIndex as TorchIndex
from comorag_tpu.ops import topk as jtopk
from comorag_tpu.retrieval.index import MipsIndex as JaxIndex
from comorag_torch.utils import trace as torch_trace
from comorag_tpu.utils import trace as jax_trace


def _normalized(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _exact_duplicate_corpus(n, dups, d=64, seed=5):
    """tests/test_topk.py:338: ``dups`` exact copies of one row + low fillers."""
    rng = np.random.default_rng(seed)
    base = _normalized(rng, (d,))
    fillers = _normalized(rng, (n - dups, d)) / 4.0
    return np.concatenate([np.tile(base, (dups, 1)), fillers], axis=0).astype(np.float32)


def _near_duplicate_corpus(n=300, d=64, seed=5):
    """tests/test_topk.py:323: rows differing below the int8 step."""
    rng = np.random.default_rng(seed)
    base = _normalized(rng, (d,))
    step = np.abs(base).max() / 127.0
    return (base[None, :] + rng.uniform(-step / 8, step / 8, (n, d))).astype(np.float32)


def _tie_dense_corpus(seed, dups, rest, d=64):
    """tests/test_topk.py:647/686: near-duplicates of one row below the
    residual scan's precision, plus random rows."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(d).astype(np.float32)
    near = base[None, :] + 1e-7 * rng.standard_normal((dups, d)).astype(np.float32)
    corpus = np.concatenate([near, rng.standard_normal((rest, d)).astype(np.float32)])
    return (corpus / np.linalg.norm(corpus, axis=1, keepdims=True)).astype(np.float32), base, rng


# ----------------------------------------------------------- host copies
def test_quantize_int8_residual_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((700, 48)).astype(np.float32)
    x[5] = 0.0  # an all-zero row takes scale 1
    x[9] *= 1e-3
    cat, s1, bound = ttopk.quantize_int8_residual(x, block=256)
    jcat, js1, jbound = jtopk.quantize_int8_residual(x)
    np.testing.assert_array_equal(cat, jcat)
    np.testing.assert_array_equal(s1, js1)
    assert abs(bound - jbound) <= 1e-12 * jbound


def test_bf16_scan_corpus_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((500, 40)).astype(np.float32)
    hat, bound = ttopk.bf16_scan_corpus(x, block=128)
    jhat, jbound = jtopk.bf16_scan_corpus(x)
    assert hat.dtype == torch.bfloat16 and jhat.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(hat.view(torch.int16).numpy(), np.asarray(jhat).view(np.int16))
    assert abs(bound - jbound) <= 1e-12 * jbound


@pytest.mark.parametrize("scan", ["int8", "bfloat16"])
def test_certified_scan_matches_jax(scan):
    rng = np.random.default_rng(2)
    corpus = _normalized(rng, (1500, 64))
    q = rng.standard_normal((6, 64)).astype(np.float32)
    if scan == "int8":
        cat, s1, _ = ttopk.quantize_int8_residual(corpus)
        got = ttopk.certified_scan(torch.as_tensor(q), torch.as_tensor(cat), torch.as_tensor(s1))
        want = jtopk._certified_scan(jnp.asarray(q), jnp.asarray(cat), jnp.asarray(s1))
    else:
        hat, _ = ttopk.bf16_scan_corpus(corpus)
        got = ttopk.certified_scan(torch.as_tensor(q), hat, None)
        want = jtopk._certified_scan(jnp.asarray(q), jtopk.bf16_scan_corpus(corpus)[0], None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("scan", ["int8", "bfloat16"])
def test_two_pass_call_matches_jax(scan):
    """(scores, ids, flag) of one call at N=4096, d=64, k=10 (k padded to
    16 as the index pads it), pool 64: a query on an exact-duplicate
    cluster flags, separated queries do not."""
    corpus = _exact_duplicate_corpus(4096, dups=300)
    base = corpus[0]
    away = _normalized(np.random.default_rng(3), (6, 64))
    away -= (away @ base)[:, None] * base + 0.5 * base  # the duplicates rank last
    q = np.concatenate([base[None] * 2.0, away]).astype(np.float32)
    k_pad, c = 16, 64
    if scan == "int8":
        cat, s1, bound = ttopk.quantize_int8_residual(corpus)
        scan_t, scales_t, jargs = torch.as_tensor(cat), torch.as_tensor(s1), (cat, s1)
    else:
        hat, bound = ttopk.bf16_scan_corpus(corpus)
        scan_t, scales_t, jargs = hat, None, (jtopk.bf16_scan_corpus(corpus)[0],)
    s, i, flag = ttopk.two_pass_topk(torch.as_tensor(q), scan_t, scales_t, torch.as_tensor(corpus),
                                     torch.tensor(bound, dtype=torch.float32), k_pad, c)
    packed = np.asarray(jtopk.make_packed_two_pass_topk(k_pad, c, scan=scan)(
        q, *jargs, corpus, np.int32(len(corpus)), np.float32(bound)))
    js = packed[:, :k_pad].view(np.float32)
    ji = packed[:, k_pad : 2 * k_pad]
    np.testing.assert_array_equal(flag.numpy(), packed[:, -1])
    assert flag[0] == 1 and flag[1:].sum() == 0
    # a flagged row's ids are what the certificate cannot vouch for (exact
    # ties straddle the pool); the index rescues it, so only scores compare
    np.testing.assert_array_equal(i.numpy()[1:], ji[1:])
    np.testing.assert_allclose(s.numpy(), js, atol=1e-5, rtol=0)


# ------------------------------------------------------ index scenarios
def _counters(trace):
    return {k: v for k, v in trace.summary()["counters"].items() if k.startswith("two_pass.")}


def _run(make, trace, corpus, calls, **kw):
    """Build an index with ``make`` and run ``calls`` ([(queries, k)]);
    observe per call the results, the flagged rows, the margin and the fp32
    fallback, plus the two_pass.* counter deltas of the whole run (read from
    ``trace``, the index's own package's counters)."""
    before = _counters(trace)
    index = make(corpus, **kw)
    obs = []
    for q, k in calls:
        h = index.topk_async(q, k)
        s, i = h.result()
        state = getattr(h, "_rescue_state", None)
        rows = None if state is None else state[0].tolist()
        obs.append((np.asarray(s), np.asarray(i), rows, index._tie_margin, index._scan_off))
    after = _counters(trace)
    deltas = {k: after.get(k, 0) - before.get(k, 0) for k in after if after.get(k, 0) != before.get(k, 0)}
    return obs, deltas, index.scan_dtype


def _both(corpus, calls, same_ids=True, **kw):
    """Run ``calls`` through both indexes. ``same_ids=False`` for corpora of
    near-duplicates whose true scores differ below fp32 resolution: the
    order among them then follows each matmul's summation order, so only
    the scores (rank by rank) are compared, with everything else."""
    t = _run(lambda c, **a: TorchIndex(c, device="cpu", **a), torch_trace, corpus, calls, **kw)
    j = _run(JaxIndex, jax_trace, corpus, calls, **kw)
    (t_obs, t_deltas, t_scan), (j_obs, j_deltas, j_scan) = t, j
    assert t_scan == j_scan
    assert t_deltas == j_deltas
    for (ts, ti, trows, tm, toff), (js, ji, jrows, jm, joff) in zip(t_obs, j_obs):
        if same_ids:
            np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
        assert (trows, tm, toff) == (jrows, jm, joff)
    return t_obs, t_deltas


@pytest.mark.parametrize("scan", ["int8", "bfloat16"])
def test_scenario_two_pass_matches_exact_fp32(scan):  # tests/test_topk.py:104
    rng = np.random.default_rng(5)
    corpus = _normalized(rng, (3000, 128))
    queries = _normalized(rng, (7, 128))
    obs, _ = _both(corpus, [(queries, 20)], scan_dtype=scan)
    ref = TorchIndex(corpus, device="cpu", scan_dtype=None).topk(queries, 20)
    for row in range(7):
        assert set(obs[0][1][row].tolist()) == set(ref[1][row].tolist())


@pytest.mark.parametrize("scan", ["int8", "bfloat16"])
def test_scenario_exact_under_scan_ties(scan):  # tests/test_topk.py:353
    corpus = _near_duplicate_corpus()
    queries = _normalized(np.random.default_rng(11), (4, 64))
    obs, _ = _both(corpus, [(queries, 5)], scan_dtype=scan)
    if scan == "int8":
        assert obs[0][2] == []  # resolved in the pool, no rescue


@pytest.mark.parametrize("scan", ["int8", "bfloat16"])
def test_scenario_rescues_exact_duplicates_per_row(scan):  # tests/test_topk.py:376
    corpus = _exact_duplicate_corpus(300, dups=120)
    q_dup = corpus[0] / np.linalg.norm(corpus[0])
    obs, deltas = _both(corpus, [(np.stack([q_dup, -q_dup]).astype(np.float32), 5)], scan_dtype=scan)
    assert obs[0][2] == [0]
    assert deltas["two_pass.rescued_rows"] == 1


def test_scenario_certificate_silent_on_bench_shaped_corpus():  # tests/test_topk.py:435
    """bench.py's row width, query batch and k (d = 1024, P = 16, k = 50)
    over 4,096 rows, the smallest corpus at which both indexes still
    resolve "auto" to the int8 two-pass with a 64-row pool well inside N."""
    rng = np.random.default_rng(42)
    corpus = _normalized(rng, (4096, 1024))
    queries = _normalized(rng, (16, 1024))
    obs, deltas = _both(corpus, [(queries, 50)])
    assert obs[0][2] == [] and deltas == {"two_pass.batches": 1}


def test_scenario_flag_not_raised_on_separated_corpus():  # tests/test_topk.py:463
    rng = np.random.default_rng(13)
    corpus = _normalized(rng, (2048, 64))
    queries = rng.standard_normal((4, 64)).astype(np.float32)
    obs, _ = _both(corpus, [(queries, 5)], scan_dtype="int8")
    assert obs[0][2] == []


def test_scenario_adaptive_margin_grows():  # tests/test_topk.py:647
    corpus, base, rng = _tie_dense_corpus(3, dups=600, rest=1500)
    q = (base[None, :] + 0.01 * rng.standard_normal((8, 64))).astype(np.float32)
    obs, deltas = _both(corpus, [(q, 16)] * 7, same_ids=False)
    margins = [o[3] for o in obs]
    assert margins[-1] > 0 and deltas.get("two_pass.margin_grown", 0) > 0


def test_scenario_margin_exhausted_falls_back_to_fp32():  # tests/test_topk.py:686
    corpus, base, rng = _tie_dense_corpus(4, dups=2000, rest=600)
    q = (base[None, :] + 0.01 * rng.standard_normal((16, 64))).astype(np.float32)
    obs, deltas = _both(corpus, [(q, 16)] * 8, same_ids=False)
    assert obs[-1][4] and deltas.get("two_pass.margin_exhausted") == 1


def test_topk_many_coalescing_matches_jax():  # tests/test_topk.py:573
    corpus = _exact_duplicate_corpus(2048, dups=300)
    rng = np.random.default_rng(7)
    q_dup = corpus[0] / np.linalg.norm(corpus[0])
    batches = [rng.standard_normal((p, 64)).astype(np.float32) for p in (4, 16, 1, 7, 16, 16)]
    batches[1][3] = q_dup
    batches.append(q_dup.astype(np.float32))
    t, j = TorchIndex(corpus, device="cpu"), JaxIndex(corpus)
    for group_rows in (32, 1):
        t_before, j_before = _counters(torch_trace), _counters(jax_trace)
        got = t.topk_many(batches, k=5, group_rows=group_rows)
        want = j.topk_many(batches, k=5, group_rows=group_rows)
        t_after, j_after = _counters(torch_trace), _counters(jax_trace)
        assert ({k: v - t_before.get(k, 0) for k, v in t_after.items() if v != t_before.get(k, 0)}
                == {k: v - j_before.get(k, 0) for k, v in j_after.items() if v != j_before.get(k, 0)})
        for (ts, ti), (js, ji) in zip(got, want):
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
    dev = t.topk_many([torch.as_tensor(b) for b in batches], k=5, group_rows=32)
    for (ts, ti), (ds, di) in zip(got, dev):
        np.testing.assert_array_equal(ti, di)
