"""comorag_torch's corpus-sharded serving path against the JAX package's.

The JAX side builds its meshes over the conftest's virtual CPU devices
(``jax.devices()[:n]``), the port over one CPU device repeated n times.
Every input comes from numpy with a fixed seed. Tolerances: ids, positions,
rankings and two-pass flags equal; top-k and full scores within 1e-5
absolute (fp32 sums in another order); PPR ranks within 1e-6 absolute
(the per-step sum of shard flows reorders fp32 additions, as the JAX
psum does); encoder rows within 1e-5 absolute (tests/test_torch_encoder.py's
tolerance).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comorag_torch.models import bge as tbge
from comorag_torch.ops import ppr as tppr
from comorag_torch.ops import topk as ttopk
from comorag_torch.parallel.mesh import build_mesh, corpus_axis_size, shard_bounds
from comorag_torch.retrieval.index import MipsIndex as TorchIndex
from comorag_torch.utils import trace as torch_trace
from comorag_tpu.models import bge as jbge
from comorag_tpu.ops import ppr as jppr
from comorag_tpu.ops import topk as jtopk
from comorag_tpu.parallel.mesh import build_mesh as jax_build_mesh
from comorag_tpu.parallel.mesh import corpus_axis_size as jax_corpus_axis_size
from comorag_tpu.retrieval.index import MipsIndex as JaxIndex
from comorag_tpu.utils import trace as jax_trace

CPU = torch.device("cpu")
D = 64


def _meshes(shape):
    n = int(np.prod(list(shape.values())))
    return build_mesh(shape, [CPU] * n), jax_build_mesh(shape, devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def corpus4():
    return _meshes({"corpus": 4})


def _normalized(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _corpus_with_ties(n, seed=0):
    """Normalized rows; row 10 copied to rows that fall in other shards, so
    equal scores straddle shard boundaries."""
    x = _normalized(np.random.default_rng(seed), (n, D))
    for row in (n // 2 + 7, n - 3):
        x[row] = x[10]
    return x


def _jax_pad(x, n_shards, rows):
    """JAX's padded [n_shards * rows, d] corpus."""
    padded = np.zeros((n_shards * rows,) + x.shape[1:], x.dtype)
    padded[: len(x)] = x
    return padded


def _jax_layout(x, n_shards, rows):
    """JAX's padded corpus; the port's shards."""
    return _jax_pad(x, n_shards, rows), [torch.as_tensor(x[r.start : r.stop])
                                         for r in shard_bounds(len(x), n_shards, rows)]


# --------------------------------------------------------------- the mesh
def test_build_mesh_matches_jax():
    for shape in ({"corpus": 8}, {"data": 2, "corpus": 4}, {"data": 2, "model": 2, "corpus": 2}):
        t, j = _meshes(shape)
        assert t.shape == dict(j.shape) and t.axis_names == j.axis_names
        assert t.devices.shape == j.devices.shape and corpus_axis_size(t) == jax_corpus_axis_size(j)
    t, j = build_mesh(devices=[CPU] * 4), jax_build_mesh(devices=jax.devices()[:4])
    assert t.shape == dict(j.shape) == {"corpus": 4}
    assert corpus_axis_size(build_mesh({"data": 4}, [CPU] * 4)) == 1
    with pytest.raises(ValueError) as te:
        build_mesh({"data": 2, "corpus": 4}, [CPU] * 6)
    with pytest.raises(ValueError) as je:
        jax_build_mesh({"data": 2, "corpus": 4}, devices=jax.devices()[:6])
    assert str(te.value) == str(je.value) == "mesh shape {'data': 2, 'corpus': 4} needs 8 devices, have 6"
    mesh = build_mesh({"data": 2, "corpus": 4}, [torch.device("cpu", i) for i in range(8)])
    assert [d.index for d in mesh.axis_devices("corpus")] == [0, 1, 2, 3]
    assert [d.index for d in mesh.axis_devices("data")] == [0, 4]
    assert mesh.axis_devices("model") == [mesh.device]


# ------------------------------------------------------- sharded programs
# (n rows, JAX shard rows, k): N not a multiple of the shard count; k over
# a shard's rows; an empty last shard (the kernel route's 512 * 4 rounding)
LAYOUTS = {"ragged": (2101, 528, 10), "k_over_shard": (300, 80, 100), "empty_shard": (2100, 1024, 16)}
# the TPU kernel's shards are whole 512-row tiles: the kernel route runs the
# layout its index gives it (empty_shard)
TOPK_CASES = [(method, int8, layout) for int8 in (False, True)
              for method, layout in [("xla", name) for name in sorted(LAYOUTS)] + [("pallas", "empty_shard")]]


@pytest.mark.parametrize("method,int8,layout", TOPK_CASES)
def test_sharded_topk_matches_jax(corpus4, method, int8, layout):
    """The kernel route: JAX's Pallas kernels in interpret mode against the
    port's per-shard scorer (ops/mips; its plain versions on the CPU)."""
    n, rows, k = LAYOUTS[layout]
    tmesh, jmesh = corpus4
    x = _corpus_with_ties(n)
    q = np.concatenate([x[10:11], _normalized(np.random.default_rng(1), (7, D))])
    kw = dict(method=method, int8=int8)
    if int8:
        cq, scales = ttopk.quantize_int8(x)
        jc, tc = _jax_layout(cq, 4, rows)
        js, ts = _jax_layout(scales, 4, rows)
        sj, ij = jtopk.make_sharded_topk(jmesh, k, interpret=True, **kw)(q, jc, js, np.int32(n))
        st, it = ttopk.make_sharded_topk(tmesh, k, **kw)(torch.as_tensor(q), tc, ts)
    else:
        jc, tc = _jax_layout(x, 4, rows)
        sj, ij = jtopk.make_sharded_topk(jmesh, k, interpret=True, **kw)(q, jc, np.int32(n))
        st, it = ttopk.make_sharded_topk(tmesh, k, **kw)(torch.as_tensor(q), tc)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5, rtol=0)
    assert it[0, :3].tolist() == [10, n // 2 + 7, n - 3]  # equal scores: lowest id first


def _exact_duplicate_corpus(n, dups, seed=5):
    """tests/test_torch_two_pass.py:31: ``dups`` exact copies of one row at
    the front (all in shard 0) and low fillers."""
    rng = np.random.default_rng(seed)
    base = _normalized(rng, (D,))
    fillers = _normalized(rng, (n - dups, D)) / 4.0
    return np.concatenate([np.tile(base, (dups, 1)), fillers], axis=0).astype(np.float32)


@pytest.mark.parametrize("scan", ["int8", "bfloat16"])
def test_sharded_two_pass_matches_jax(corpus4, scan):
    """(scores, ids, flag) at N = 4,090 over 4 shards of 1,024 rows, k = 16,
    pool 64: the query on the duplicate cluster flags (its shard's pool
    boundary ties the merged k-th), separated queries do not."""
    tmesh, jmesh = corpus4
    corpus = _exact_duplicate_corpus(4090, dups=300)
    base = corpus[0]
    away = _normalized(np.random.default_rng(3), (7, D))
    away -= (away @ base)[:, None] * base + 0.5 * base  # the duplicates rank last
    q = np.concatenate([base[None] * 2.0, away]).astype(np.float32)
    k, c, rows = 16, 64, 1024
    if scan == "int8":
        cat, s1, bound = ttopk.quantize_int8_residual(corpus)
        jcat, tcat = _jax_layout(cat, 4, rows)
        js1, ts1 = _jax_layout(s1, 4, rows)
        jargs, targs = (jcat, js1), (tcat, ts1)
    else:
        hat, bound = ttopk.bf16_scan_corpus(corpus)
        jhat = _jax_pad(np.asarray(jtopk.bf16_scan_corpus(corpus)[0]), 4, rows)
        jargs, targs = (jhat,), ([hat[r.start : r.stop] for r in shard_bounds(4090, 4, rows)], None)
    jf32, tf32 = _jax_layout(corpus, 4, rows)
    packed = np.asarray(jtopk.make_sharded_two_pass_topk(jmesh, k, c, scan=scan)(
        q, *jargs, jf32, np.int32(len(corpus)), np.float32(bound)))
    s, i, flag = ttopk.make_sharded_two_pass_topk(tmesh, k, c)(
        torch.as_tensor(q), *targs, tf32, torch.tensor(bound, dtype=torch.float32))
    np.testing.assert_array_equal(flag.numpy(), packed[:, -1])
    assert flag.tolist() == [1] + [0] * 7
    np.testing.assert_array_equal(i.numpy()[1:], packed[1:, k : 2 * k])
    np.testing.assert_allclose(s.numpy(), packed[:, :k].view(np.float32), atol=1e-5, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_sharded_topk_min_and_scores_match_jax(corpus4, int8):
    """2,100 rows over 4 JAX shards of 1,024: the last shard holds only
    padding, so its row minimum must not count."""
    tmesh, jmesh = corpus4
    n, rows, k = 2100, 1024, 12
    x = _corpus_with_ties(n, seed=2)
    q = _normalized(np.random.default_rng(4), (5, D))
    if int8:
        cq, scales = ttopk.quantize_int8(x)
        (jc, tc), (js, ts) = _jax_layout(cq, 4, rows), _jax_layout(scales, 4, rows)
        jargs, targs = (jc, js), (tc, ts)
    else:
        jc, tc = _jax_layout(x, 4, rows)
        jargs, targs = (jc,), (tc,)
    packed = np.asarray(jtopk.make_sharded_topk_min(jmesh, k, int8=int8)(q, *jargs, np.int32(n)))
    st, it, mt = ttopk.make_sharded_topk_min(tmesh, k, int8=int8)(torch.as_tensor(q), *targs)
    np.testing.assert_array_equal(it.numpy(), packed[:, k + 1 :])
    np.testing.assert_allclose(st.numpy(), packed[:, :k].view(np.float32), atol=1e-5, rtol=0)
    np.testing.assert_allclose(mt.numpy(), packed[:, k].view(np.float32), atol=1e-5, rtol=0)
    assert np.isfinite(mt.numpy()).all()
    full_j = np.asarray(jtopk.make_sharded_scores(jmesh, int8=int8)(q, *jargs))[:, :n]
    full_t = ttopk.make_sharded_scores(tmesh, int8=int8)(torch.as_tensor(q), *targs)
    assert full_t.shape == (5, n)
    np.testing.assert_allclose(full_t.numpy(), full_j, atol=1e-5, rtol=0)


# ------------------------------------------------------------ sharded PPR
@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(11)
    n, e = 500, 3000
    return (rng.integers(0, n, e).astype(np.int32), rng.integers(0, n, e).astype(np.int32),
            rng.random(e).astype(np.float32), n)


def test_sharded_ppr_matches_jax(corpus4, graph):
    """PPRGraph(mesh=) both ways (query: make_sharded_ppr; query_topk:
    make_sharded_ppr_seed_topk), the port's programs called directly on
    split arcs, and the unsharded port graph."""
    tmesh, jmesh = corpus4
    src, dst, w, n = graph
    rng = np.random.default_rng(3)
    resets = (rng.random((5, n)) * (rng.random((5, n)) > 0.9)).astype(np.float32)
    kw = dict(max_iters=256, tol=1e-8, backend="device")
    t = tppr.PPRGraph(src, dst, w, n, mesh=tmesh, **kw)
    j = jppr.PPRGraph(src, dst, w, n, mesh=jmesh, **kw)
    single = tppr.PPRGraph(src, dst, w, n, device="cpu", **kw)
    assert len(t._arcs) == 4 and sum(len(a[0]) for a in t._arcs) == len(src)
    got = t.query(resets)
    assert np.abs(got - j.query(resets)).max() < 1e-6
    assert np.abs(got - single.query(resets)).max() < 1e-6
    normed = torch.as_tensor(resets / resets.sum(axis=1, keepdims=True))
    direct = tppr.make_sharded_ppr(tmesh, 256)(t._arcs, t._dangling, normed, 0.5, 1e-7)
    np.testing.assert_array_equal(direct.numpy(), got)

    b, s_pad, k = 5, 8, 10
    passage_idxs = np.arange(200, dtype=np.int64)
    seed_idx = rng.integers(200, n, (b, s_pad)).astype(np.int32)
    seed_w = (rng.random((b, s_pad)) * (rng.random((b, s_pad)) > 0.3)).astype(np.float32)
    prior = rng.random((b, len(passage_idxs))).astype(np.float32) * 0.005
    st, pt = t.query_topk(seed_idx, seed_w, passage_idxs, prior, k=k)
    sj, pj = j.query_topk(seed_idx, seed_w, passage_idxs, prior, k=k)
    su, pu = single.query_topk(seed_idx, seed_w, passage_idxs, prior, k=k)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(pt, pu)
    assert np.abs(st - sj).max() < 1e-6 and np.abs(st - su).max() < 1e-6


def test_sharded_ppr_routes_match_jax(corpus4, graph):
    """The crossover compares arcs per shard (ppr.py:376-392): 3,000 arcs
    over 4 shards flip to the device at 21,334 resets, not 5,334."""
    tmesh, jmesh = corpus4
    src, dst, w, n = graph
    t = tppr.PPRGraph(src, dst, w, n, mesh=tmesh)
    j = jppr.PPRGraph(src, dst, w, n, mesh=jmesh)
    answers = [t.routes_device(b) for b in (1, 16, 5334, 21333, 21334, 64000)]
    assert answers == [j.routes_device(b) for b in (1, 16, 5334, 21333, 21334, 64000)]
    assert answers == [False, False, False, False, True, True]
    resets = np.zeros((2, n), np.float32)
    resets[0, 7] = resets[1, 42] = 1.0
    np.testing.assert_array_equal(t.query(resets), j.query(resets))  # the same native solver


# ------------------------------------------------------------- the index
def _index_counters(trace):
    return {k: v for k, v in trace.summary()["counters"].items() if k.startswith("two_pass.")}


@pytest.mark.parametrize("kw", [{}, {"scan_dtype": None}, {"dtype": "int8"}, {"scan_dtype": "bfloat16"}],
                         ids=["auto", "fp32", "int8", "bf16_scan"])
def test_index_over_mesh_matches_jax(corpus4, kw):
    """topk, topk_many, topk_min, scores and scores_stats of
    MipsIndex(mesh=) at 2,101 rows (shards of 528, 528, 528, 517)."""
    tmesh, jmesh = corpus4
    x = _corpus_with_ties(2101, seed=6)
    t, j = TorchIndex(x, mesh=tmesh, **kw), JaxIndex(x, mesh=jmesh, **kw)
    assert t.n_shards == j.n_shards == 4 and t.scan_dtype == j.scan_dtype
    assert [len(s) for s in t.corpus] == [528, 528, 528, 517] and t.device == CPU
    q = np.concatenate([x[10:11], _normalized(np.random.default_rng(7), (8, D))])
    (st, it), (sj, ij) = t.topk(q, 20), j.topk(q, 20)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, atol=1e-5, rtol=0)
    batches = [q[:3], q[3:8], q[8]]
    for (st, it), (sj, ij) in zip(t.topk_many(batches, 7), j.topk_many(batches, 7)):
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_allclose(st, sj, atol=1e-5, rtol=0)
    tm, jm = t.topk_min_async(q, 9).result(), j.topk_min_async(q, 9).result()
    np.testing.assert_array_equal(tm[1], jm[1])
    for a, b in ((tm[0], jm[0]), (tm[2], jm[2])):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.scores(q), j.scores(q), atol=1e-5, rtol=0)
    ts, js = t.scores_stats_async(q, 6).stats(), j.scores_stats_async(q, 6).stats()
    np.testing.assert_array_equal(ts[1], js[1])
    for a, b in zip(ts[:1] + ts[2:], js[:1] + js[2:]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("scan", ["int8", "bfloat16"])
def test_index_rescues_over_mesh_like_jax(corpus4, scan):
    """The exact-duplicate corpus through both sharded indexes: the same
    flagged rows, adaptive margin and two_pass.* counter deltas."""
    tmesh, jmesh = corpus4
    corpus = _exact_duplicate_corpus(2048, dups=600)
    q_dup = corpus[0] / np.linalg.norm(corpus[0])
    q = np.stack([q_dup, -q_dup, corpus[700] * 4.0]).astype(np.float32)
    obs = []
    for make, trace in ((lambda c: TorchIndex(c, mesh=tmesh, scan_dtype=scan), torch_trace),
                        (lambda c: JaxIndex(c, mesh=jmesh, scan_dtype=scan), jax_trace)):
        before = _index_counters(trace)
        index = make(corpus)
        assert index.n_shards == 4
        h = index.topk_async(q, 5)
        s, i = h.result()
        after = _index_counters(trace)
        obs.append((s, i, h._rescue_state[0].tolist(), index._tie_margin,
                    {c: v - before.get(c, 0) for c, v in after.items() if v != before.get(c, 0)}))
    (ts, ti, *trest), (js, ji, *jrest) = obs
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
    assert trest == jrest and trest[0] == [0] and trest[2]["two_pass.rescued_rows"] == 1


def test_small_index_is_not_sharded(corpus4):
    """tests/test_topk.py:62: a layer under n_shards * 256 rows keeps one
    device (the mesh's first) in both packages."""
    tmesh, jmesh = corpus4
    x = np.random.default_rng(4).standard_normal((64, 16)).astype(np.float32)
    t, j = TorchIndex(x, mesh=tmesh), JaxIndex(x, mesh=jmesh)
    assert t.mesh is None and j.mesh is None and t.n_shards == j.n_shards == 1
    assert t.device == tmesh.device and isinstance(t.corpus, torch.Tensor)
    (_, it), (_, ij) = t.topk(x[:2], 1), j.topk(x[:2], 1)
    np.testing.assert_array_equal(it, ij)
    assert it[:, 0].tolist() == [0, 1]
    assert TorchIndex(np.zeros((1023, 8), np.float32), mesh=tmesh).n_shards == 1
    assert TorchIndex(np.zeros((1024, 8), np.float32), mesh=tmesh).n_shards == 4
    assert TorchIndex(np.zeros((4096, 8), np.float32), mesh=build_mesh({"data": 4}, [CPU] * 4)).n_shards == 1


# ----------------------------------------------------- the data-axis encoder
ARCH_KW = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
               max_position=64)


def test_encoder_data_axis_matches_jax_and_unsharded():
    jarch = jbge.EncoderArch(**ARCH_KW)
    params = jax.tree_util.tree_map(np.asarray, jbge.init_params(jax.random.PRNGKey(0), jarch))
    model = tbge.params_from_jax(params, tbge.EncoderArch(**ARCH_KW), device="cpu")
    texts = [f"the keeper lit lamp number {i} at dusk" + " again" * (i % 5) for i in range(11)]
    tmesh, jmesh = _meshes({"data": 2})
    sharded = tbge.BGETorchEncoder(params=model, max_seq_len=32, batch_size=4, mesh=tmesh)
    single = tbge.BGETorchEncoder(params=model, max_seq_len=32, batch_size=4, device="cpu")
    jenc = jbge.BGEJaxEncoder(params=jax.tree_util.tree_map(jnp.asarray, params), arch=jarch,
                              max_seq_len=32, batch_size=4, mesh=jmesh)
    assert sharded._tokenize(texts[:3])[0].shape[0] == 8 == jenc._tokenize(texts[:3])[0].shape[0]
    assert build_mesh({"data": 3}, [CPU] * 3) and tbge.BGETorchEncoder(
        params=model, max_seq_len=32, mesh=build_mesh({"data": 3}, [CPU] * 3))._tokenize(texts)[0].shape[0] == 24
    got = sharded.encode(texts)
    np.testing.assert_allclose(got, single.encode(texts), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, jenc.encode(texts), atol=1e-5, rtol=0)
    dev = sharded.encode_device(texts, instruction="query: ")
    assert dev.shape == (11, ARCH_KW["hidden_size"]) and dev.device == CPU
    np.testing.assert_allclose(dev.numpy(), jenc.encode(texts, instruction="query: "), atol=1e-5, rtol=0)


# ------------------------------------------------------------ the pipeline
N_CHUNKS = 1100  # the smallest round corpus that shards over 4 (>= 4 x 256 rows)


def _chunks(n):
    rng = np.random.default_rng(11)
    names = ["Arden", "Brisa", "Corin", "Davet", "Elwyn", "Fiora", "Garrick", "Halla"]
    places = ["mill", "harbor", "orchard", "quarry", "archive", "forge", "lighthouse", "granary"]
    chunks = [f"Record {i}: {names[rng.integers(8)]} visited the {places[rng.integers(8)]} "
              f"on day {int(rng.integers(1, 365))}." for i in range(n)]
    chunks[734] = "Record 734: Quintessa hid the moonstone crown inside the old cistern beneath the granary."
    return chunks


def test_pipeline_over_mesh(tmp_path):
    """tests/test_mesh_pipeline.py on a {"data": 2, "corpus": 4} mesh of the
    CPU: the veridical index shards, its ranking equals the unsharded
    index's and JAX's sharded index's, and the meta loop answers."""
    from comorag_torch.comorag import ComoRAG
    from comorag_torch.config import ComoConfig

    config = ComoConfig(llm_name="fake", embedding_model_name="hash", embedding_dim=64, need_cluster=False,
                        skip_graph=True, save_dir=str(tmp_path / "outputs"),
                        output_dir=str(tmp_path / "results"), max_meta_loop_iterations=1,
                        mesh_shape={"data": 2, "corpus": 4})
    rag = ComoRAG(config, device="cpu")
    assert rag.mesh.shape == {"data": 2, "corpus": 4} and rag.device == CPU
    rag.index(_chunks(N_CHUNKS))
    engine = rag.engine
    engine.prepare()
    assert engine.ver_index.n_shards == 4 and engine.ver_index.mesh is rag.mesh
    q = engine.encode_queries(["Who catalogued the star chart?", "Who hid the moonstone crown?"])["passage"]
    sharded = engine.ver_index.topk(q, k=20)
    single = TorchIndex(rag.ver_store.matrix, device="cpu").topk(q, k=20)
    jax_sharded = JaxIndex(rag.ver_store.matrix, mesh=_meshes({"data": 2, "corpus": 4})[1]).topk(
        np.asarray(q), k=20)
    for other in (single, jax_sharded):
        np.testing.assert_array_equal(sharded[1], other[1])
        np.testing.assert_allclose(sharded[0], other[0], atol=1e-5, rtol=0)
    res = engine.tri_retrieve("Who hid the moonstone crown in the cistern?")
    assert any("moonstone crown" in d for d in res.veridical)
    sols = rag.try_answer(["Who hid the moonstone crown in the cistern?"])
    assert "cistern" in sols[0].answer or "granary" in sols[0].answer


def test_mesh_device_rules(tmp_path):
    from comorag_torch.comorag import ComoRAG
    from comorag_torch.config import ComoConfig

    mesh = build_mesh({"corpus": 2}, [CPU] * 2)
    rag = ComoRAG(ComoConfig(llm_name="fake", embedding_model_name="hash", save_dir=str(tmp_path)), mesh=mesh)
    assert rag.device == CPU and rag.mesh is mesh
    with pytest.raises(ValueError, match="first device"):
        TorchIndex(np.zeros((8, 4), np.float32), device="cpu:1", mesh=mesh)
    from comorag_torch.llm import FakeLLM, get_llm

    # an LLM that runs no model ignores the mesh, a 'model' axis included (as JAX's)
    model_mesh = build_mesh({"model": 2}, [CPU] * 2)
    assert isinstance(get_llm(ComoConfig(llm_name="fake"), device="cpu", mesh=model_mesh), FakeLLM)


# ------------------------------------------------------------------ the CLI
def _dataset(tmp_path):
    ds = tmp_path / "ds"
    ds.mkdir()
    (ds / "corpus.jsonl").write_text(json.dumps({"contents": "The lark sang at dawn."}) + "\n")
    (ds / "qas.jsonl").write_text(json.dumps({"question": "Who sang?", "answer": "the lark"}) + "\n")
    return ds


class _Reached(Exception):
    pass


def test_cli_mesh_shape_reaches_comorag(tmp_path, monkeypatch):
    """tests/test_config_wiring.py:36: ``--mesh_shape data=2,corpus=4
    --device cpu`` builds that mesh in ComoRAG."""
    import comorag_torch.cli.run as run_mod

    seen = {}
    real = run_mod.ComoRAG

    def spy(config, device):
        rag = real(config, device=device)
        seen.update(shape=rag.mesh.shape, device=rag.device)
        raise _Reached

    monkeypatch.setattr(run_mod, "ComoRAG", spy)
    monkeypatch.setattr("sys.argv", ["prog", "--base_path", str(_dataset(tmp_path)), "--llm_name", "fake",
                                     "--embedding_model_name", "hash", "--mesh_shape", "data=2,corpus=4",
                                     "--device", "cpu", "--output_dir", str(tmp_path / "o"),
                                     "--save_dir", str(tmp_path / "s")])
    with pytest.raises(_Reached):
        run_mod.main()
    assert seen == {"shape": {"data": 2, "corpus": 4}, "device": CPU}


def test_cli_rejects_malformed_mesh_shape(tmp_path, monkeypatch):
    import comorag_torch.cli.run as run_mod

    monkeypatch.setattr("sys.argv", ["prog", "--base_path", str(tmp_path), "--mesh_shape", "corpus:eight",
                                     "--device", "cpu"])
    with pytest.raises(SystemExit):
        run_mod.main()
