"""The whole slice: comorag_torch's ComoRAG against comorag_tpu's on the
bundled moonlantern set with the FakeLLM, index then meta-loop QA.

(a) hash encoder: every store, the graph, ``tri_retrieve_batch`` per layer
    and the ``try_answer`` answers are identical.
(b) a tiny BGE encoder on weights converted from JAX (``params_from_jax``),
    fp32: the answers are identical and so are the top-5 veridical ids.
(c) the hash encoder under the retrieval routes ``topk_method="pallas"`` +
    ``embedding_dtype="int8"`` and ``scan_dtype="bfloat16"``: per-layer
    ``tri_retrieve_batch`` results and the answers are identical.
(d) persisted artifacts are interchangeable: the parquet stores and
    ``graph.npz`` / ``graph.json`` written by the JAX package load in the
    port, which then skips the rebuild and answers as the JAX package does.

Each side takes its own package's ``ComoConfig``.
"""

import os

import jax
import numpy as np
import pytest

from comorag_torch.comorag import ComoRAG as TorchRAG
from comorag_torch.config import ComoConfig as TorchConfig
from comorag_torch.models import bge as tbge
from comorag_tpu.comorag import ComoRAG as JaxRAG
from comorag_tpu.config import ComoConfig as JaxConfig
from comorag_tpu.models import bge as jbge
from comorag_tpu.utils.jsonio import load_jsonl

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "dataset", "moonlantern", "moonlantern_1")
DOCS = [d["contents"] for d in load_jsonl(os.path.join(DATA, "corpus.jsonl"))]
QUERIES = [q["question"] for q in load_jsonl(os.path.join(DATA, "qas.jsonl"))]


def _config(root, tag, **kw):
    cls = TorchConfig if tag == "torch" else JaxConfig
    return cls(llm_name="fake", need_cluster=True, save_dir=str(root / tag / "outputs"),
                      output_dir=str(root / tag / "results"), max_meta_loop_iterations=2,
                      gmm_max_clusters=4, gmm_em_iterations=20, **kw)


def _store_ids(rag):
    return {name: getattr(rag, name).get_all_ids()
            for name in ("ver_store", "entity_store", "fact_store", "sem_store", "epi_store")}


def test_hash_encoder_slice_matches_jax(tmp_path):
    kw = dict(embedding_model_name="hash", embedding_dim=128)
    t = TorchRAG(_config(tmp_path, "torch", **kw), device="cpu")
    j = JaxRAG(_config(tmp_path, "jax", **kw))
    t.index(DOCS)
    j.index(DOCS)
    ids = _store_ids(t)
    assert ids == _store_ids(j)
    assert all(ids.values())  # every layer is populated
    np.testing.assert_array_equal(t.graph.src, j.graph.src)
    np.testing.assert_array_equal(t.graph.dst, j.graph.dst)
    np.testing.assert_allclose(t.graph.weights, j.graph.weights, atol=1e-6)
    for rt, rj in zip(t.engine.tri_retrieve_batch(QUERIES), j.engine.tri_retrieve_batch(QUERIES)):
        assert rt.as_docs() == rj.as_docs()
    answers = [s.answer for s in t.try_answer(QUERIES)]
    assert answers == [s.answer for s in j.try_answer(QUERIES)]
    assert all("### Final Answer" in a for a in answers)


@pytest.mark.parametrize("route", [dict(topk_method="pallas", embedding_dtype="int8"),
                                   dict(scan_dtype="bfloat16")], ids=["pallas-int8", "scan-bf16"])
def test_hash_encoder_retrieval_routes_match_jax(tmp_path, route):
    kw = dict(embedding_model_name="hash", embedding_dim=128, **route)
    t = TorchRAG(_config(tmp_path, "torch", **kw), device="cpu")
    j = JaxRAG(_config(tmp_path, "jax", **kw))
    t.index(DOCS)
    j.index(DOCS)
    for rt, rj in zip(t.engine.tri_retrieve_batch(QUERIES), j.engine.tri_retrieve_batch(QUERIES)):
        assert (rt.veridical, rt.semantic, rt.episodic) == (rj.veridical, rj.semantic, rj.episodic)
    assert [s.answer for s in t.try_answer(QUERIES)] == [s.answer for s in j.try_answer(QUERIES)]


def test_tiny_bge_slice_matches_jax(tmp_path):
    jarch = jbge.EncoderArch.tiny()
    params = jbge.init_params(jax.random.PRNGKey(0), jarch)
    tparams = tbge.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                   tbge.EncoderArch.tiny(), device="cpu")
    jenc = jbge.BGEJaxEncoder(params=params, arch=jarch, max_seq_len=128)
    tenc = tbge.BGETorchEncoder(params=tparams, max_seq_len=128, device="cpu")
    kw = dict(embedding_model_name="bge:tiny")
    t = TorchRAG(_config(tmp_path, "torch", **kw), encoder=tenc, device="cpu")
    j = JaxRAG(_config(tmp_path, "jax", **kw), encoder=jenc)
    t.index(DOCS)
    j.index(DOCS)
    assert _store_ids(t) == _store_ids(j)
    for rt, rj in zip(t.engine.tri_retrieve_batch(QUERIES, ver_top_k=5),
                      j.engine.tri_retrieve_batch(QUERIES, ver_top_k=5)):
        assert rt.veridical == rj.veridical
    assert [s.answer for s in t.try_answer(QUERIES)] == [s.answer for s in j.try_answer(QUERIES)]


def test_artifacts_written_by_jax_load_in_the_port(tmp_path):
    kw = dict(embedding_model_name="hash", embedding_dim=128)
    j = JaxRAG(_config(tmp_path, "jax", **kw))
    j.index(DOCS)
    shared = _config(tmp_path, "jax", **kw)
    t = TorchRAG(TorchConfig.from_dict(shared.to_dict()), device="cpu")
    assert t.graph is not None
    assert _store_ids(t) == _store_ids(j)
    np.testing.assert_array_equal(t.graph.src, j.graph.src)
    np.testing.assert_array_equal(t.graph.weights, j.graph.weights)
    np.testing.assert_array_equal(t.ver_store.matrix, j.ver_store.matrix)
    graph = t.graph
    t.index(DOCS)
    assert t.graph is graph  # up to date: loaded, not rebuilt
    assert [s.answer for s in t.try_answer(QUERIES)] == [s.answer for s in j.try_answer(QUERIES)]


def test_cuda_device_is_refused_without_a_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TorchRAG(_config(tmp_path, "torch", embedding_model_name="hash"), device="cuda")
