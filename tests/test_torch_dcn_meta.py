"""comorag_torch's meta loop over a mesh that crosses a process boundary:
``ComoRAG(mesh=)`` with its questions in lockstep, and the encoder's
``data`` axis split by process (``parallel/distributed.py``).

Two processes of tests/_torch_dcn_meta_worker.py join one gloo group on
127.0.0.1 with 4 CPU positions each, each in a directory of its own; the
job runs once per module, while this process computes the references:

  - (a) the corpus of tests/test_mesh_pipeline.py (2,100 chunks, written
    so that the fake OpenIE builds a graph with arcs) over ``{"corpus":
    8}`` with the hash encoder at dim 64, FakeLLM, no clustering, the
    graph on: tri_retrieve docs, veridical top-k and the answers of 12
    questions in one ``try_answer`` equal across the processes, bit-equal
    to one process's 8-position CPU mesh (whose ``try_answer`` runs its
    question threads and retrieval window), and equal to JAX's
    ``ComoRAG`` over the conftest's 8 virtual CPU devices (ids where not
    tied, scores within 1e-5);
  - (b) ``{"data": 2, "corpus": 4}``, where process 1 holds no corpus
    shard: a tiny BGE (2 layers, H 64, numpy-seeded weights) encodes 37
    texts bit-equal across the processes, within 1e-5 of the unsharded
    encoder and of JAX's ``encode`` on the same weights; then one
    ``index`` and one question, equal to one process's mesh;
  - (c) lockstep: a question that fails in one process (or in both), or
    whose answer differs between them, raises in every process; none
    hangs, and the group is in step after each;
  - (d) what still refuses a process mesh (the encoder's model axis, the
    training batch split, the retrieval window) and what runs per process
    (the in-process LLM, also split over a model axis across the
    processes, the GMM).
"""

import importlib.util
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comorag_torch.parallel import distributed
from comorag_torch.parallel.mesh import build_mesh

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


worker = _load("_torch_dcn_meta_worker")
CPU = torch.device("cpu")
TIMEOUT_S = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(out) -> list:
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(HERE)] + (
        [os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    return [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_dcn_meta_worker.py"), str(port), str(pid),
                              str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for pid in (0, 1)]


def _one_process(tmp) -> dict:
    """The worker's cases on one process's meshes of the same shapes, and
    the unsharded encoder."""
    out = worker.run_corpus(build_mesh({"corpus": 8}, [CPU] * 8), str(tmp / "a"))
    out.update(worker.run_data_axis(build_mesh({"data": 2, "corpus": 4}, [CPU] * 8), str(tmp / "b")))
    out["unsharded/encode"] = worker.tiny_encoder(None).encode(worker.encode_texts())
    return out


def _jax(tmp, cpu_mesh) -> dict:
    """(a) through JAX's ComoRAG over the 8 virtual CPU devices, and the
    tiny BGE's 37 texts through JAX's encoder over {"data": 2, "corpus": 4}."""
    from comorag_tpu.comorag import ComoRAG
    from comorag_tpu.config import ComoConfig
    from comorag_tpu.models import bge as jbge
    from comorag_tpu.parallel.mesh import build_mesh as jax_build_mesh

    rag = ComoRAG(ComoConfig(**worker.config(str(tmp))), mesh=cpu_mesh)
    rag.index(worker.corpus())
    engine = rag.engine
    engine.prepare()
    questions = worker.QUESTIONS[: worker.N_RETRIEVE]
    out = {"a/docs": [r.as_docs() for r in engine.tri_retrieve_batch(questions)]}
    out["a/ver_scores"], out["a/ver_ids"] = engine.ver_index.topk(engine.encode_queries(questions)["passage"],
                                                                 worker.TOP_K)
    out["a/answers"] = [s.answer for s in rag.try_answer(worker.QUESTIONS)]
    enc = jbge.BGEJaxEncoder(params=jax.tree_util.tree_map(jnp.asarray, worker.tiny_bge_tree()),
                             arch=jbge.EncoderArch.tiny(), max_seq_len=32, batch_size=32,
                             mesh=jax_build_mesh({"data": 2, "corpus": 4}, devices=jax.devices()[:8]))
    out["b/encode"] = np.asarray(enc.encode(worker.encode_texts()))
    out["b/encode_device"] = np.asarray(enc.encode(worker.encode_texts()[:5], instruction="query: "))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cpu_mesh):
    """(both processes' results, one process's, JAX's): the two-process job
    runs while this process computes the references."""
    out = tmp_path_factory.mktemp("torch_dcn_meta")
    procs = _start(out)
    try:
        single = _one_process(tmp_path_factory.mktemp("one_process"))
        jax_ref = _jax(tmp_path_factory.mktemp("jax"), cpu_mesh)
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"the two-process job did not end within {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"TORCH_DCN_META_OK {pid}" in log, f"process {pid} failed:\n{log[-4000:]}"
    return [dict(np.load(out / f"rank{pid}.npz")) for pid in (0, 1)], single, jax_ref


def _same(runs, key, tol=None):
    """The key's result: equal in both processes, and equal to one
    process's mesh (bit for bit, or within ``tol``)."""
    ranks, single, _ = runs
    got = ranks[0][key]
    np.testing.assert_array_equal(ranks[1][key], got, err_msg=f"{key}: the processes disagree")
    if tol is None:
        np.testing.assert_array_equal(got, single[key], err_msg=f"{key}: differs from one process's mesh")
    else:
        np.testing.assert_allclose(got, single[key], atol=tol, rtol=0)
    return got


def _equal_where_not_tied(s, i, ref_s, ref_i, tol=1e-5):
    """Scores rank by rank within ``tol``; ids equal at every rank whose
    reference score is more than ``tol`` from both neighbours."""
    np.testing.assert_allclose(s, ref_s, atol=tol, rtol=0)
    inf = np.full((len(ref_s), 1), np.inf, np.float32)
    gaps = np.concatenate([inf, ref_s[:, :-1] - ref_s[:, 1:], inf], axis=1)
    determined = (gaps[:, :-1] > tol) & (gaps[:, 1:] > tol)
    assert determined.mean() > 0.5
    np.testing.assert_array_equal(np.where(determined, i, -1), np.where(determined, ref_i, -1))


# ------------------------------------------------------------ (a) the corpus
def test_worker_corpus_is_the_mesh_pipeline_corpus():
    pipeline = _load("test_mesh_pipeline")
    assert worker.corpus() == [c.replace(":", " -", 1) for c in pipeline.make_corpus(worker.N_CHUNKS)]


def test_corpus_axis_shards_in_both_processes(runs):
    """Every process builds the 8-shard veridical and fact indexes and the
    8 PPR arc pieces, and places only its own 4."""
    ranks, _, _ = runs
    n_ver, n_fact, pieces, arcs = _same(runs, "a/shards")
    assert (n_ver, n_fact, pieces) == (8, 8, 8) and arcs > 0
    assert ranks[0]["a/local_shards"].tolist() == [True] * 4 + [False] * 4
    assert ranks[1]["a/local_shards"].tolist() == [False] * 4 + [True] * 4


def test_tri_retrieve_across_processes_matches_one_process_and_jax(runs):
    import json

    docs = _same(runs, "a/docs")
    assert [json.loads(d) for d in docs] == runs[2]["a/docs"]
    assert any("moonstone crown" in d for d in json.loads(docs[0])["veridical"])


def test_veridical_topk_across_processes_matches_one_process_and_jax(runs):
    s, i = _same(runs, "a/ver_scores"), _same(runs, "a/ver_ids")
    _equal_where_not_tied(s, i, np.asarray(runs[2]["a/ver_scores"]), np.asarray(runs[2]["a/ver_ids"]))


def test_twelve_questions_in_lockstep_match_the_threaded_path_and_jax(runs):
    """One try_answer of 12 questions ends in both processes (no retrieval
    window, no threads), with the answers of one process's threaded
    try_answer and of JAX's."""
    answers = _same(runs, "a/answers")
    assert len(answers) == 12 and all(answers)
    assert answers.tolist() == runs[2]["a/answers"]
    assert "cistern" in answers[0] or "granary" in answers[0]


# -------------------------------------------------------- (b) the data axis
def test_data_axis_encodes_by_process(runs):
    """Each process encodes its own data index's sub-batches, the rows are
    gathered in data-index order: bit-equal in both processes and to one
    process's data mesh, within 1e-5 of the unsharded encoder and JAX's."""
    ranks, single, jax_ref = runs
    got = _same(runs, "b/encode")
    assert got.shape == (worker.ENCODE_TEXTS, 64)
    np.testing.assert_allclose(got, single["unsharded/encode"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, jax_ref["b/encode"], atol=1e-5, rtol=0)
    dev = _same(runs, "b/encode_device")
    np.testing.assert_allclose(dev, jax_ref["b/encode_device"], atol=1e-5, rtol=0)


def test_data_axis_index_and_question_with_no_shard_in_one_process(runs):
    """{"data": 2, "corpus": 4}: the corpus positions sit at data index 0,
    all in process 0; process 1 enters every gather and PPR reduction with
    nothing of its own and returns the same results."""
    ranks, _, _ = runs
    assert ranks[0]["b/local_shards"].tolist() == [True] * 4
    assert ranks[1]["b/local_shards"].tolist() == [False] * 4
    _same(runs, "b/ver_matrix")
    _same(runs, "b/ver_ids"), _same(runs, "b/ver_scores"), _same(runs, "b/docs")
    assert all(_same(runs, "b/answers"))


# ------------------------------------------------------------ (c) lockstep
@pytest.mark.parametrize("case", ["llm_raises_in_1", "meta_loop_raises_in_1"])
def test_a_question_failing_in_one_process_raises_in_both(runs, case):
    """Process 1 fails question 2 at its final answer call (the LLM raises:
    the loop keeps the error and answers nothing) or after its last
    retrieval (the meta loop raises): both processes raise at that
    question's agreement, neither hangs."""
    ranks, _, _ = runs
    for pid, r in enumerate(ranks):
        msg = str(r[f"c/{case}"])
        assert msg.startswith("RuntimeError: question 2: process(es) [1] disagree with process 0"), msg
    if case == "meta_loop_raises_in_1":
        assert str(ranks[1][f"c/{case}"]).endswith("this process: error")


def test_a_question_failing_in_every_process_raises_its_error(runs):
    for r in runs[0]:
        assert str(r["c/meta_loop_raises_in_all"]).startswith("OSError: injected write failure"), r


def test_answers_that_differ_raise_in_both(runs):
    for r in runs[0]:
        assert str(r["c/answer_differs"]).startswith("RuntimeError: question 2: process(es) [1] disagree")


def test_the_group_stays_in_step_after_each_error(runs):
    ranks, single, _ = runs
    assert ranks[0]["c/after"].tolist() == ranks[1]["c/after"].tolist() == [single["a/answers"][0]]


# -------------------------------------------------- (d) what runs where
def test_process_mesh_parts(runs):
    """The retrieval window, the training batch split and the encoder's
    model axis still refuse a process mesh; the in-process LLM runs a
    replica in each process, as on one device, and over {"model": 2,
    "corpus": 2} across the processes (TP generation) each process holds
    its own block of every split weight and the engine answers as the
    unsplit one; the GMM runs locally, alike in each."""
    from comorag_torch.llm.offline import TorchOfflineLLM
    from comorag_torch.ops.gmm import fit_gmm_bic

    ranks, _, _ = runs
    for r in ranks:
        assert str(r["d/window"]).startswith("ValueError: a RetrievalWindow")
        for key in ("split_batch", "encoder_model_axis"):
            assert str(r[f"d/{key}"]).startswith("NotImplementedError:"), (key, r[f"d/{key}"])
        assert str(r["d/llm_device"]) == "cpu"
    assert ranks[0]["d/local_data"].tolist() == [0] and ranks[1]["d/local_data"].tolist() == [1]
    assert ranks[0]["d/local_corpus"].tolist() == [0, 1, 2, 3] and ranks[1]["d/local_corpus"].tolist() == [4, 5, 6, 7]
    one = TorchOfflineLLM(max_new_tokens=6, device="cpu")
    text = one.infer([{"role": "user", "content": "Name a lamp."}]).text
    assert str(ranks[0]["d/llm_text"]) == str(ranks[1]["d/llm_text"]) == text
    assert [r["d/llm_model_axis"].tolist() for r in ranks] == [[0], [1]]
    assert str(ranks[0]["d/llm_model_axis_text"]) == str(ranks[1]["d/llm_model_axis_text"]) == text
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((120, 4)) + np.repeat(np.eye(3, 4) * 6.0, 40, axis=0)).astype(np.float32)
    k, resp = fit_gmm_bic(x, max_clusters=4, seed=5, device="cpu")
    assert int(ranks[0]["d/gmm_k"]) == int(ranks[1]["d/gmm_k"]) == k == 3
    np.testing.assert_array_equal(ranks[0]["d/gmm_resp"], ranks[1]["d/gmm_resp"])
    np.testing.assert_array_equal(ranks[0]["d/gmm_resp"], resp)


# --------------------------------------------------- one process, no group
def test_agree_and_row_gather_are_the_identity_without_a_group():
    assert not distributed.initialized()
    t = torch.arange(6.0).reshape(3, 2)
    assert distributed.all_gather_rows(t) is t
    assert distributed.agree(("answer", "x"), "question 0") is None
    mesh = build_mesh({"data": 2, "corpus": 4}, [CPU] * 8)
    assert mesh.local_indices("data") == [0, 1] and mesh.local_indices("corpus") == [0, 1, 2, 3]
    assert mesh.local_indices("model") == [0]


def test_one_process_mesh_keeps_its_threads_and_window(tmp_path, monkeypatch):
    """On one process's mesh try_answer runs the question threads behind
    one RetrievalWindow, as before the process mesh."""
    import threading

    from comorag_torch import comorag as comorag_mod
    from comorag_torch.config import ComoConfig

    windows, threads = [], set()
    real_window, real_loop = comorag_mod.RetrievalWindow, comorag_mod.ComoRAG.meta_control_loop

    def window(engine):
        windows.append(engine)
        return real_window(engine)

    def loop(self, i, q):
        threads.add(threading.current_thread().name)
        return real_loop(self, i, q)

    monkeypatch.setattr(comorag_mod, "RetrievalWindow", window)
    monkeypatch.setattr(comorag_mod.ComoRAG, "meta_control_loop", loop)
    cfg = worker.config(str(tmp_path))
    rag = comorag_mod.ComoRAG(ComoConfig(**dict(cfg, skip_graph=True)), mesh=build_mesh({"corpus": 2}, [CPU] * 2))
    assert not rag._lockstep
    rag.index(worker.corpus(40))
    answers = rag.try_answer(worker.QUESTIONS[:4])
    assert len(windows) == 1 and len(answers) == 4 and all(a.answer for a in answers)
    assert threading.current_thread().name not in threads and threads
