"""Worker of tests/test_torch_dcn_meta.py: comorag_torch's meta loop over a
mesh that crosses a process boundary (``ComoRAG(mesh=)`` in lockstep, the
encoder's ``data`` axis split by process).

    python tests/_torch_dcn_meta_worker.py PORT PROCESS_ID OUT_DIR [MODE]

Two such processes join one gloo group at 127.0.0.1:PORT; each passes 4
positions and each works in a directory of its own under OUT_DIR. On the
CPU (MODE "cpu", the default) they run ``run_corpus`` over ``{"corpus":
8}``, ``run_data_axis`` over ``{"data": 2, "corpus": 4}`` (process 1 holds
no corpus shard there), the lockstep error cases and the one-process
parts' checks, and write their results to OUT_DIR/rank<PROCESS_ID>.npz.
The test calls the same ``run_*`` on one process's meshes of the same
shapes and holds JAX's ``ComoRAG`` against them. On cards (MODE
"gloo-cuda": both processes on cuda:0; "nccl": each on its own half of the
cards; ``tests/test_torch_cuda.py``) they run ``run_corpus`` alone. This
file imports neither jax nor comorag_tpu, and checks so at its end.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from comorag_torch.comorag import ComoRAG
from comorag_torch.config import ComoConfig
from comorag_torch.llm.fake import FakeLLM
from comorag_torch.models import bge
from comorag_torch.parallel import distributed
from comorag_torch.parallel.mesh import build_mesh

CPU = torch.device("cpu")
N_CHUNKS = 2100
DATA_CHUNKS = 1100  # (b)'s corpus: the smallest round one that shards over 4 (>= 4 x 256 rows)
N_RETRIEVE = 6  # questions whose tri_retrieve docs and veridical top-k are compared
TOP_K = 20
ENCODE_TEXTS = 37
FAIL_AT = 2  # the question the error cases fail at

NAMES = ["Arden", "Brisa", "Corin", "Davet", "Elwyn", "Fiora", "Garrick", "Halla"]
PLACES = ["mill", "harbor", "orchard", "quarry", "archive", "forge", "lighthouse", "granary"]
ITEMS = ["ledger", "compass", "seed chest", "iron key", "star chart", "bell", "anvil", "lantern"]
QUESTIONS = ["Who hid the moonstone crown in the cistern?", "Who catalogued the star chart at the archive?",
             "Who visited the lighthouse and catalogued the bell?", "Where did Fiora catalogue the iron key?",
             "Who catalogued the seed chest at the orchard?", "What did Garrick catalogue at the forge?",
             "Who visited the quarry on day 47?", "Which record mentions the anvil at the mill?",
             "Who catalogued the lantern at the harbor?", "What did Brisa catalogue at the granary?",
             "Who visited the archive and catalogued the ledger?", "Where was the compass catalogued by Halla?"]


def corpus(n: int = N_CHUNKS) -> list:
    """tests/test_mesh_pipeline.py's corpus (the same draws), with "Record
    i:" written "Record i -": the fake OpenIE takes a capitalized word
    after a colon for a sentence start and extracts nothing, so the graph
    would have no arc; mid-sentence, the names become entities, facts and
    graph arcs (the PPR path)."""
    rng = np.random.default_rng(11)
    chunks = []
    for i in range(n):
        a = NAMES[rng.integers(len(NAMES))]
        b = PLACES[rng.integers(len(PLACES))]
        c = ITEMS[rng.integers(len(ITEMS))]
        chunks.append(f"Record {i} - {a} visited the {b} and catalogued the {c} on day {int(rng.integers(1, 365))}.")
    if n > 1234:
        chunks[1234] = "Record 1234 - Quintessa hid the moonstone crown inside the old cistern beneath the granary."
    return chunks


def config(workdir: str) -> dict:
    """The pipeline's config (tests/test_mesh_pipeline.py's, the graph on),
    as keyword arguments: the test builds JAX's ``ComoConfig`` from them."""
    return dict(llm_name="fake", embedding_model_name="hash", embedding_dim=64, need_cluster=False,
                max_meta_loop_iterations=1, save_dir=os.path.join(workdir, "outputs"),
                output_dir=os.path.join(workdir, "results"))


def retrieved(engine, questions) -> dict:
    """Each question's tri_retrieve docs (veridical, semantic, episodic) as
    one JSON string, and the veridical top-k of its passage embedding."""
    out = {"docs": np.asarray([json.dumps(r.as_docs(), sort_keys=True)
                               for r in engine.tri_retrieve_batch(list(questions))])}
    q = engine.encode_queries(list(questions))["passage"]
    out["ver_scores"], out["ver_ids"] = engine.ver_index.topk(q, TOP_K)
    return out


def run_corpus(mesh, workdir: str) -> dict:
    """(a): index the corpus over ``mesh``, then the tri_retrieve docs and
    veridical top-k of the first ``N_RETRIEVE`` questions, and the answers
    of all 12 questions in one ``try_answer``."""
    rag = ComoRAG(ComoConfig(**config(workdir)), mesh=mesh)
    rag.index(corpus())
    engine = rag.engine
    engine.prepare()
    out = {f"a/{k}": v for k, v in retrieved(engine, QUESTIONS[:N_RETRIEVE]).items()}
    out["a/answers"] = np.asarray([s.answer for s in rag.try_answer(QUESTIONS)])
    out["a/shards"] = np.asarray([engine.ver_index.n_shards, engine.fact_index.n_shards,
                                  len(engine.ppr._arcs), int(engine.graph.n_arcs)])
    out["a/local_shards"] = np.asarray([c is not None for c in engine.ver_index.corpus])
    return out


# -------------------------------------------------------- the data axis (b)
def tiny_bge_tree(seed: int = 0) -> dict:
    """A tiny BGE's weights (``EncoderArch.tiny()``: 2 layers, H 64) as
    JAX's parameter tree of numpy arrays, from a numpy seed: N(0, 0.05)
    matrices and biases, LN scales near 1."""
    arch = bge.EncoderArch.tiny()
    dims = bge._dims(arch)
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        if name.endswith("ln_scale"):
            return (1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    embed = {n: draw(n, tuple(dims[s] for s in shape)) for n, shape in bge._EMBED_SHAPES.items()}
    layers = {n: draw(n, (arch.num_layers,) + tuple(dims[s] for s in shape)) for n, shape in bge._LAYER_SHAPES.items()}
    return {"embed": embed, "layers": layers}


def encode_texts() -> list:
    return [f"{NAMES[i % 8]} catalogued the {ITEMS[i % 8]} at the {PLACES[(i * 3) % 8]}" + " again" * (i % 6)
            for i in range(ENCODE_TEXTS)]


def tiny_encoder(mesh) -> bge.BGETorchEncoder:
    arch = bge.EncoderArch.tiny()
    return bge.BGETorchEncoder(params=bge.params_from_jax(tiny_bge_tree(), arch, device="cpu"),
                               tokenizer=bge.SimpleHashTokenizer(arch.vocab_size), max_seq_len=32, batch_size=32,
                               mesh=mesh, device=None if mesh is not None else "cpu")


def run_data_axis(mesh, workdir: str) -> dict:
    """(b): the tiny BGE over ``mesh``'s data axis encodes 37 texts (two
    batches, the last one short); then one ``index`` of ``DATA_CHUNKS``
    chunks and one question with it over ``mesh``."""
    encoder = tiny_encoder(mesh)
    out = {"b/encode": encoder.encode(encode_texts()),
           "b/encode_device": encoder.encode_device(encode_texts()[:5], instruction="query: ").cpu().numpy()}
    rag = ComoRAG(ComoConfig(**config(workdir)), encoder=encoder, mesh=mesh)
    rag.index(corpus(DATA_CHUNKS))
    engine = rag.engine
    engine.prepare()
    out.update({f"b/{k}": v for k, v in retrieved(engine, QUESTIONS[1:2]).items()})
    out["b/answers"] = np.asarray([s.answer for s in rag.try_answer(QUESTIONS[1:2])])
    out["b/ver_matrix"] = rag.ver_store.matrix
    out["b/local_shards"] = np.asarray([c is not None for c in engine.ver_index.corpus])
    return out


# --------------------------------------------------- lockstep errors (c)
class RankFailingLLM(FakeLLM):
    """Raises in process ``rank`` at the final answer call of question
    ``FAIL_AT`` (its QA prompt, after its last retrieval)."""

    def __init__(self, rank: int):
        super().__init__()
        self.rank = rank

    def infer(self, messages, **kw):
        if distributed.process_index() == self.rank and f"Question: {QUESTIONS[FAIL_AT]}\n" in messages[-1]["content"]:
            raise RuntimeError(f"injected failure in process {self.rank}")
        return super().infer(messages, **kw)


class RankFailingRAG(ComoRAG):
    """Raises out of the meta loop in the processes ``fail_ranks`` after
    question ``FAIL_AT``'s last retrieval (when its details are written)."""

    fail_ranks = ()

    def _dump_details(self, q_idx, query, pool, steps):
        if q_idx == FAIL_AT and distributed.process_index() in self.fail_ranks:
            raise OSError(f"injected write failure in process {distributed.process_index()}")
        super()._dump_details(q_idx, query, pool, steps)


def _raised(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test reads what was raised
        return f"{type(e).__name__}: {e}"
    return ""


def run_errors(mesh, workdir: str) -> dict:
    """(c): over the stores ``run_corpus`` built in ``workdir`` (one
    ComoRAG, its engine prepared once), the 12 questions with one failing
    or disagreeing process (or both failing alike): what each
    ``try_answer`` raised."""
    rag = RankFailingRAG(ComoConfig(**config(workdir)), mesh=mesh)
    by_rank = FakeLLM(qa_answer_fn=lambda q, ctx: f"answer of process {distributed.process_index()}"
                      if q == QUESTIONS[FAIL_AT] else None)

    def answer(llm=None, fail_ranks=()):
        rag.llm, rag.fail_ranks = llm or FakeLLM(), fail_ranks
        return _raised(lambda: rag.try_answer(QUESTIONS))

    out = {"c/llm_raises_in_1": answer(llm=RankFailingLLM(1)), "c/answer_differs": answer(llm=by_rank),
           "c/meta_loop_raises_in_1": answer(fail_ranks=(1,)), "c/meta_loop_raises_in_all": answer(fail_ranks=(0, 1))}
    # after every error the group is in step: one more question answers
    rag.llm, rag.fail_ranks = FakeLLM(), ()
    out["c/after"] = np.asarray([s.answer for s in rag.try_answer(QUESTIONS[:1])])
    return out


def run_parts(mesh) -> dict:
    """(d): what still refuses a process mesh, what runs per process, and
    the local positions: the engine's retrieval window, the encoder's
    model axis and the training batch split raise; the in-process LLM
    runs a replica on each process's merge device, and over a model axis
    across the processes holds its own block and answers as one process
    does; the GMM clusters locally."""
    from comorag_torch.llm.offline import TorchOfflineLLM
    from comorag_torch.ops.gmm import fit_gmm_bic
    from comorag_torch.parallel.mesh import split_batch
    from comorag_torch.retrieval.engine import RetrievalEngine, RetrievalWindow

    engine = RetrievalEngine(ComoConfig(), None, None, mesh=mesh)
    model_mesh = build_mesh({"model": 2, "corpus": 2}, [CPU] * 2)
    llm = TorchOfflineLLM(mesh=mesh, max_new_tokens=6)
    split = TorchOfflineLLM(mesh=model_mesh, max_new_tokens=6)
    qkv = split.params["layers"]["qkv_w"]
    rng = np.random.default_rng(3)  # three separated blobs
    x = (rng.standard_normal((120, 4)) + np.repeat(np.eye(3, 4) * 6.0, 40, axis=0)).astype(np.float32)
    k, resp = fit_gmm_bic(x, max_clusters=4, seed=5, device="cpu")
    return {"d/window": _raised(lambda: RetrievalWindow(engine)),
            "d/split_batch": _raised(lambda: split_batch({"x": torch.zeros(4, 2)}, mesh)),
            "d/encoder_model_axis": _raised(lambda: bge.shard_params(bge.init_params(
                bge.EncoderArch.tiny(), torch.Generator().manual_seed(0), "cpu"), model_mesh)),
            "d/llm_model_axis": np.asarray([qkv.position(i) for i in range(len(qkv.shards))]),
            "d/llm_model_axis_text": np.asarray(split.infer([{"role": "user", "content": "Name a lamp."}]).text),
            "d/llm_text": np.asarray(llm.infer([{"role": "user", "content": "Name a lamp."}]).text),
            "d/llm_device": np.asarray(str(llm.device)),
            "d/gmm_k": np.int64(k), "d/gmm_resp": resp,
            "d/local_data": np.asarray(build_mesh({"data": 2, "corpus": 4}, [CPU] * 4).local_indices("data")),
            "d/local_corpus": np.asarray(mesh.local_indices("corpus"))}


def run_cpu(workdir: str) -> dict:
    """Every CPU case in this process, in the order the two processes run
    them (the mesh builds exchange over the group)."""
    corpus_mesh = build_mesh({"corpus": 8}, [CPU] * 4)
    out = run_corpus(corpus_mesh, os.path.join(workdir, "a"))
    out.update(run_data_axis(build_mesh({"data": 2, "corpus": 4}, [CPU] * 4), os.path.join(workdir, "b")))
    out.update(run_errors(corpus_mesh, os.path.join(workdir, "a")))
    out.update(run_parts(corpus_mesh))
    return out


def _card_positions(mode: str, pid: int) -> list:
    """Four positions a process: all on cuda:0 under gloo; under nccl on
    this process's half of the cards (its first card first)."""
    if mode == "gloo-cuda":
        return [torch.device("cuda", 0)] * 4
    per = torch.cuda.device_count() // 2
    return [torch.device("cuda", pid * per + j % per) for j in range(4)]


def main(argv) -> None:
    """argv: PORT PROCESS_ID OUT_DIR [MODE]; MODE "cpu" (the default),
    "gloo-cuda" or "nccl" (``run_corpus`` on cards)."""
    port, pid, out_dir = argv[1], int(argv[2]), argv[3]
    mode = argv[4] if len(argv) > 4 else "cpu"
    torch.set_num_threads(2)
    address = f"127.0.0.1:{port}"
    workdir = os.path.join(out_dir, f"work{pid}")
    if mode == "cpu":
        distributed.initialize(address, 2, pid, device="cpu", timeout_s=60)
    else:
        positions = _card_positions(mode, pid)
        distributed.initialize(address, 2, pid, backend="gloo" if mode == "gloo-cuda" else "nccl",
                               device=positions[0], timeout_s=60)
    try:
        if mode == "cpu":
            results = run_cpu(workdir)
        else:
            results = run_corpus(build_mesh({"corpus": 8}, positions), os.path.join(workdir, "a"))
        results["backend"] = np.asarray(distributed.backend())
        np.savez(os.path.join(out_dir, f"rank{pid}.npz"), **results)
    finally:
        distributed.shutdown()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "comorag_tpu", "__graft_entry__"))
    if loaded:
        raise SystemExit(f"the worker loaded {loaded[:5]}")
    print(f"TORCH_DCN_META_OK {pid}", flush=True)


if __name__ == "__main__":
    main(sys.argv)
