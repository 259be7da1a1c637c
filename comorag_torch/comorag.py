"""ComoRAG orchestrator: indexing + the Reason->Probe->Retrieve->
Consolidate->Resolve meta loop.

Capability parity with the reference's monolithic ``ComoRAG`` class
(ComoRAG.py:43-1195), re-composed from this framework's modules:

  index(docs):
    1. veridical store: embed + persist chunks,
    2. episodic layer: timeline window summaries (level_0 store),
    3. semantic layer: recursive GMM cluster-summary tree,
    4. OpenIE (NER + triples, resumable JSON artifact),
    5. entity/fact stores + entity graph (fact/passage/synonymy edges),
       persisted as graph.npz/json.

  try_answer(queries):
    per-question meta loop (meta_control_loop, ComoRAG.py:265-431): QA
    attempt -> on '*' impasse: consolidate temp memory, generate probes,
    fan out tri-layer retrieval for ALL probes, encode memory nodes with
    fused cues, fuse similar history into findings, iterate.

Port of ``comorag_tpu/comorag.py`` on one torch device (``device=``,
default ``"cuda"``, which raises when no card is visible), or over a mesh
(``mesh=`` or ``config.mesh_shape``, ``parallel/mesh.py``): the retrieval
indexes shard over its ``corpus`` axis, the PPR graph its arcs, and the
encoder splits batches over its ``data`` axis. The flow is the
JAX package's: the probe fan-out encodes and scores as batches on the
device; dedup in the memory pool works; LLM fan-out is a bounded pool.
Host stages (OpenIE, timeline, summaries, prompts, agents, the embedding
store) are the JAX package's own modules, reused as they are.

Across processes (JAX's multi-controller program under
``jax.distributed``): every process calls ``distributed.initialize``,
builds the same ``build_mesh(shape, local_devices)`` and a ``ComoRAG`` on
the same config, corpus and store state, in a ``save_dir`` and
``output_dir`` of its own (each process writes its stores, graph and
trace, as each JAX process does). Every retrieval call is then a
collective that all processes enter in the same order, so ``try_answer``
runs the questions one after another in input order, with no thread pool
and no retrieval window, and the processes agree on each answer's digest
(``distributed.agree``): a question that fails or answers otherwise in
one process raises in every process. After ``index`` they agree on each
store's row count and the graph's signature. An in-process LLM (``get_llm``)
over a mesh whose ``model`` axis spans processes is split over that axis,
each process holding its own blocks, and answers in the same lockstep;
without such an axis each process runs a replica of it.
"""

from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from comorag_torch.cluster.raptor import SemanticTree
from comorag_torch.graph.builder import GraphBuilder, GraphData
from comorag_torch.llm import get_llm
from comorag_torch.memory.pool import NO_MEMORY_SENTINEL, MemoryNode, MemoryPool, NodeType
from comorag_torch.models.registry import get_encoder
from comorag_torch.parallel import distributed
from comorag_torch.parallel.mesh import Mesh, device_mesh, mesh_device
from comorag_torch.retrieval.engine import RetrievalEngine, RetrievalWindow
from comorag_torch.agents.pool_agent import PoolAgent
from comorag_torch.agents.probe_agent import ProbeAgent
from comorag_torch.config import ComoConfig
from comorag_torch.ie.openie import OpenIE
from comorag_torch.llm.summarize import Summarizer
from comorag_torch.prompts.manager import PromptManager
from comorag_torch.rerank import FactFilter
from comorag_torch.store.embedding_store import EmbeddingStore
from comorag_torch.timeline.summarizer import TimelineSummarizer
from comorag_torch.types import QuerySolution
from comorag_torch.utils.hashing import content_hash
from comorag_torch.utils.logging import get_logger
from comorag_torch.utils import trace
from comorag_torch.utils.text import TokenCounter, text_processing

logger = get_logger(__name__)


def _unique_entities(chunk_triples: Sequence[Sequence[Sequence[str]]]) -> Tuple[List[str], List[List[str]]]:
    """(all unique entities, per-chunk unique entity lists) — misc_utils
    extract_entity_nodes semantics."""
    per_chunk: List[List[str]] = []
    for triples in chunk_triples:
        ents = set()
        for t in triples:
            if len(t) == 3:
                ents.update((t[0], t[2]))
        per_chunk.append(sorted(ents))
    all_ents = sorted({e for ents in per_chunk for e in ents})
    return all_ents, per_chunk


class ComoRAG:
    def __init__(
        self,
        config: Optional[ComoConfig] = None,
        llm=None,
        encoder=None,
        tokenizer=None,
        device: Union[str, torch.device, None] = None,
        mesh: Optional[Mesh] = None,
    ):
        """``device``: "cuda" when None (the mesh's first device under a
        mesh; a device passed beside a mesh must be that one).
        ``config.mesh_shape`` builds the mesh when none is passed
        (comorag.py:84-87), over devices that follow ``device``: every
        card for CUDA, the CPU repeated to the mesh's size for "cpu"."""
        self.config = config or ComoConfig()
        if mesh is None and self.config.mesh_shape:
            mesh = device_mesh(dict(self.config.mesh_shape), device)
        self.mesh = mesh
        # a mesh that spans processes: every process makes the same calls in
        # the same order (try_answer's questions in lockstep)
        self._lockstep = mesh is not None and mesh.process_count > 1
        self.device = mesh_device(mesh, device)
        os.makedirs(self.config.working_dir, exist_ok=True)

        self.llm = llm if llm is not None else get_llm(self.config, self.device, mesh=mesh)
        self.encoder = encoder if encoder is not None else get_encoder(self.config, self.device, mesh=mesh)
        self.prompts = PromptManager()
        self.openie = OpenIE(self.llm, self.prompts, response_format=self.config.response_format)
        self.summarizer = Summarizer(self.llm)
        self.fact_filter = FactFilter(self.llm, self.config.llm_name, self.config.rerank_dspy_file_path)
        # budgets must count in the SERVING tokenizer's units: the window
        # clamps (_qa_layer_budgets, summary budgets) are in model tokens,
        # and e.g. the hermetic ByteTokenizer runs ~4.5x the word estimate
        # — an undercount overflows the window and the engine silently
        # left-truncates the protocol header off the prompt
        if tokenizer is None:
            tokenizer = getattr(self.llm, "tokenizer", None) or getattr(
                getattr(self.llm, "engine", None), "tokenizer", None
            )
        self.tokens = TokenCounter(tokenizer)

        wd = self.config.working_dir
        bs = self.config.embedding_batch_size
        self.ver_store = EmbeddingStore(self.encoder, os.path.join(wd, "chunk_embeddings"), bs, "chunk")
        self.entity_store = EmbeddingStore(self.encoder, os.path.join(wd, "entity_embeddings"), bs, "entity")
        self.fact_store = EmbeddingStore(self.encoder, os.path.join(wd, "fact_embeddings"), bs, "fact")
        self.sem_store = None
        self.epi_store = None
        if self.config.need_cluster:
            self.sem_store = EmbeddingStore(self.encoder, os.path.join(wd, "summary_embeddings"), bs, "summary")
            self.epi_store = EmbeddingStore(self.encoder, os.path.join(wd, "timeline_embeddings"), bs, "level_0")

        self._graph_prefix = os.path.join(wd, "graph")
        self.graph: Optional[GraphData] = GraphData.load(self._graph_prefix)
        self.openie_results_path = os.path.join(
            self.config.save_dir, f"openie_results_ner_{self.config.llm_name.replace('/', '_')}.json"
        )
        self._engine: Optional[RetrievalEngine] = None
        # set by try_answer: the cross-question retrieval-coalescing window
        self._retrieval_front = None

    # ------------------------------------------------------------------ index
    def pre_openie(self, docs: Sequence[str]) -> int:
        """Two-phase indexing pre-pass (reference openie_mode='offline',
        ComoRAG.py:180-196): embed the chunks and run/persist OpenIE only,
        so a later ``index()`` call finds everything cached. Unlike the
        reference, which halts with ``assert False`` after saving (a quirk,
        SURVEY.md §7.3), this returns the number of chunks processed."""
        self.ver_store.insert_strings(list(docs))
        ner_results, _ = self._run_openie()
        return len(ner_results)

    def index(self, docs: Sequence[str]) -> None:
        cfg = self.config
        logger.info("Indexing %d documents", len(docs))
        pre_openie_results = None
        if cfg.openie_mode == "offline":
            # run the OpenIE pre-pass first so the graph stage below is a
            # pure cache read — same two-phase artifact flow as the
            # reference, minus the deliberate halt. The results are reused
            # in-memory below: with save_openie=False nothing is persisted,
            # and a second _run_openie would pay the whole extraction again.
            self.ver_store.insert_strings(list(docs))
            pre_openie_results = self._run_openie()
        with trace.span("index.embed_chunks"):
            self.ver_store.insert_strings(list(docs))

        if cfg.need_cluster:
            with trace.span("index.timeline"):
                self._build_timeline()
            with trace.span("index.semantic_tree"):
                self._build_semantic_tree()

        with trace.span("index.openie"):
            ner_results, triple_results = (
                pre_openie_results if pre_openie_results is not None else self._run_openie()
            )
        with trace.span("index.fact_prep"):
            chunk_ids = self.ver_store.get_all_ids()
            chunk_triples = [
                [text_processing(t) for t in triple_results[cid]] for cid in chunk_ids
            ]
            entity_nodes, per_chunk_entities = _unique_entities(chunk_triples)
            facts = sorted({tuple(t) for triples in chunk_triples for t in triples if len(t) == 3})

        logger.info("Encoding %d entities, %d facts", len(entity_nodes), len(facts))
        with trace.span("index.encode_entities"):
            self.entity_store.insert_strings(entity_nodes)
        with trace.span("index.encode_facts"):
            self.fact_store.insert_strings([json.dumps(list(f)) for f in facts])

        if not cfg.skip_graph:
            with trace.span("index.graph"):
                self._build_graph(chunk_ids, chunk_triples, per_chunk_entities)
        self._engine = None  # force re-prepare with fresh stores
        if self._lockstep:
            # processes that started from other store files differ here,
            # before their retrieval calls pair up wrongly
            stores = {name: len(store) for name, store in (
                ("chunk", self.ver_store), ("entity", self.entity_store), ("fact", self.fact_store),
                ("summary", self.sem_store), ("timeline", self.epi_store)) if store is not None}
            distributed.agree((stores, self.graph.signature() if self.graph is not None else None),
                              "index (store rows, graph signature)")

    def _build_timeline(self) -> None:
        timeline = TimelineSummarizer(
            self.ver_store,
            self.summarizer,
            self.encoder,
            os.path.join(self.config.working_dir, "timeline_embeddings"),
            batch_size=self.config.embedding_batch_size,
        )
        self.epi_store = timeline.load_or_generate()
        # per-run statistics artifacts (timeline_utils.py:73-188 parity)
        timeline.save_statistics(
            os.path.join(self.config.working_dir, "summary_statistics"), self.tokens
        )

    def _build_semantic_tree(self) -> None:
        # Reuse only a tree built over the SAME corpus (the reference's
        # flag_cluster probe reuses any existing summaries, silently stale
        # after the corpus grows — ComoRAG.py:110-116).
        meta_path = os.path.join(self.config.working_dir, "semantic_tree_meta.json")
        n_chunks = len(self.ver_store)
        if len(self.sem_store):
            built_over, meta = -1, {}
            try:
                with open(meta_path, encoding="utf-8") as f:
                    meta = json.load(f)
                built_over = meta.get("n_chunks", -1) if isinstance(meta, dict) else -1
            except (OSError, json.JSONDecodeError):
                built_over = -1  # absent/corrupt meta just means "rebuild"
            failed_before = meta.get("failed_summaries", 0) if isinstance(meta, dict) else 0
            if built_over == n_chunks and not failed_before:
                logger.info("Semantic tree already built (%d summaries)", len(self.sem_store))
                return
            if built_over == n_chunks and failed_before:
                logger.info(
                    "Semantic tree had %d failed cluster summaries — rebuilding "
                    "(the LLM cache keeps the successful ones cheap)", failed_before,
                )
            logger.info(
                "Semantic tree stale (built over %d chunks, now %d) — rebuilding", built_over, n_chunks
            )
            self.sem_store.clear()
        # Clamp the cluster-context budget to the serving engine's actual
        # window when it exposes one (jax-offline: max_model_len 4096):
        # an over-window prompt would be LEFT-truncated by the engine,
        # cutting the instruction header off the front and turning the
        # "summary" into raw continuation text with no error.
        budget = self.config.summary_context_max_tokens
        window = self._llm_window()
        if window:
            # 512 = the engine's generation bucket for the summarizer's
            # completions (the prompt limit is window - bucket); 256 more
            # of headroom for the chat template + instruction header the
            # summarizer wraps around the cluster texts — without it a
            # full-budget cluster still crosses the prompt limit and the
            # engine left-truncates the header off silently. The floor is
            # 64 (never above the window-derived limit for tiny windows).
            budget = max(64, min(budget, int(window) - 512 - 256))
        tree = SemanticTree(
            self.encoder,
            self.summarizer,
            threshold=self.config.cluster_threshold,
            reduction_dim=self.config.reduction_dimension,
            max_clusters=self.config.gmm_max_clusters,
            seed=self.config.cluster_seed,
            em_iters=self.config.gmm_em_iterations,
            batch_size=self.config.embedding_batch_size,
            max_context_tokens=budget,
            token_counter=self.tokens,
            device=self.device,
        )
        all_summaries, final_summary = tree.build(
            self.ver_store.get_all_texts(), max_levels=5, embeddings=self.ver_store.matrix
        )
        if all_summaries:
            self.sem_store.insert_strings(all_summaries)
        if final_summary:
            with open(os.path.join(self.config.working_dir, "final_summary.txt"), "w", encoding="utf-8") as f:
                f.write(final_summary[0])
        tmp_meta = meta_path + ".tmp"
        with open(tmp_meta, "w", encoding="utf-8") as f:
            json.dump({"n_chunks": n_chunks, "failed_summaries": tree.failed_summaries}, f)
        os.replace(tmp_meta, meta_path)  # atomic: no torn meta on crash

    def _run_openie(self) -> Tuple[Dict[str, List[str]], Dict[str, List[List[str]]]]:
        """Resumable OpenIE: existing results load from the JSON artifact;
        only new chunks hit the LLM (load_existing_openie semantics)."""
        chunks = {cid: self.ver_store.get_text(cid) for cid in self.ver_store.get_all_ids()}
        existing_docs: List[dict] = []
        if os.path.isfile(self.openie_results_path):
            with open(self.openie_results_path, encoding="utf-8") as f:
                existing_docs = json.load(f).get("docs", [])
            for info in existing_docs:
                info["idx"] = content_hash(info["passage"], "chunk-")
        existing_keys = {info["idx"] for info in existing_docs}
        to_process = {cid: text for cid, text in chunks.items() if cid not in existing_keys}

        if to_process:
            ner_new, triple_new = self.openie.batch_openie(to_process)
            # chunks whose LLM call ERRORED (vs legitimately extracting
            # nothing) must not be persisted: the resume path would treat
            # their empty extractions as done and a transient API outage
            # would permanently strip them of entities/facts/graph edges
            failed = {
                cid for cid in to_process
                if "error" in ner_new[cid].metadata
                or ner_new[cid].metadata.get("finish_reason") == "error"
                or "error" in triple_new[cid].metadata
                or triple_new[cid].metadata.get("finish_reason") == "error"
            }
            if failed:
                logger.warning(
                    "OpenIE: %d/%d chunks errored — proceeding without them "
                    "this run; they stay un-persisted and RETRY next index()",
                    len(failed), len(to_process),
                )
            for cid, text in to_process.items():
                existing_docs.append(
                    {
                        "idx": cid,
                        "passage": text,
                        "extracted_entities": ner_new[cid].unique_entities,
                        "extracted_triples": triple_new[cid].triples,
                    }
                )
            if self.config.save_openie:
                os.makedirs(os.path.dirname(self.openie_results_path) or ".", exist_ok=True)
                persist = [d for d in existing_docs if d["idx"] not in failed]
                with open(self.openie_results_path, "w", encoding="utf-8") as f:
                    json.dump({"docs": persist}, f)

        ner_results = {d["idx"]: list(dict.fromkeys(d["extracted_entities"])) for d in existing_docs}
        triple_results = {d["idx"]: d["extracted_triples"] for d in existing_docs}
        return ner_results, triple_results

    def _graph_fingerprint(self, chunk_ids, chunk_triples) -> str:
        """Content fingerprint of every graph-builder input: a warm
        ``index()`` call on an unchanged corpus must not pay the rebuild
        (~96 s at 200k chunks, dominated by the synonymy KNN). Ids are
        themselves content hashes, so hashing them captures the texts;
        the encoder fingerprint captures the vectors the synonymy stage
        scores; the knobs capture everything else that shapes edges."""
        h = hashlib.md5()

        def feed(part: str) -> None:
            h.update(part.encode())
            h.update(b"\x00")

        # streamed per item — joining 539k triples into one string first
        # would transiently hold tens of MB just to hash it once
        for cid in chunk_ids:
            feed(cid)
        for triples in chunk_triples:
            for t in triples:
                feed(",".join(t))
            h.update(b"\x01")
        for store in (self.entity_store, self.fact_store):
            for hid in store.get_all_ids():
                feed(hid)
            h.update(b"\x01")
        if self.sem_store is not None:
            for hid in self.sem_store.get_all_ids():
                feed(hid)
        feed(getattr(self.encoder, "fingerprint", ""))
        feed(repr((
            self.config.synonymy_edge_topk,
            self.config.synonymy_edge_sim_threshold,
            self.config.synonymy_edge_query_batch_size,
            self.config.synonymy_edge_key_batch_size,
            self.config.is_directed_graph,
            self.config.need_cluster,
        )))
        return h.hexdigest()

    def _build_graph(self, chunk_ids, chunk_triples, per_chunk_entities) -> None:
        meta_path = self._graph_prefix + "_meta.json"
        with trace.span("graph.fingerprint"):
            fp = self._graph_fingerprint(chunk_ids, chunk_triples)
        if self.graph is not None:
            try:
                with open(meta_path, encoding="utf-8") as f:
                    stored = json.load(f)
            except (OSError, json.JSONDecodeError):
                stored = {}
            # the signature binds the meta to the ARTIFACT: the .npz/.json
            # pair is two files, so a crash mid-save can leave a new arc
            # file beside an old node-name file — input fingerprint alone
            # would then skip the rebuild and run PPR over arc indices
            # that refer to a different node numbering.
            if stored.get("fingerprint") == fp and (
                stored.get("signature") == self.graph.signature()
            ):
                logger.info("Graph up to date (%s) — skipping rebuild", self.graph.info())
                return
        builder = GraphBuilder()
        with trace.span("graph.fact_edges"):
            builder.add_fact_edges(chunk_ids, chunk_triples)
        with trace.span("graph.passage_edges"):
            builder.add_passage_edges(chunk_ids, per_chunk_entities)
        entity_keys = self.entity_store.get_all_ids()
        entity_texts = self.entity_store.get_all_texts()
        if len(entity_keys) >= 2:
            with trace.span("graph.synonymy_edges"):
                builder.add_synonymy_edges(
                    entity_keys,
                    entity_texts,
                    self.entity_store.matrix,
                    device=self.device,
                    mesh=self.mesh,
                    topk=self.config.synonymy_edge_topk,
                    sim_threshold=self.config.synonymy_edge_sim_threshold,
                    query_batch_size=self.config.synonymy_edge_query_batch_size,
                    key_batch_size=self.config.synonymy_edge_key_batch_size,
                )
        node_names = list(entity_keys) + list(chunk_ids)
        summary_keys: list = []
        if self.config.need_cluster and self.sem_store is not None:
            summary_keys = list(self.sem_store.get_all_ids())
            node_names += summary_keys
        with trace.span("graph.finalize"):
            self.graph = builder.finalize(node_names, directed=self.config.is_directed_graph)
            # structural census (reference get_graph_info, ComoRAG.py:843-874):
            # logged at finalize and surfaced in trace.json gauges
            self.graph.census = builder.census(
                node_names,
                passage_keys=chunk_ids,
                summary_keys=summary_keys,
                num_extracted_triples=len(self.fact_store.get_all_ids()),
            )
            for key, value in self.graph.info().items():
                trace.gauge(f"graph.census.{key}", value)
        with trace.span("graph.save"):
            self.graph.save(self._graph_prefix)
            tmp_meta = meta_path + ".tmp"
            with open(tmp_meta, "w", encoding="utf-8") as f:
                json.dump({"fingerprint": fp, "signature": self.graph.signature()}, f)
            os.replace(tmp_meta, meta_path)  # atomic, like the semantic-tree meta
        logger.info("Graph: %s", self.graph.info())

    # ----------------------------------------------------------------- engine
    @property
    def engine(self) -> RetrievalEngine:
        if self._engine is None:
            self._engine = RetrievalEngine(
                self.config,
                self.encoder,
                self.ver_store,
                fact_store=self.fact_store,
                sem_store=self.sem_store,
                epi_store=self.epi_store,
                graph=self.graph,
                fact_filter=self.fact_filter,
                device=self.device,
                mesh=self.mesh,
            )
        return self._engine

    # ------------------------------------------------------------- mem encode
    def mem_encode(self, query: str, docs: Dict[str, List[str]], pool: MemoryPool, probe: Optional[str] = None) -> MemoryPool:
        cfg = self.config
        b_ver, b_sem, b_epi = self._qa_layer_budgets()
        selected_vers = self.tokens.truncate_by_budget(docs["veridical"], b_ver)
        selected_sems = self.tokens.truncate_by_budget(docs["semantic"], b_sem)
        selected_epis = self.tokens.truncate_by_budget(docs["episodic"], b_epi)

        ver_cue, sem_cue, epi_cue = pool.agent.fusion(
            query=query,
            vers="\n".join(selected_vers),
            sems="\n".join(selected_sems),
            epis="\n".join(selected_epis),
        )
        for node_type, content, cue in (
            (NodeType.VER, selected_vers, ver_cue),
            (NodeType.SEM, selected_sems, sem_cue),
            (NodeType.EPI, selected_epis, epi_cue),
        ):
            pool.add_to_temp_pool(
                MemoryNode(probe=probe or query, node_type=node_type, original_content=content, cue=cue)
            )
        return pool

    # ----------------------------------------------------------- window clamps
    def _llm_window(self) -> Optional[int]:
        """The serving LLM's context window when it exposes one (jax-offline
        directly, or through the window-batching server wrapping it)."""
        window = getattr(self.llm, "max_model_len", None) or getattr(
            getattr(self.llm, "engine", None), "max_model_len", None
        )
        return int(window) if window else None

    def _qa_layer_budgets(self) -> Tuple[int, int, int]:
        """(ver, sem, epi) context budgets, scaled down when their sum
        cannot fit the engine window. An over-window prompt is LEFT-
        truncated by the offline engine — the system prompt, one-shot
        example, and the '### Final Answer' protocol instructions are cut
        off the front SILENTLY, and the meta loop's impasse machinery goes
        dead (the same trap _build_semantic_tree clamps for)."""
        cfg = self.config
        budgets = (cfg.max_tokens_ver, cfg.max_tokens_sem, cfg.max_tokens_epi)
        window = self._llm_window()
        if not window:
            return budgets
        # window - QA generation bucket - headroom for the template header,
        # question, and the historical-findings section of impasse rounds
        avail = max(192, window - cfg.qa_max_completion_tokens - 1024)
        total = sum(budgets)
        if total <= avail:
            return budgets
        scale = avail / total
        out = tuple(max(64, int(b * scale)) for b in budgets)
        logger.warning(
            "Layer context budgets %s exceed the engine window %d — scaled to %s",
            budgets, window, out,
        )
        return out

    @staticmethod
    def _is_impasse(pred: str) -> bool:
        """The impasse sentinel, tolerant of realistic spellings: the
        prompt says to write exactly \"*\" (quoted), so models emit '*',
        '\"*\"', '*.', '**', or ': *' — anything that is only asterisks
        once quoting/punctuation is stripped counts."""
        cleaned = pred.strip().strip("\"'`.:,;!()[] \t\n")
        return bool(cleaned) and set(cleaned) == {"*"}

    # --------------------------------------------------------------- meta loop
    def meta_control_loop(self, q_idx: int, query: str) -> Tuple[int, QuerySolution, Dict[str, str]]:
        cfg = self.config
        pool_agent = PoolAgent(self.llm, self.prompts)
        probe_agent = ProbeAgent(self.llm, self.prompts)
        pool = MemoryPool(encoder=self.encoder, agent=pool_agent)

        # concurrent questions route through the coalescing window
        # (try_answer installs it); single-question flows hit the engine
        retriever = self._retrieval_front or self.engine
        with trace.span("qa.initial_retrieve"):
            retrieved = retriever.tri_retrieve(query, pool.get_all_hashes())
        with trace.span("qa.mem_encode"):
            self.mem_encode(query, retrieved.as_docs(), pool)

        ver_context = "\n".join(v for n in pool.get_temp_nodes_by_type(NodeType.VER) for v in (n.original_content or []))
        sem_context = "\n".join(s for n in pool.get_temp_nodes_by_type(NodeType.SEM) for s in (n.original_content or []))
        epi_context = "\n".join(e for n in pool.get_temp_nodes_by_type(NodeType.EPI) for e in (n.original_content or []))

        historical = ""
        all_steps: List[Dict[str, Any]] = []
        step_answers: Dict[str, str] = {}
        response_text = ""
        last_error: Optional[str] = None

        for i in range(cfg.max_meta_loop_iterations + 1):
            step_info: Dict[str, Any] = {
                "step": i + 1,
                "ver_context": ver_context,
                "sem_context": sem_context,
                "epi_context": epi_context,
                "historical_information": historical,
                "total_nodes": len(pool.pool),
            }
            prompt_user = ""
            if cfg.use_ver:
                prompt_user += f"### Detail Chunks\n{ver_context}\n\n"
            if cfg.use_sem:
                prompt_user += f"### Semantic Summary\n{sem_context}\n\n"
            if cfg.use_epi:
                prompt_user += f"### Timeline Summary\n{epi_context}\n\n"
            if i != 0:
                prompt_user += f"### Historical Information\n{historical}\n\n"
            prompt_user += "Question: " + query + "\nThought: "

            if cfg.is_mc:
                template = "rag_qa_mc" if i == 0 else "rag_qa_mc_memory"
            else:
                template = "rag_qa_narrativeqa"
            messages = self.prompts.render(template, prompt_user=prompt_user)

            try:
                with trace.span("qa.llm_infer"):
                    response_text = self.llm.infer(
                        messages, max_completion_tokens=cfg.qa_max_completion_tokens
                    ).text
            except Exception as e:  # noqa: BLE001 — keep the loop alive
                logger.error("QA inference failed: %s", e)
                step_info["error"] = str(e)
                all_steps.append(step_info)
                if str(e) == last_error:
                    # identical error on the identical prompt: deterministic
                    # failure — don't burn the remaining iterations on it
                    break
                last_error = str(e)
                continue
            last_error = None

            if not response_text.strip():
                # empty content happens on real paths (null API content,
                # isolated batch errors, immediate EOS) — retry the
                # iteration like the reference instead of accepting ''
                # as the final answer
                step_info["empty_response"] = True
                all_steps.append(step_info)
                continue

            # LAST marker, matching eval/qa_eval.py's extractor: a model
            # that echoes the marker while restating the format must not
            # make the loop and the scorer read different spans
            parts = response_text.rsplit("### Final Answer", 1)
            pred = parts[1].strip() if len(parts) > 1 else response_text
            step_info["response"] = response_text
            step_info["predicted_answer"] = pred
            step_answers[f"step{i}"] = pred

            if not self._is_impasse(pred):
                all_steps.append(step_info)
                break
            if i == cfg.max_meta_loop_iterations:
                # last iteration: no further QA attempt will consume the
                # fan-out, so skip the probe/retrieve/fuse round-trips
                all_steps.append(step_info)
                break

            # ---- impasse: consolidate, probe, fan out, fuse -----------------
            pool.merge_temp_to_main()
            previous_probes = "\n".join(pool.get_all_probes())
            with trace.span("qa.find_probes"):
                probes = probe_agent.find_probes(query=query, context=prompt_user, previous_probes=previous_probes)
            step_info["probes"] = probes

            pool_hashes = pool.get_all_hashes()
            # One batched device call per layer for the WHOLE fan-out
            # (probes x {fact-score, DPR, PPR, episodic} — SURVEY.md §7.1),
            # vs the reference's sequential per-probe retrievals.
            with trace.span("qa.probe_fanout_retrieve"):
                fan_out = retriever.tri_retrieve_batch(probes, pool_hashes)
            with trace.span("qa.mem_encode"):
                for probe, retrieved_probe in zip(probes, fan_out):
                    self.mem_encode(query + " " + probe, retrieved_probe.as_docs(), pool, probe=probe)

            window = self._llm_window()
            with trace.span("qa.pool_fusion"):
                fused = pool.create_fusion_content(
                    probe=query, top_k_percent=0.5,
                    # fusion prompt budget: window - fusion completion (1000)
                    # - template/query headroom
                    max_tokens=max(256, window - 1000 - 256) if window else None,
                    token_counter=self.tokens,
                )
            if fused and fused != NO_MEMORY_SENTINEL:
                pool.add_fused_node(probe=query, fused_content=fused)

            ver_context = "\n".join(n.cue or "" for n in pool.get_temp_nodes_by_type(NodeType.VER))
            sem_context = "\n".join(n.cue or "" for n in pool.get_temp_nodes_by_type(NodeType.SEM))
            epi_context = "\n".join(n.cue or "" for n in pool.get_temp_nodes_by_type(NodeType.EPI))
            # newest findings first, capped to the headroom the layer
            # budgets reserve for this section (it grows every round)
            hist_blocks = [
                f"probe : {n.probe}\nFinding : {n.cue}\n"
                for n in pool.get_temp_nodes_by_type(NodeType.FUSION) + pool.get_nodes_by_type(NodeType.FUSION)
            ]
            kept_hist = self.tokens.truncate_by_budget(hist_blocks, 768)
            historical = "".join(kept_hist or hist_blocks[:1])
            all_steps.append(step_info)

        solution = QuerySolution(question=query, docs=ver_context, summary=sem_context, timeline=epi_context)
        solution.answer = response_text
        self._dump_details(q_idx, query, pool, all_steps)
        return q_idx, solution, step_answers

    def _dump_details(self, q_idx: int, query: str, pool: MemoryPool, steps: List[Dict[str, Any]]) -> None:
        detail_dir = os.path.join(self.config.output_dir, "details")
        os.makedirs(detail_dir, exist_ok=True)
        pool_info = {
            "total_nodes": len(pool.pool),
            "total_chunks": len(pool.get_nodes_by_type(NodeType.VER)),
            "total_summaries": len(pool.get_nodes_by_type(NodeType.SEM)),
            "total_timelines": len(pool.get_nodes_by_type(NodeType.EPI)),
            "total_probes": len(pool.get_all_probes()),
            "probes": pool.get_all_probes(),
        }
        with open(os.path.join(detail_dir, f"pool_info_{q_idx}.json"), "w", encoding="utf-8") as f:
            json.dump(pool_info, f, ensure_ascii=False, indent=4)
        with open(os.path.join(detail_dir, f"qa_output_{q_idx}.txt"), "w", encoding="utf-8") as f:
            f.write("Problem-Solving Process Overview:\n" + "=" * 50 + "\n")
            f.write(f"Query: {query}\n\n" + "=" * 50 + "\n")
            for step in steps:
                f.write(f"Step {step['step']}:\n" + "-" * 30 + "\n")
                f.write(f"Predicted Answer: {step.get('predicted_answer', 'N/A')}\n" + "-" * 30 + "\n")
                f.write(f"ver_context:\n{step['ver_context']}\n" + "-" * 30 + "\n")
                f.write(f"sem_context:\n{step['sem_context']}\n" + "-" * 30 + "\n")
                f.write(f"epi_context:\n{step['epi_context']}\n" + "-" * 30 + "\n")
                f.write(f"Historical Information:\n{step['historical_information']}\n" + "-" * 30 + "\n")
                f.write(f"Response: {step.get('response', 'N/A')}\n")
                if "probes" in step:
                    f.write("-" * 30 + f"\nprobes: {', '.join(step['probes'])}\n")
                if "error" in step:
                    f.write(f"Error: {step['error']}\n")
                f.write("=" * 50 + "\n\n")

    # -------------------------------------------------------------- try_answer
    def try_answer(self, queries: Sequence[str]) -> List[QuerySolution]:
        self.engine.prepare()
        if self._lockstep:
            solutions = self._answer_in_lockstep(queries)
            trace.dump(os.path.join(self.config.output_dir, "trace.json"))
            return solutions
        max_workers = min(16, max(1, len(queries)))
        solutions: List[Optional[QuerySolution]] = [None] * len(queries)
        # Coalesce the question threads' retrieval calls into shared
        # device batches (RetrievalWindow): sixteen concurrent ~3-probe
        # fan-outs otherwise each pad their PPR batch to the 64-column
        # good width — one merged solve does the work of sixteen. Rows
        # keep per-question pool filters, so results are identical.
        window = None
        if max_workers > 1:
            window = RetrievalWindow(self.engine)
            self._retrieval_front = window
        try:
            with ThreadPoolExecutor(max_workers=max_workers) as pool:
                futures = {
                    pool.submit(self.meta_control_loop, i, q): i for i, q in enumerate(queries)
                }
                for future in as_completed(futures):
                    i = futures[future]
                    try:
                        q_idx, solution, _ = future.result()
                    except Exception as e:  # noqa: BLE001 — isolate per question
                        # one question's uncaught error (transient device
                        # stall, poison row) must not discard every other
                        # question's completed result after hours of QA
                        logger.error("question %d failed: %s", i, e)
                        q_idx = i
                        solution = QuerySolution(question=queries[i], answer="")
                    solutions[q_idx] = solution
        finally:
            self._retrieval_front = None
            if window is not None:
                window.close()
        trace.dump(os.path.join(self.config.output_dir, "trace.json"))
        # FULL-length, positionally aligned with ``queries`` — callers zip
        # them against golds by position (cli/run.py)
        return [
            s if s is not None else QuerySolution(question=q, answer="")
            for s, q in zip(solutions, queries)
        ]

    def _answer_in_lockstep(self, queries: Sequence[str]) -> List[QuerySolution]:
        """The questions one after another in input order, with no thread
        pool and no retrieval window, so that every process of the mesh
        makes the same retrieval calls in the same order. Unlike the
        threaded path, a question's error is not isolated: it is carried
        to that question's ``agree``, so that every process raises there
        (the next collective would pair with another process's other call).
        An error between two collectives of a question leaves the other
        processes waiting in one until the process group's timeout."""
        solutions: List[QuerySolution] = []
        for i, q in enumerate(queries):
            error: Optional[Exception] = None
            try:
                _, solution, _ = self.meta_control_loop(i, q)
                outcome = ("answer", solution.answer)
            except Exception as e:  # noqa: BLE001 — carried to every process below
                # the kind alone: a message may name this process's own paths
                error, outcome = e, ("error", type(e).__name__)
            try:
                distributed.agree(outcome, f"question {i}")
            except RuntimeError as e:
                raise RuntimeError(f"{e}; this process: {outcome[0]}") from error
            if error is not None:  # every process failed alike
                raise error
            solutions.append(solution)
        return solutions
