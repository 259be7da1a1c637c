"""Tri-layer retrieval engine.

Port of ``comorag_tpu/retrieval/engine.py``: every embedding matrix is a
port ``MipsIndex``, query embeddings from a device encoder stay on the
device, and the fused PPR ranking reads the DPR prior where it was scored.
With a mesh every index and the PPR graph get it (each decides whether to
shard, as in JAX), and the engine's device is the mesh's first device,
where the sharded results merge. The logic is unchanged from the JAX
engine. Over a mesh that spans processes every call is a collective: each
process runs the same calls in the same order (``ComoRAG``'s lockstep),
an index too small to shard stays whole in every process, and the graph
search takes ``PPRGraph``'s torch iteration over the process group.

Implements the query-time call stack of the reference (SURVEY.md §3.3 —
tri_retrieve, dense_passage_retrieval, get_fact_scores,
graph_search_with_fact_entities, run_ppr):

  - the fact/passage query encodings for a whole probe fan-out are encoded
    in ONE batch and scored in ONE device call per layer,
  - a batch of probes solves PPR as one batched power iteration
    (``PPRGraph``).

Reference quirks deliberately preserved (SURVEY.md §7.3): the graph-search
path multiplies passage priors by 0.005 regardless of the config default
(ComoRAG.py:491); phrase weights divide by per-entity chunk counts
(:1020-1021); only the top ``linking_top_k`` phrases keep weight (:972-990).
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from comorag_torch.graph.builder import GraphData
from comorag_torch.ops.ppr import PPRGraph
from comorag_torch.ops.similarity import min_max_normalize, min_max_normalize_rows_np
from comorag_torch.parallel.mesh import Mesh, mesh_device
from comorag_torch.retrieval.index import MipsIndex
from comorag_torch.config import ComoConfig
from comorag_torch.prompts.linking import get_query_instruction
from comorag_torch.store.embedding_store import EmbeddingStore
from comorag_torch.utils.hashing import content_hash
from comorag_torch.utils.logging import get_logger
from comorag_torch.utils.reqwindow import RequestWindow
from comorag_torch.utils import trace

logger = get_logger(__name__)


def _dpr_prior_rows(scores_dev: torch.Tensor, rows: torch.Tensor, n_valid: int,
                    weight: float) -> torch.Tensor:
    """Min-max normalize the selected rows of a device score matrix over
    their first ``n_valid`` columns and scale by the passage prior weight
    (engine.py:49) — the device-side twin of min_max_normalize_rows_np so
    the fused PPR ranking can consume the DPR scores where they live."""
    sel = scores_dev.index_select(0, rows)[:, :n_valid]  # [bsz, n_valid]
    return min_max_normalize(sel).to(torch.float32) * weight


def _top_order(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the top-k scores, descending — argpartition + small sort
    instead of a full argsort (O(N) vs O(N log N) per probe row)."""
    k = min(k, scores.shape[0])
    if k <= 0:
        return np.zeros(0, np.int64)
    cand = np.argpartition(-scores, k - 1)[:k]
    return cand[np.argsort(-scores[cand], kind="stable")]


@dataclass
class RetrievalResult:
    veridical: List[str] = field(default_factory=list)
    semantic: List[str] = field(default_factory=list)
    episodic: List[str] = field(default_factory=list)
    rerank_log: Dict[str, Any] = field(default_factory=dict)
    linked_phrases: Dict[str, float] = field(default_factory=dict)

    def as_docs(self) -> Dict[str, List[str]]:
        return {"veridical": self.veridical, "semantic": self.semantic, "episodic": self.episodic}


class RetrievalEngine:
    def __init__(
        self,
        config: ComoConfig,
        encoder,
        ver_store: EmbeddingStore,
        fact_store: Optional[EmbeddingStore] = None,
        sem_store: Optional[EmbeddingStore] = None,
        epi_store: Optional[EmbeddingStore] = None,
        graph: Optional[GraphData] = None,
        fact_filter=None,
        device: Union[str, torch.device, None] = None,  # "cuda" when None; the mesh's first device under a mesh
        mesh: Optional[Mesh] = None,
    ):
        self.config = config
        self.encoder = encoder
        self.ver_store = ver_store
        self.fact_store = fact_store
        self.sem_store = sem_store
        self.epi_store = epi_store
        self.graph = graph
        self.fact_filter = fact_filter
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self._ready = False
        # LRU query-embedding cache behind a lock: the QA loop reads and
        # writes it from up to 16 threads, and a long multi-dataset run
        # would otherwise grow it without bound.
        self._query_cache: "OrderedDict[Tuple[str, str], np.ndarray]" = OrderedDict()
        self._query_cache_lock = threading.Lock()
        self._query_cache_max = 4096
        # prepare() is called lazily from query paths that the public API
        # advertises as merge-safe; without a guard two first-callers both
        # build (and upload) every device index
        self._prepare_lock = threading.Lock()
        # test hook: force the full [B, F] fact-score download instead of
        # the fused top-k+min fetch (parity tests flip this)
        self._use_fact_compact = True

    # ---------------------------------------------------------------- prepare
    def prepare(self) -> None:
        """Load all embedding matrices into device indexes and materialize
        graph arrays (reference prepare_retrieval_objects, ComoRAG.py:876-907)."""
        if self._ready:
            return
        with self._prepare_lock:
            self._prepare_locked()

    def _prepare_locked(self) -> None:
        if self._ready:  # double-check under the lock
            return
        kw = dict(device=self.device, mesh=self.mesh, dtype=self.config.embedding_dtype, method=self.config.topk_method,
                  scan_dtype=self.config.scan_dtype, tile_n=self.config.topk_block_rows)
        self.ver_index = MipsIndex(self.ver_store.matrix, **kw)
        self.passage_node_keys = self.ver_store.get_all_ids()

        if self.fact_store is not None and len(self.fact_store):
            self.fact_index = MipsIndex(self.fact_store.matrix, **kw)
            self.fact_node_keys = self.fact_store.get_all_ids()
        else:
            self.fact_index = None
            self.fact_node_keys = []

        if self.sem_store is not None and len(self.sem_store):
            self.sem_index = MipsIndex(self.sem_store.matrix, **kw)
            self.summary_node_keys = self.sem_store.get_all_ids()
        else:
            self.sem_index = None
            self.summary_node_keys = []

        if self.epi_store is not None and len(self.epi_store):
            self.epi_index = MipsIndex(self.epi_store.matrix, **kw)
        else:
            self.epi_index = None

        if self.graph is not None and self.graph.n_arcs > 0:
            self.ppr = PPRGraph(
                self.graph.src,
                self.graph.dst,
                self.graph.weights,
                self.graph.n_nodes,
                max_iters=self.config.ppr_max_iterations,
                tol=self.config.ppr_tolerance,
                device=self.device,
                mesh=self.mesh,
            )
            self.passage_node_idxs = np.asarray(
                [self.graph.name_to_idx[k] for k in self.passage_node_keys], np.int64
            )
        else:
            self.ppr = None
            self.passage_node_idxs = None
        self._ready = True

    # ------------------------------------------------------------- encodings
    def encode_queries(self, queries: Sequence[str]) -> Dict[str, np.ndarray]:
        """Two instruction-tuned encodings per query ('query_to_fact' and
        'query_to_passage'), cached, batched across the whole fan-out.

        Device-side encoders (``encode_device``) keep the rows ON DEVICE:
        the indexes accept device queries directly, so the fan-out skips
        the device->host->device bounce."""
        device_enc = getattr(self.encoder, "encode_device", None)
        out = {"fact": [], "passage": []}
        for space, mode in (("fact", "query_to_fact"), ("passage", "query_to_passage")):
            instruction = get_query_instruction(mode)
            with self._query_cache_lock:
                hits = {}
                for q in queries:
                    cached = self._query_cache.get((space, q))
                    if cached is not None:
                        hits[q] = cached
                        self._query_cache.move_to_end((space, q))
            missing = list(dict.fromkeys(q for q in queries if q not in hits))
            if missing:
                # norm is deliberately NOT passed: the encoder's own
                # default (config.embedding_return_as_normalized for
                # factory encoders, True for legacy injected encoders
                # with the old `norm: bool = True` signature) applies to
                # queries and corpus alike, keeping one vector space
                if device_enc is not None:
                    embs = device_enc(missing, instruction=instruction)
                else:
                    embs = self.encoder.encode(missing, instruction=instruction)
                with self._query_cache_lock:
                    for i, q in enumerate(missing):
                        row = embs[i] if device_enc is not None else np.asarray(embs[i], np.float32)
                        hits[q] = row
                        self._query_cache[(space, q)] = row
                        self._query_cache.move_to_end((space, q))
                    while len(self._query_cache) > self._query_cache_max:
                        self._query_cache.popitem(last=False)
            rows = [hits[q] for q in queries]
            if any(isinstance(r, torch.Tensor) for r in rows):
                out[space] = torch.stack([torch.as_tensor(r, device=self.device) for r in rows])
            else:
                out[space] = np.stack(rows)
        return out

    # ------------------------------------------------------------ primitives
    def fact_scores(self, fact_query_embs: np.ndarray) -> np.ndarray:
        """[P, F] min-max-normalized fact similarities (get_fact_scores)."""
        return min_max_normalize_rows_np(self.fact_index.scores(fact_query_embs))

    def dense_norm_scores(self, passage_query_embs: np.ndarray, index: MipsIndex) -> np.ndarray:
        """[P, N] min-max-normalized scores in document order. Equivalent to
        the reference's sort-then-normalize (dense_passage_retrieval):
        min-max is monotonic, so normalizing before or after ranking gives
        identical values — and priors/fallbacks don't need the full sort."""
        return min_max_normalize_rows_np(index.scores(passage_query_embs))

    def dense_ranking(self, passage_query_embs: np.ndarray, index: MipsIndex) -> Tuple[np.ndarray, np.ndarray]:
        """Full descending ranking per query: (sorted_ids [P, N], sorted
        normalized scores [P, N]). Prefer dense_norm_scores + index.topk on
        hot paths; this full sort exists for API parity and tests."""
        normalized = self.dense_norm_scores(passage_query_embs, index)
        sorted_ids = np.argsort(-normalized, axis=1)
        sorted_scores = np.take_along_axis(normalized, sorted_ids, axis=1)
        return sorted_ids, sorted_scores

    # ------------------------------------------------------------ fact rerank
    def rerank_facts(
        self,
        query: str,
        scores: Optional[np.ndarray] = None,
        candidates_pre: Optional[Tuple[Sequence[int], Sequence[float]]] = None,
    ) -> Tuple[List[int], List[Tuple[str, str, str]], dict]:
        """``candidates_pre`` = (fact indices desc, their normalized scores)
        from a device-side top-k — skips downloading the full score row."""
        candidate_idx, candidates = self._fact_candidates(scores, candidates_pre)
        link_top_k = self.config.linking_top_k
        if self.fact_filter is None:
            return candidate_idx, candidates, {"facts_before_rerank": candidates, "facts_after_rerank": candidates}
        top_idx, top_facts, _ = self.fact_filter.rerank(query, candidates, candidate_idx, link_top_k)
        return top_idx, top_facts, {
            "facts_before_rerank": [list(c) for c in candidates],
            "facts_after_rerank": [list(f) for f in top_facts],
        }

    def _fact_candidates(
        self,
        scores: Optional[np.ndarray] = None,
        candidates_pre: Optional[Tuple[Sequence[int], Sequence[float]]] = None,
    ) -> Tuple[List[int], List[Tuple[str, str, str]]]:
        """Top linking candidates for one probe: (fact indices desc, their
        triples). ``candidates_pre`` comes from a device-side top-k."""
        link_top_k = self.config.linking_top_k
        if candidates_pre is not None:
            candidate_idx = [int(i) for i in candidates_pre[0]]
        else:
            k = min(link_top_k, len(scores))
            # partial selection: a full argsort over |facts| per probe is wasted
            part = np.argpartition(-scores, k - 1)[:k] if k else np.array([], np.int64)
            candidate_idx = part[np.argsort(-scores[part], kind="stable")].tolist()
        candidates = []
        for i in candidate_idx:
            try:
                triple = json.loads(self.fact_store.get_text(self.fact_node_keys[i]))
            except json.JSONDecodeError:
                triple = ["", "", ""]
            candidates.append(tuple(triple))
        return candidate_idx, candidates

    # ----------------------------------------------------------- graph search
    def _phrase_weights(
        self,
        fact_score_row: np.ndarray,
        top_k_facts: Sequence[Tuple[str, str, str]],
        top_k_fact_indices: Sequence[int],
    ) -> Tuple[np.ndarray, Dict[str, float]]:
        """Dense [n_nodes] seed vector built from the sparse pairs."""
        pairs, used = self._phrase_seed_pairs(fact_score_row, top_k_facts, top_k_fact_indices)
        phrase_weights = np.zeros(self.graph.n_nodes, np.float64)
        for node_id, w in pairs:
            phrase_weights[node_id] = w
        return phrase_weights, used

    def _phrase_seed_pairs(
        self,
        fact_score_row: np.ndarray,
        top_k_facts: Sequence[Tuple[str, str, str]],
        top_k_fact_indices: Sequence[int],
    ) -> Tuple[List[Tuple[int, float]], Dict[str, float]]:
        """Seed entity-node weights from reranked facts, as sparse
        (node_id, weight) pairs — ≤ 2 x linking_top_k entries, so the
        fused device path uploads O(B x S) instead of [B, n_nodes]
        (graph_search_with_fact_entities phrase side, ComoRAG.py:1005-1026)."""
        g = self.graph
        pairs: List[Tuple[int, float]] = []
        linking_score_map: Dict[str, float] = {}
        phrase_scores: Dict[str, List[float]] = {}
        used_phrases: Dict[str, float] = {}

        for rank, fact in enumerate(top_k_facts):
            fact_score = float(fact_score_row[top_k_fact_indices[rank]])
            for phrase in (str(fact[0]).lower(), str(fact[2]).lower()):
                phrase_scores.setdefault(phrase, []).append(fact_score)

        for phrase, scores in phrase_scores.items():
            linking_score_map[phrase] = float(np.mean(scores))

        # Only the top-k linked phrases receive weight (get_top_k_weights
        # semantics) — assigning just those replaces the reference's
        # all-nodes zeroing scan (ComoRAG.py:972-990).
        link_top_k = self.config.linking_top_k
        top_phrases = sorted(linking_score_map.items(), key=lambda kv: kv[1], reverse=True)
        if link_top_k:
            top_phrases = top_phrases[:link_top_k]
        for phrase, _ in top_phrases:
            phrase_key = content_hash(phrase, prefix="entity-")
            node_id = g.name_to_idx.get(phrase_key)
            if node_id is None:
                continue
            # the reference's per-fact loop overwrites, so the LAST fact
            # mentioning the phrase supplies its weight (ComoRAG.py:1018)
            weight = phrase_scores[phrase][-1]
            num_chunks = g.ent_node_to_num_chunk.get(phrase_key, 0)
            if num_chunks:
                weight /= num_chunks
            pairs.append((int(node_id), float(weight)))
            if weight > 0:
                used_phrases[phrase] = weight
        return pairs, used_phrases

    def _passage_priors(self, dpr_norm_row: np.ndarray, passage_node_weight: float) -> np.ndarray:
        """DPR passage priors for one probe's graph seeds
        (ComoRAG.py:1034-1042), vectorized: dpr_norm_row is the [N]
        normalized score vector in document order."""
        passage_weights = np.zeros(self.graph.n_nodes, np.float64)
        passage_weights[self.passage_node_idxs] = dpr_norm_row * passage_node_weight
        return passage_weights

    def graph_search(
        self,
        passage_query_emb: np.ndarray,
        fact_score_row: np.ndarray,
        top_k_facts: Sequence[Tuple[str, str, str]],
        top_k_fact_indices: Sequence[int],
        passage_node_weight: float = 0.005,
    ) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
        """Single-probe graph search: seed weights -> PPR -> passage ranking
        (graph_search_with_fact_entities semantics). The batched fan-out
        path is graph_search_batch."""
        phrase_weights, used = self._phrase_weights(fact_score_row, top_k_facts, top_k_fact_indices)
        dpr_norm = self.dense_norm_scores(passage_query_emb[None, :], self.ver_index)
        node_weights = phrase_weights + self._passage_priors(dpr_norm[0], passage_node_weight)
        if node_weights.sum() <= 0:
            raise ValueError("No graph seeds for the given facts")
        ppr_scores = self.ppr.query(node_weights[None, :], damping=self.config.damping)[0]
        doc_scores = ppr_scores[self.passage_node_idxs]
        order = np.argsort(-doc_scores)
        return order, doc_scores[order], used

    # ------------------------------------------------------------ tri_retrieve
    def tri_retrieve(
        self,
        query: str,
        pool_hashes: Optional[Dict[str, List[str]]] = None,
        ver_top_k: Optional[int] = None,
        sem_top_k: Optional[int] = None,
        epi_top_k: Optional[int] = None,
    ) -> RetrievalResult:
        return self.tri_retrieve_batch([query], pool_hashes, ver_top_k, sem_top_k, epi_top_k)[0]

    def tri_retrieve_batch(
        self,
        queries: Sequence[str],
        pool_hashes: Optional[Dict[str, List[str]]] = None,
        ver_top_k: Optional[int] = None,
        sem_top_k: Optional[int] = None,
        epi_top_k: Optional[int] = None,
        pool_hashes_rows: Optional[Sequence[Optional[Dict[str, List[str]]]]] = None,
    ) -> List[RetrievalResult]:
        """The batched probe fan-out (SURVEY.md §7.1's idiomatic shift): the
        whole fan-out encodes in one batch, scores each memory layer with
        ONE device call, and solves every probe's PPR in ONE batched call —
        vs the reference's ~9 sequential per-probe retrievals per iteration
        (ComoRAG.py:356-358).

        ``pool_hashes_rows`` gives each row its OWN pool filter (the pool
        hashes are a post-retrieval dedup, so rows from different
        questions merge safely — the RetrievalWindow uses this to coalesce
        concurrent meta-loop fan-outs into one device batch)."""
        self.prepare()
        cfg = self.config
        # `is None` (not falsy-or): an explicit top_k=0 disables a layer,
        # it must not balloon to the config default
        ver_top_k = cfg.qa_ver_top_k if ver_top_k is None else ver_top_k
        sem_top_k = cfg.qa_sem_top_k if sem_top_k is None else sem_top_k
        epi_top_k = cfg.qa_epi_top_k if epi_top_k is None else epi_top_k
        pool_hashes = pool_hashes or {}
        queries = list(queries)
        b = len(queries)

        def seen_rows(layer: str) -> List[set]:
            if pool_hashes_rows is None:
                shared = set(pool_hashes.get(layer, []))
                return [shared] * b
            return [set((ph or {}).get(layer, [])) for ph in pool_hashes_rows]

        results = [RetrievalResult() for _ in range(b)]
        if b == 0:
            return results

        with trace.span("retrieve.encode_queries"):
            embs = self.encode_queries(queries)
        fact_embs = embs["fact"]      # [B, d]
        passage_embs = embs["passage"]  # [B, d]

        # Launch EVERY layer's device scoring up front — the four calls
        # queue on one stream and their host copies overlap, so the
        # fan-out waits on the device once instead of four times.
        with trace.span("retrieve.dispatch"):
            # dense scoring with a COMPACT stats transfer: the fan-out
            # consumes only each row's normalized sum (the PPR prior
            # weight) and top-k fallback candidates on the host, while the
            # [B, N] buffer stays on device for the fused prior.
            ver_handle = self.ver_index.scores_stats_async(passage_embs, k=ver_top_k)
            # candidates + min-max stats in one tiny transfer instead of
            # the full [B, F] fact-score matrix
            fact_compact = self.fact_index is not None and self._use_fact_compact
            if self.fact_index is not None and self.ppr is not None:
                if fact_compact:
                    fact_handle = self.fact_index.topk_min_async(fact_embs, k=cfg.linking_top_k)
                else:
                    fact_handle = self.fact_index.scores_async(fact_embs)
            else:
                fact_handle = None
            sem_handle = (
                self.sem_index.topk_async(passage_embs, k=sem_top_k)
                if self.sem_index is not None
                else None
            )
            epi_handle = (
                self.epi_index.topk_async(passage_embs, k=epi_top_k)
                if self.epi_index is not None
                else None
            )

        # ---- veridical branch: facts -> rerank -> batched graph PPR -------
        # One DPR scoring call serves priors AND the no-facts fallback
        # (top-k on device; no full host sort on the fan-out path).
        with trace.span("retrieve.dense_ranking"):
            dpr_vals, dpr_idx, dpr_min, dpr_sum = ver_handle.stats()
            n_docs_total = self.ver_index.n
            # normalized row sum from raw (sum, min, max): with
            # x' = (x - lo)/(hi - lo), sum(x') = (sum - N*lo)/(hi - lo);
            # an all-equal row normalizes to all-ones (sum = N), matching
            # min_max_normalize_rows_np.
            if dpr_vals.size:
                span0 = dpr_vals[:, 0].astype(np.float64) - dpr_min.astype(np.float64)
                dpr_norm_sum = np.where(
                    span0 == 0,
                    float(n_docs_total),
                    (dpr_sum.astype(np.float64) - n_docs_total * dpr_min.astype(np.float64))
                    / np.where(span0 == 0, 1.0, span0),
                )
            else:
                dpr_norm_sum = np.zeros(b, np.float64)
        sorted_doc_ids: List[Optional[np.ndarray]] = [None] * b
        if fact_handle is not None:
            with trace.span("retrieve.fact_scores"):
                if fact_compact:
                    cand_vals, cand_idx, row_min = fact_handle.result()
                    # min-max over the full row: max = best candidate,
                    # min from the fused reduction; all-equal rows -> 1.0
                    # (min_max_normalize_rows_np semantics)
                    span = cand_vals[:, 0] - row_min
                    safe = np.where(span == 0, 1.0, span)[:, None]
                    cand_norm = np.where(
                        span[:, None] == 0, 1.0, (cand_vals - row_min[:, None]) / safe
                    )
                    score_rows = [
                        dict(zip(cand_idx[qi].tolist(), cand_norm[qi].tolist()))
                        for qi in range(b)
                    ]
                else:
                    score_rows = min_max_normalize_rows_np(fact_handle.result())  # [B, F]
            # Seeds are collected SPARSE for every probe (cheap: <=
            # 2 x linking_top_k pairs each); the host/device route is
            # decided AFTERWARDS on the ACTUAL seed batch size — a fan-out
            # where only one probe links facts must still use the native
            # host solver the measured crossover picks for B=1.
            seeds_sparse: List[Tuple[int, List[Tuple[int, float]]]] = []
            with trace.span("retrieve.fact_rerank"):
                # every row's filter prompt goes to the LLM as ONE batch:
                # this loop runs on a single thread (the retrieval window's
                # scheduler), so per-row infer calls would serialize the
                # generations that used to overlap across question threads
                cand_rows = [
                    self._fact_candidates(candidates_pre=(cand_idx[qi], cand_norm[qi]))
                    if fact_compact
                    else self._fact_candidates(scores=score_rows[qi])
                    for qi in range(b)
                ]
                if self.fact_filter is not None:
                    filtered = self.fact_filter.rerank_batch(
                        list(queries),
                        [c for _, c in cand_rows],
                        [i for i, _ in cand_rows],
                        cfg.linking_top_k,
                    )
                else:
                    filtered = [(ci, cc, {"confidence": None}) for ci, cc in cand_rows]
                for qi, query in enumerate(queries):
                    row = score_rows[qi]
                    top_idx, top_facts, _ = filtered[qi]
                    results[qi].rerank_log = {
                        "facts_before_rerank": [list(c) for c in cand_rows[qi][1]],
                        "facts_after_rerank": [list(f) for f in top_facts],
                    }
                    if not top_facts:
                        continue
                    pairs, used = self._phrase_seed_pairs(row, top_facts, top_idx)
                    total = sum(w for _, w in pairs) + float(dpr_norm_sum[qi]) * 0.005
                    if total <= 0:
                        continue
                    results[qi].linked_phrases = used
                    seeds_sparse.append((qi, pairs))
            # Fused device route (seed batch large enough that PPR solves
            # on the device anyway): sparse seeds go UP, top-k comes DOWN,
            # and the DPR prior never leaves the device — no dense
            # [B, n_nodes] reset upload or rank download.
            use_fused = bool(seeds_sparse) and self.ppr.routes_device(len(seeds_sparse))
            if use_fused:
                s_pad = max(8, -(-max(len(p) for _, p in seeds_sparse) // 8) * 8)
                bsz = len(seeds_sparse)
                seed_idx = np.zeros((bsz, s_pad), np.int32)
                seed_w = np.zeros((bsz, s_pad), np.float32)
                for row, (qi, pairs) in enumerate(seeds_sparse):
                    for j, (nid, w) in enumerate(pairs):
                        seed_idx[row, j] = nid
                        seed_w[row, j] = w
                dev_scores, _, n_docs = ver_handle.device_scores()
                rows = torch.as_tensor([qi for qi, _ in seeds_sparse], device=dev_scores.device)
                prior = _dpr_prior_rows(dev_scores, rows, n_docs, 0.005)  # [bsz, n_docs] on device
                with trace.span("retrieve.ppr"):
                    _, pos = self.ppr.query_topk(
                        seed_idx, seed_w, self.passage_node_idxs, prior,
                        ver_top_k, damping=cfg.damping,
                    )
                for row, (qi, _) in enumerate(seeds_sparse):
                    sorted_doc_ids[qi] = pos[row]
            elif seeds_sparse:
                # host/native route: materialize dense resets from the
                # sparse pairs (fp32 — the device solver computes in fp32
                # and the native one re-normalizes in float64 anyway).
                # Only THIS branch needs dense DPR rows, and only for the
                # probes that linked facts: slice those rows on device and
                # download the subset (vs the full [B, N] matrix).
                with trace.span("retrieve.dense_fetch"):
                    seed_rows = np.asarray([qi for qi, _ in seeds_sparse], np.int32)
                    dpr_rows = min_max_normalize_rows_np(ver_handle.result_rows(seed_rows))
                resets = np.zeros((len(seeds_sparse), self.graph.n_nodes), np.float32)
                for row, (qi, pairs) in enumerate(seeds_sparse):
                    for nid, w in pairs:
                        resets[row, nid] = w
                    resets[row, self.passage_node_idxs] += dpr_rows[row] * 0.005
                with trace.span("retrieve.ppr"):
                    ppr_scores = self.ppr.query(resets, damping=cfg.damping)  # ONE batched solve
                with trace.span("retrieve.ppr_rank"):
                    for row, (qi, _) in enumerate(seeds_sparse):
                        doc_scores = ppr_scores[row][self.passage_node_idxs]
                        sorted_doc_ids[qi] = _top_order(doc_scores, ver_top_k)

        ver_seen_rows = seen_rows("veridical")
        k_ver = min(ver_top_k, n_docs_total)
        # fallback rows (no facts linked) take their top docs straight off
        # the device top-k — already sorted descending, no dense download
        dense_rows = [qi for qi in range(b) if sorted_doc_ids[qi] is None]
        dpr_top = {qi: dpr_idx[qi][:k_ver] for qi in dense_rows} if k_ver else {}
        for qi in range(b):
            doc_order = sorted_doc_ids[qi][:ver_top_k] if sorted_doc_ids[qi] is not None else dpr_top.get(qi, np.zeros(0, np.int64))
            top_docs = [self.ver_store.get_text(self.passage_node_keys[i]) for i in doc_order]
            # Pool dedup. NOTE: the reference compares store-namespace hashes
            # against node-type-prefixed pool hashes, which never match — its
            # dedup is a silent no-op (ComoRAG.py:504-505 vs memory_utils.py:41).
            # Here both sides hash with the node-type prefix so consolidation
            # actually deduplicates.
            if ver_seen_rows[qi]:
                top_docs = [d for d in top_docs if content_hash(d, "veridical-") not in ver_seen_rows[qi]]
            # chronological re-sort by insertion order
            top_docs.sort(key=lambda d: self.ver_store.order_of(self.ver_store.key_for(d)))
            results[qi].veridical = top_docs

        # ---- semantic branch: one device top-k for the whole fan-out ------
        if sem_handle is not None:
            _, sem_ids = sem_handle.result()
            sem_seen_rows = seen_rows("semantical")
            for qi in range(b):
                top_sem = [self.sem_store.get_text(self.summary_node_keys[i]) for i in sem_ids[qi]]
                if sem_seen_rows[qi]:
                    top_sem = [s for s in top_sem if content_hash(s, "semantical-") not in sem_seen_rows[qi]]
                results[qi].semantic = top_sem

        # ---- episodic branch: one top-k call for the whole fan-out --------
        if epi_handle is not None:
            _, epi_idx = epi_handle.result()
            epi_keys = self.epi_store.get_all_ids()
            epi_seen_rows = seen_rows("episodic")
            for qi in range(b):
                top_epi = [self.epi_store.get_text(epi_keys[i]) for i in epi_idx[qi]]
                if epi_seen_rows[qi]:
                    top_epi = [e for e in top_epi if content_hash(e, "episodic-") not in epi_seen_rows[qi]]
                top_epi.sort(key=lambda e: self.epi_store.order_of(self.epi_store.key_for(e)))
                results[qi].episodic = top_epi

        return results


class RetrievalWindow(RequestWindow):
    """Cross-question fan-out coalescing (port of engine.py:637).

    ``try_answer`` runs up to 16 question threads (the reference's
    concurrency envelope, ComoRAG.py:436-437), and each thread's meta
    loop issues its own ``tri_retrieve_batch`` — on the impasse path a
    ~3-probe fan-out. This window collects concurrent calls for a few
    milliseconds, merges same-top-k groups into one engine batch (each
    row keeps its own pool filter via ``pool_hashes_rows``), and splits
    the results, so sixteen small encodes, scorings and PPR solves become
    one batch of each.

    Rows are computed independently throughout the engine (per-row
    encode, per-row rerank, independent PPR columns), so merged results
    are identical to separate calls.

    It refuses an engine over a mesh that spans processes: each process's
    window would form its own batches from its own thread timing, so the
    processes would enter different sequences of collectives (the
    reference's ``try_answer`` hangs so over a process mesh with more than
    one question; ``ComoRAG`` runs such questions in lockstep instead).
    """

    def __init__(self, engine: RetrievalEngine, window_ms: float = 4.0, max_rows: int = 64):
        if engine.mesh is not None and engine.mesh.process_count > 1:
            raise ValueError("a RetrievalWindow coalesces by thread timing, which differs between processes: "
                             "over a mesh that spans processes call the engine in lockstep")
        self.engine = engine
        self.max_rows = max_rows
        # scheduler plumbing (queue/drain/close) is the RequestWindow
        # skeleton; items weigh their ROW count so max_rows bounds the
        # merged device batch — a burst must not snowball into one
        # unbounded merge
        super().__init__(window_ms / 1000.0, max_rows, "retrieval-window")

    # ------------------------------------------------------------ interface
    def submit(self, queries, pool_hashes=None, ver_top_k=None, sem_top_k=None, epi_top_k=None):
        from concurrent.futures import Future

        fut: Future = Future()
        self._enqueue((list(queries), pool_hashes, (ver_top_k, sem_top_k, epi_top_k), fut))
        return fut

    def tri_retrieve_batch(self, queries, pool_hashes=None, ver_top_k=None,
                           sem_top_k=None, epi_top_k=None):
        return self.submit(queries, pool_hashes, ver_top_k, sem_top_k, epi_top_k).result()

    def tri_retrieve(self, query, pool_hashes=None, ver_top_k=None,
                     sem_top_k=None, epi_top_k=None):
        return self.tri_retrieve_batch([query], pool_hashes, ver_top_k, sem_top_k, epi_top_k)[0]

    # ------------------------------------------------------------ scheduler
    def _units(self, item) -> int:
        return len(item[0])  # queued ROW count (queries per request)

    def _on_serve_error(self, batch, e: Exception) -> None:
        # _serve handles per-group failures itself; this is the safety net
        # for errors outside those try blocks
        for _, _, _, fut in batch:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(e)

    def _serve(self, batch) -> None:
        groups: Dict[tuple, list] = {}
        for req in batch:
            groups.setdefault(req[2], []).append(req)
        for (vk, sk, ek), reqs in groups.items():
            try:
                queries, rows_ph = [], []
                for q, ph, _, _ in reqs:
                    queries.extend(q)
                    rows_ph.extend([ph] * len(q))
                out = self.engine.tri_retrieve_batch(
                    queries, ver_top_k=vk, sem_top_k=sk, epi_top_k=ek,
                    pool_hashes_rows=rows_ph,
                )
            except Exception as e:  # noqa: BLE001 — keep the thread alive
                # Retry each request ALONE: pre-window, a failure was
                # confined to its own question thread — one poison row
                # or transient device error must not crash every
                # concurrent requester's future.
                logger.warning(
                    "retrieval window group failed (%s) — retrying "
                    "requests individually", e,
                )
                for q, ph, _, fut in reqs:
                    if not fut.set_running_or_notify_cancel():
                        continue
                    try:
                        fut.set_result(self.engine.tri_retrieve_batch(
                            q, ver_top_k=vk, sem_top_k=sk, epi_top_k=ek,
                            pool_hashes_rows=[ph] * len(q),
                        ))
                    except Exception as ee:  # noqa: BLE001 — its own fault now
                        fut.set_exception(ee)
                continue
            at = 0
            for q, _, _, fut in reqs:
                if not fut.set_running_or_notify_cancel():
                    at += len(q)
                    continue
                fut.set_result(out[at : at + len(q)])
                at += len(q)
