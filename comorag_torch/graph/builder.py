"""Entity/passage graph construction (host) -> device PPR arrays.

Port of ``comorag_tpu/graph/builder.py``: the same graph, the same
``graph.npz`` / ``graph.json`` artifacts (loadable by either package), and
the synonymy KNN through the port's ``MipsIndex`` on the given device.

Capability parity with the reference's graph layer (ComoRAG.py:627-841):

  - fact edges: each OpenIE triple adds weight-accumulating edges between
    its subject and object entity nodes, recorded in BOTH directions —
    reproducing the reference's double-entry stats that materialize as two
    parallel undirected igraph edges (ComoRAG.py:641-644);
  - passage edges: chunk -> contained-entity edges, weight 1.0;
  - synonymy edges: KNN over entity embeddings (device MIPS kernel instead
    of torch.mm loops — this is indexing's #1 hot loop, SURVEY.md §3.1),
    similarity >= threshold, <=100 neighbors/node, entities longer than 2
    alphanumeric chars;
  - per-entity chunk counts (weight normalization in graph search).

Persistence is a .npz (arcs) + .json (node names) pair replacing GraphML.
The finalized graph feeds ``ops.ppr.PPRGraph`` (arcs = stats entries
expanded symmetrically, exactly matching igraph's undirected weighted
semantics under PPR).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from comorag_torch.parallel.mesh import Mesh, mesh_device
from comorag_torch.retrieval.index import MipsIndex
from comorag_torch.utils.hashing import content_hash
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)


class GraphData:
    """Finalized graph: node table + symmetric arc arrays."""

    def __init__(
        self,
        node_names: List[str],
        src: np.ndarray,
        dst: np.ndarray,
        weights: np.ndarray,
        ent_node_to_num_chunk: Dict[str, int],
        census: Optional[Dict[str, int]] = None,
    ):
        self.node_names = node_names
        self.name_to_idx = {n: i for i, n in enumerate(node_names)}
        self.src = src
        self.dst = dst
        self.weights = weights
        self.ent_node_to_num_chunk = ent_node_to_num_chunk
        self.census = dict(census or {})

    @property
    def n_nodes(self) -> int:
        return len(self.node_names)

    @property
    def n_arcs(self) -> int:
        return len(self.src)

    def signature(self) -> str:
        """Content digest over the arc arrays + node numbering. Stored in
        the rebuild-skip meta so a torn save (e.g. new .npz beside an old
        .json after a crash) can never pair a valid input fingerprint with
        a mismatched artifact and serve PPR over wrong node indices."""
        import hashlib

        h = hashlib.sha256()
        h.update(np.int64(len(self.node_names)).tobytes())
        h.update(np.ascontiguousarray(self.src).tobytes())
        h.update(np.ascontiguousarray(self.dst).tobytes())
        h.update(np.ascontiguousarray(self.weights).tobytes())
        for name in self.node_names:
            h.update(name.encode())
            h.update(b"\x00")
        return h.hexdigest()

    def save(self, path_prefix: str) -> None:
        # atomic per file (tmp + rename): a crash can still leave a NEW
        # .npz beside an OLD .json, but the meta signature check above
        # catches that pairing at skip time.
        np.savez_compressed(
            path_prefix + ".npz.tmp", src=self.src, dst=self.dst, weights=self.weights
        )
        # numpy appends .npz to names that don't already end with it
        os.replace(path_prefix + ".npz.tmp.npz", path_prefix + ".npz")
        with open(path_prefix + ".json.tmp", "w", encoding="utf-8") as f:
            json.dump(
                {
                    "node_names": self.node_names,
                    "ent_node_to_num_chunk": self.ent_node_to_num_chunk,
                    "census": self.census,
                },
                f,
            )
        os.replace(path_prefix + ".json.tmp", path_prefix + ".json")

    @classmethod
    def load(cls, path_prefix: str) -> Optional["GraphData"]:
        if not (os.path.exists(path_prefix + ".npz") and os.path.exists(path_prefix + ".json")):
            return None
        arrays = np.load(path_prefix + ".npz")
        with open(path_prefix + ".json", encoding="utf-8") as f:
            meta = json.load(f)
        return cls(
            meta["node_names"],
            arrays["src"],
            arrays["dst"],
            arrays["weights"],
            meta["ent_node_to_num_chunk"],
            census=meta.get("census"),
        )

    def info(self) -> Dict[str, float]:
        # arcs are directed half-edges; symmetric pairs make arcs/nodes
        # exactly the average undirected degree (ref get_graph_info logs
        # the same structural summary after augmentation)
        out: Dict[str, float] = {
            "num_nodes": self.n_nodes,
            "num_arcs": self.n_arcs,
            "avg_degree": round(self.n_arcs / self.n_nodes, 4) if self.n_nodes else 0.0,
        }
        out.update(self.census)
        return out


def _key_blocked_topk(
    embs: np.ndarray,
    query_batches: Sequence[np.ndarray],
    k: int,
    key_batch_size: int,
    device: torch.device,
) -> Tuple[np.ndarray, np.ndarray]:
    """Two-level top-k with the key matrix streamed through the device in
    blocks of ``key_batch_size`` rows (reference retrieve_knn semantics,
    embed_utils.py:23-95): only one block is device-resident at a time, a
    running host-side merge keeps the global best-k per query."""
    n = embs.shape[0]
    # upload the queries ONCE — MipsIndex accepts device-resident query
    # batches; re-uploading them per key block would multiply the copies
    query_batches = [torch.as_tensor(np.asarray(q, np.float32), device=device) for q in query_batches]
    run_s: Optional[np.ndarray] = None
    run_i: Optional[np.ndarray] = None
    for start in range(0, n, key_batch_size):
        block = embs[start : start + key_batch_size]
        index = MipsIndex(block, device=device)
        outs = index.topk_many(query_batches, k=min(k, block.shape[0]))
        s = np.concatenate([np.asarray(o[0]) for o in outs], axis=0)
        i = np.concatenate([np.asarray(o[1]) for o in outs], axis=0).astype(np.int64) + start
        if run_s is None:
            run_s, run_i = s, i
        else:
            cs = np.concatenate([run_s, s], axis=1)
            ci = np.concatenate([run_i, i], axis=1)
            kk = min(k, cs.shape[1])
            part = np.argpartition(-cs, kk - 1, axis=1)[:, :kk]
            rows = np.arange(cs.shape[0])[:, None]
            run_s, run_i = cs[rows, part], ci[rows, part]
    assert run_s is not None and run_i is not None
    order = np.argsort(-run_s, axis=1, kind="stable")
    rows = np.arange(run_s.shape[0])[:, None]
    return run_s[rows, order], run_i[rows, order]


class GraphBuilder:
    def __init__(self):
        # stats entry (u, v) -> weight; each entry becomes a symmetric arc pair.
        self.stats: Dict[Tuple[str, str], float] = {}
        self.ent_node_to_num_chunk: Dict[str, int] = {}
        # entity-name -> node-key memo: corpora mention the same entities
        # across many triples (3.2M hash calls over ~200k uniques at
        # 200k-chunk scale profiled as half the add_fact_edges wall)
        self._ekey: Dict[str, str] = {}
        self._synonymy_count = 0  # exact, for the census

    def _entity_key(self, name: str) -> str:
        key = self._ekey.get(name)
        if key is None:
            key = self._ekey[name] = content_hash(name, prefix="entity-")
        return key

    # ------------------------------------------------------------- fact edges
    def add_fact_edges(self, chunk_ids: Sequence[str], chunk_triples: Sequence[Sequence[Sequence[str]]]) -> None:
        for chunk_key, triples in zip(chunk_ids, chunk_triples):
            entities_in_chunk = set()
            for triple in triples:
                if len(triple) != 3:
                    continue
                subj_key = self._entity_key(str(triple[0]))
                obj_key = self._entity_key(str(triple[2]))
                self.stats[(subj_key, obj_key)] = self.stats.get((subj_key, obj_key), 0.0) + 1.0
                self.stats[(obj_key, subj_key)] = self.stats.get((obj_key, subj_key), 0.0) + 1.0
                entities_in_chunk.add(subj_key)
                entities_in_chunk.add(obj_key)
            for node in entities_in_chunk:
                self.ent_node_to_num_chunk[node] = self.ent_node_to_num_chunk.get(node, 0) + 1

    # ---------------------------------------------------------- passage edges
    def add_passage_edges(self, chunk_ids: Sequence[str], chunk_triple_entities: Sequence[Sequence[str]]) -> int:
        num_new = 0
        for chunk_key, entities in zip(chunk_ids, chunk_triple_entities):
            for ent in entities:
                self.stats[(chunk_key, self._entity_key(str(ent)))] = 1.0
            num_new += 1
        return num_new

    # --------------------------------------------------------- synonymy edges
    def add_synonymy_edges(
        self,
        entity_keys: Sequence[str],
        entity_texts: Sequence[str],
        entity_embeddings: np.ndarray,
        device: Union[str, torch.device, None] = None,
        topk: int = 2047,
        sim_threshold: float = 0.8,
        max_neighbors: int = 100,
        query_batch_size: int = 1000,
        key_batch_size: int = 10000,
        key_bytes_budget: int = 2 << 30,
        mesh: Optional[Mesh] = None,
    ) -> int:
        """Device KNN over all entities with pipelined query batches
        (one giant call would materialize an [n, n] score matrix beyond
        HBM at 100k+ entities; the reference batches at 1000 too,
        config_utils.py:156-159), then host thresholding.

        ``key_batch_size`` (reference key batching, embed_utils.py:23-95)
        engages only when the key matrix exceeds ``key_bytes_budget``: the
        reference streams keys unconditionally because torch materializes
        the block on one GPU, whereas here the index is device-resident,
        so streaming below the memory budget would only cost throughput.
        With a mesh the key matrix goes into one ``MipsIndex(mesh=...)``,
        which shards it over the ``corpus`` axis when it is large enough,
        instead of the key-blocked single-device sweep (builder.py:263);
        over a mesh that spans processes every process runs the sweep in
        lockstep (the index's collectives) and adds the same edges.
        Runs on the card unless ``device="cpu"`` (under a mesh, on the
        mesh's first device); without a card the default raises."""
        device = mesh_device(mesh, device)
        n = len(entity_keys)
        if n < 2:
            return 0
        embs = np.asarray(entity_embeddings, np.float32)
        # the reference F.normalize()s BOTH sides unconditionally before
        # this threshold (embed_utils.py:27-31) — with a ':raw' store
        # (embedding_return_as_normalized=False) raw dot products would
        # gate on vector NORMS, not similarity
        norms = np.linalg.norm(embs, axis=1, keepdims=True)
        if not np.allclose(norms, 1.0, atol=1e-3):
            embs = embs / np.maximum(norms, 1e-12)
        # The consumer below accepts at most ``max_neighbors`` edges per
        # node, skipping only self (<= 1 entry) and empty-text neighbors
        # (counted exactly here), so retrieving the reference's full
        # topk=2047 per node is pure waste: top-(max_neighbors + skips)
        # is outcome-identical and shrinks the [n, k] score/idx download
        # ~19x (3.3 GB -> 173 MB at 200k entities) plus the top_k device
        # cost, which grows steeply with k.
        n_empty = sum(1 for t in entity_texts if not t)
        # (+2: self plus the reference's off-by-one — its `num_nns > 100`
        # check runs AFTER the post-add increment, accepting 101 edges)
        k = min(topk, n, max_neighbors + 2 + n_empty)
        batches = [embs[i : i + query_batch_size] for i in range(0, n, query_batch_size)]
        if mesh is None and embs.nbytes > key_bytes_budget and key_batch_size < n:
            scores, idx = _key_blocked_topk(embs, batches, k, key_batch_size, device=device)
        else:
            index = MipsIndex(embs, device=device, mesh=mesh)
            outs = index.topk_many(batches, k=k)
            scores = np.concatenate([s for s, _ in outs], axis=0)
            idx = np.concatenate([i for _, i in outs], axis=0)

        # Vectorized thresholding (the per-element Python loop measured
        # ~49 s at 200k entities x k~100 — interpreter branching, not the
        # dict): scores arrive sorted descending per row, so the loop's
        # `score < threshold` break is a prefix mask; `num_nns` counts
        # ACCEPTED entries only (self/empty-text skips don't consume
        # budget), i.e. keep eligible entries whose within-row eligible
        # rank is < max_neighbors. Insertion order per row is preserved,
        # so later-duplicate-overwrites match the loop exactly.
        q_ok = np.fromiter(
            (len(re.sub(r"[^A-Za-z0-9]", "", t)) > 2 for t in entity_texts),
            bool, count=n,
        )
        t_nonempty = np.fromiter((bool(t) for t in entity_texts), bool, count=n)
        eligible = (
            (scores >= sim_threshold)
            & q_ok[:, None]
            & (idx != np.arange(n)[:, None])
            & t_nonempty[idx]
        )
        # the reference accepts max_neighbors + 1 edges per node: its
        # `num_nns > 100` break fires one iteration AFTER the 101st add
        # (ComoRAG.py:698-710) — parity means matching that off-by-one
        eligible &= np.cumsum(eligible, axis=1) <= max_neighbors + 1
        qs, cols = np.nonzero(eligible)
        ns = idx[qs, cols]
        ws = scores[qs, cols].astype(float)
        self.stats.update(
            zip(
                zip((entity_keys[q] for q in qs), (entity_keys[ni] for ni in ns)),
                ws.tolist(),
            )
        )
        num_added = int(qs.shape[0])
        self._synonymy_count += num_added
        logger.info("Added %d synonymy edges", num_added)
        return num_added

    # --------------------------------------------------------------- census
    def census(
        self,
        node_names: Sequence[str],
        passage_keys: Sequence[str],
        summary_keys: Sequence[str] = (),
        num_extracted_triples: Optional[int] = None,
    ) -> Dict[str, int]:
        """Structural graph census — reference ``get_graph_info`` parity
        (ComoRAG.py:843-874): node counts by class, stats-entry counts by
        edge class. ``num_extracted_triples`` is the fact-store row count
        (unique OpenIE triples); synonymy entries are the remainder after
        fact and passage entries, mirroring the reference's arithmetic
        (its double-entry fact edges make two stats entries per triple, so
        the remainder subtracts BOTH — same here)."""
        passage_set = set(passage_keys)
        summary_set = set(summary_keys)
        n_passage = len(passage_set)
        n_summary = len(summary_set)
        n_phrase = len(set(node_names)) - n_passage - n_summary
        with_passage = sum(
            1 for (u, v) in self.stats if u in passage_set or v in passage_set
        )
        total = len(self.stats)
        out: Dict[str, int] = {
            "num_phrase_nodes": n_phrase,
            "num_passage_nodes": n_passage,
            "num_summary_nodes": n_summary,
            "num_total_nodes": n_phrase + n_passage + n_summary,
            "num_triples_with_passage_node": with_passage,
            "num_total_triples": total,
        }
        # deviation from the reference (documented, SURVEY §7.3 style):
        # it derives synonymy as `total - extracted - with_passage`, which
        # miscounts because fact triples are double-entered in the stats
        # while the fact store counts each once; we track the exact count
        # at add time instead.
        out["num_synonymy_triples"] = self._synonymy_count
        if num_extracted_triples is not None:
            out["num_extracted_triples"] = int(num_extracted_triples)
        return out

    # -------------------------------------------------------------- finalize
    def finalize(self, node_names: Sequence[str], directed: bool = False) -> GraphData:
        """Materialize arcs over the given node universe; stats entries whose
        endpoints are unknown are dropped (with a warning), self-loops skipped
        (ComoRAG.py:812 semantics).

        ``directed`` mirrors ``ig.Graph(directed=is_directed_graph)``
        (reference ComoRAG.py:173): each stats entry becomes ONE arc
        instead of a symmetric pair, so passage/synonymy edges point one
        way while fact edges stay bidirectional (double-entry stats)."""
        name_to_idx = {n: i for i, n in enumerate(node_names)}
        # NOT vectorized on purpose: an np.fromiter rewrite measured
        # exactly equal (9.1 s vs 9.1 s at 3M entries) — the dict
        # iteration and string-key lookups are the cost either way.
        src, dst, weights = [], [], []
        dropped = 0
        for (u, v), w in self.stats.items():
            if u == v:
                continue
            ui = name_to_idx.get(u)
            vi = name_to_idx.get(v)
            if ui is None or vi is None:
                dropped += 1
                continue
            if directed:
                src.append(ui)
                dst.append(vi)
                weights.append(w)
            else:
                # one stats entry == one undirected edge == two arcs
                src.extend((ui, vi))
                dst.extend((vi, ui))
                weights.extend((w, w))
        if dropped:
            logger.warning("Dropped %d edges with unknown endpoints", dropped)
        return GraphData(
            list(node_names),
            np.asarray(src, np.int32),
            np.asarray(dst, np.int32),
            np.asarray(weights, np.float32),
            dict(self.ent_node_to_num_chunk),
        )
