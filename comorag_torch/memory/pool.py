"""Per-question working memory.

Port of ``comorag_tpu/memory/pool.py`` (unchanged logic; the JAX module
imports jax through ``comorag_tpu.ops``).

Capability parity with the reference's MemoryPool/MemoryNode
(utils/memory_utils.py:17-303): a main pool of consolidated nodes plus a
temp pool for the current round; content-hash dedup listings; probe-
similarity retrieval; LLM fusion of similar nodes.

TPU-first difference: probe/cue embeddings for the whole pool are encoded
in ONE batch and similarity ranking is one matmul (the reference loops
per-node cosine, memory_utils.py:211-224).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from comorag_torch.ops.similarity import cosine_similarity_np
from comorag_torch.utils.hashing import content_hash
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)


NO_MEMORY_SENTINEL = "No relevant memory nodes found for the given probe."


class NodeType:
    VER = "veridical"
    SEM = "semantical"
    EPI = "episodic"
    FUSION = "fusion"


@dataclass
class MemoryNode:
    probe: Optional[str] = None
    node_type: Optional[str] = None
    original_content: Optional[List[str]] = None
    content_hash: Optional[List[str]] = None
    cue: Optional[str] = None
    embedding: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        if self.original_content and not self.content_hash:
            self.update_hashes()

    def update_hashes(self) -> None:
        if self.original_content:
            self.content_hash = [
                content_hash(c, prefix=f"{self.node_type}-") for c in self.original_content
            ]

    def get_content_hashes(self) -> List[str]:
        if not self.content_hash and self.original_content:
            self.update_hashes()
        return self.content_hash or []

    def embed_text(self) -> str:
        """Text used for the node's similarity embedding (probe + cue)."""
        parts = [p for p in (self.probe, self.cue) if p]
        return " ".join(parts)


class MemoryPool:
    def __init__(self, encoder=None, agent=None):
        self.pool: List[MemoryNode] = []
        self.temp_pool: List[MemoryNode] = []
        self.encoder = encoder
        self.agent = agent

    # ------------------------------------------------------------- mutation
    def add_node(self, node: MemoryNode) -> None:
        self.pool.append(node)

    def add_to_temp_pool(self, node: MemoryNode) -> None:
        self.temp_pool.append(node)

    def clear_temp_pool(self) -> None:
        self.temp_pool = []

    def merge_temp_to_main(self) -> None:
        self.pool.extend(self.temp_pool)
        self.clear_temp_pool()

    # -------------------------------------------------------------- queries
    def get_nodes_by_type(self, node_type: str) -> List[MemoryNode]:
        return [n for n in self.pool if n.node_type == node_type]

    def get_temp_nodes_by_type(self, node_type: str) -> List[MemoryNode]:
        return [n for n in self.temp_pool if n.node_type == node_type]

    def get_all_hashes(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for node in self.pool:
            out.setdefault(node.node_type, []).extend(node.get_content_hashes())
        return out

    def get_all_probes(self) -> List[str]:
        seen = set()
        probes = []
        for node in self.pool:
            if node.probe and node.probe not in seen:
                seen.add(node.probe)
                probes.append(node.probe)
        return probes

    # ------------------------------------------------------------ similarity
    def _ensure_embeddings(self) -> None:
        if self.encoder is None:
            raise ValueError("MemoryPool has no encoder")
        pending = [n for n in self.pool if n.embedding is None]
        if pending:
            texts = [n.embed_text() or "<empty>" for n in pending]
            embs = self.encoder.encode(texts)  # one batch for the whole pool
            for node, emb in zip(pending, embs):
                node.embedding = np.asarray(emb, np.float32)

    def retrieve_similar_nodes(self, probe: str, top_percent: float = 0.5) -> List[MemoryNode]:
        if not self.pool:
            return []
        self._ensure_embeddings()
        probe_emb = np.asarray(self.encoder.encode([probe])[0], np.float32)
        node_matrix = np.stack([n.embedding for n in self.pool])
        sims = cosine_similarity_np(probe_emb[None, :], node_matrix)[0]
        order = np.argsort(-sims)
        k = max(1, int(len(self.pool) * top_percent))
        return [self.pool[i] for i in order[:k]]

    # ---------------------------------------------------------------- fusion
    def create_fusion_content(
        self, probe: str, top_k_percent: float = 0.5,
        max_tokens: Optional[int] = None, token_counter=None,
    ) -> str:
        """``max_tokens`` bounds the concatenated cues (highest-similarity
        first — the blocks are already ranked): half the pool's cues grow
        without bound across impasse rounds and would cross the serving
        engine's window by round 3-4, silently left-truncating the fusion
        instruction header off the prompt."""
        if self.agent is None:
            raise ValueError("MemoryPool has no fusion agent")
        similar = self.retrieve_similar_nodes(probe, top_k_percent)
        blocks = [
            f"Node {i}:\nNote: {node.cue}"
            for i, node in enumerate((n for n in similar if n.cue), 1)
        ]
        if max_tokens is not None and token_counter is not None and blocks:
            kept = token_counter.truncate_by_budget(blocks, max_tokens)
            blocks = kept or blocks[:1]  # never drop to zero evidence
        if not blocks:
            return NO_MEMORY_SENTINEL
        content = "\n\n".join(blocks)
        return self.agent.fuse_memory_nodes(query=probe, content=content, max_completion_tokens=1000)

    def add_fused_node(self, probe: str, fused_content: str) -> MemoryNode:
        node = MemoryNode(probe=probe, node_type=NodeType.FUSION, cue=fused_content)
        if self.encoder is not None:
            node.embedding = np.asarray(self.encoder.encode([fused_content])[0], np.float32)
        self.add_to_temp_pool(node)
        return node
