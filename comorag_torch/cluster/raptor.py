"""RAPTOR-style recursive semantic tree via device GMM clustering.

Port of ``comorag_tpu/cluster/raptor.py``: the same tree and clustering,
with the GMM BIC sweep in torch on the given device (``ops/gmm.py``).

Capability parity with the reference's ChunkSoftClustering + recursion
driver (cluster_utils.py:213-357, ComoRAG.py:1107-1195):

  - two-level soft clustering: global GMM over dimension-reduced
    embeddings, then a local GMM inside each global cluster; membership =
    posterior >= threshold (points may join several clusters);
  - model selection by BIC sweep (k = 1..50) — here ONE vmapped device
    program per level (ops/gmm.py) instead of 50 sklearn fits;
  - UMAP replaced by a seeded Gaussian random projection (ops/projection);
  - per-cluster LLM summaries, recursed up to ``max_levels`` (5) until a
    single root summary remains.

Summaries at each level are generated in one ``batch_summarize`` call
(replacing the reference's 32-thread pool, ComoRAG.py:1163).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from comorag_torch.device import resolve_device
from comorag_torch.ops.gmm import fit_gmm_bic
from comorag_torch.ops.projection import random_projection
from comorag_torch.llm.summarize import Summarizer
from comorag_torch.utils import trace
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class SoftCluster:
    id: int
    members: Dict[int, float] = field(default_factory=dict)  # point index -> membership

    def sorted_members(self) -> List[Tuple[int, float]]:
        return sorted(self.members.items(), key=lambda kv: kv[1], reverse=True)


def two_level_soft_cluster(
    embeddings: np.ndarray,
    threshold: float = 0.01,
    reduction_dim: int = 10,
    max_clusters: int = 50,
    seed: int = 224,
    em_iters: int = 60,
    device: Union[str, torch.device] = "cuda",
) -> List[SoftCluster]:
    """Two-level (global + local) soft clustering of [n, d] embeddings, on
    the card unless ``device="cpu"``; without a card the default raises."""
    device = resolve_device(device)
    n = embeddings.shape[0]
    if n == 0:
        return []
    if n == 1:
        return [SoftCluster(0, {0: 1.0})]

    reduced = random_projection(embeddings, reduction_dim, seed=seed)
    _, global_resp = fit_gmm_bic(reduced, max_clusters=max_clusters, iters=em_iters, seed=seed,
                                  device=device)
    n_global = global_resp.shape[1]
    logger.info("Global cluster count: %d", n_global)

    clusters: List[SoftCluster] = []
    next_id = 0
    for g in range(n_global):
        member_idx = np.where(global_resp[:, g] >= threshold)[0]
        if len(member_idx) == 0:
            continue
        if len(member_idx) <= reduction_dim + 1:
            cluster = SoftCluster(next_id, {int(i): 1.0 for i in member_idx})
            clusters.append(cluster)
            next_id += 1
            continue
        local_embs = embeddings[member_idx]
        local_reduced = random_projection(local_embs, reduction_dim, seed=seed)
        _, local_resp = fit_gmm_bic(local_reduced, max_clusters=max_clusters, iters=em_iters,
                                     seed=seed, device=device)
        for lc in range(local_resp.shape[1]):
            members = {
                int(member_idx[i]): float(local_resp[i, lc])
                for i in range(len(member_idx))
                if local_resp[i, lc] >= threshold
            }
            if members:
                clusters.append(SoftCluster(next_id, members))
            next_id += 1
    logger.info("Total cluster count: %d", len(clusters))
    return clusters


class SemanticTree:
    def __init__(
        self,
        encoder,
        summarizer: Summarizer,
        threshold: float = 0.01,
        reduction_dim: int = 10,
        max_clusters: int = 50,
        seed: int = 224,
        em_iters: int = 60,
        batch_size: int = 32,
        max_context_tokens: int = 3500,
        token_counter=None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.encoder = encoder
        self.summarizer = summarizer
        self.threshold = threshold
        self.reduction_dim = reduction_dim
        self.max_clusters = max_clusters
        self.seed = seed
        self.em_iters = em_iters
        self.batch_size = batch_size
        self.max_context_tokens = max_context_tokens
        self.device = resolve_device(device)
        from comorag_torch.utils.text import TokenCounter

        self.tokens = token_counter or TokenCounter()
        # count of cluster summaries whose LLM call errored across build();
        # callers key their staleness meta on it (>0 -> rebuild next run)
        self.failed_summaries = 0

    def _encode(self, texts: Sequence[str]) -> np.ndarray:
        out = []
        for i in range(0, len(texts), self.batch_size):
            out.append(np.asarray(self.encoder.encode(list(texts[i : i + self.batch_size])), np.float32))
        return np.concatenate(out, axis=0)

    def _summarize_clusters(self, texts: Sequence[str], clusters: List[SoftCluster]) -> List[str]:
        contexts = []
        for cluster in clusters:
            ordered = [texts[i] for i, _ in cluster.sorted_members()]
            # budget the PROMPT: highest-membership texts first, stop at
            # max_context_tokens (the reference concatenates the whole
            # cluster unbounded, cluster_utils.py:563-568 — ~500k tokens
            # at 200k-chunk scale; see config.summary_context_max_tokens)
            kept = self.tokens.truncate_by_budget(ordered, self.max_context_tokens)
            if not kept and ordered:
                kept = ordered[:1]  # a single over-budget text still summarizes
            combined = "".join(f"{' '.join(t.splitlines())}\n\n" for t in kept)
            contexts.append(combined)
        summaries = self.summarizer.batch_summarize(contexts)
        dropped = sum(1 for s in summaries if not s)
        if dropped:
            # surfaced so the caller's staleness meta can force a rebuild:
            # silently thinning the tree and then validating it forever
            # turns a transient LLM outage into a permanent capability loss
            self.failed_summaries += dropped
            logger.warning(
                "Semantic tree: %d/%d cluster summaries failed at this level",
                dropped, len(contexts),
            )
        return [s for s in summaries if s]

    def build(
        self,
        texts: Sequence[str],
        max_levels: int = 5,
        embeddings: "np.ndarray | None" = None,
    ) -> Tuple[List[str], List[str]]:
        """Returns (all_summaries_across_levels, [root_summary]).

        Level semantics match ComoRAG._recursive_clustering: cluster ->
        summarize -> recurse on summaries until one remains or the level cap
        hits (then the first text stands in as root). ``embeddings`` (the
        level-0 matrix, e.g. straight from the veridical store) skips
        re-encoding the whole corpus.
        """
        texts = list(texts)
        if len(texts) <= 1:
            return texts, texts

        all_summaries: List[str] = []
        level_texts = texts
        level_embeddings = embeddings if embeddings is not None and len(embeddings) == len(texts) else None
        for level in range(max_levels):
            with trace.span("semantic_tree.encode"):
                embeddings = level_embeddings if level_embeddings is not None else self._encode(level_texts)
            level_embeddings = None  # only level 0 is precomputed
            with trace.span("semantic_tree.cluster"):
                clusters = two_level_soft_cluster(
                    embeddings,
                    threshold=self.threshold,
                    reduction_dim=self.reduction_dim,
                    max_clusters=self.max_clusters,
                    seed=self.seed,
                    em_iters=self.em_iters,
                    device=self.device,
                )
            with trace.span("semantic_tree.summarize"):
                summaries = self._summarize_clusters(level_texts, clusters)
            logger.info("Semantic tree level %d: %d -> %d", level, len(level_texts), len(summaries))
            if not summaries:
                break
            all_summaries.extend(summaries)
            if len(summaries) == 1:
                return all_summaries, [summaries[0]]
            level_texts = summaries
        # level cap reached
        root = [level_texts[0]] if level_texts else []
        return all_summaries, root
