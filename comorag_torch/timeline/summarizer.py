"""Episodic timeline layer: order-preserving sliding-window summaries.

Capability parity with the reference's TimelineSummarizer
(utils/timeline_utils.py:14-515): adaptive window size by corpus scale
(:42-58), one summary level persisted under the ``level_0`` namespace
(:337-343), load-or-regenerate validation (:392-491), and the summary
statistics artifact (:73-188). Windows are summarized in one batched LLM
call (replacing the 8-thread pool, :312).

Validation uses an explicit ``timeline_meta.json`` recording the corpus
the timeline was built over — inferring coverage from the store length is
wrong when the LLM fails a window ('' filtered) or two windows summarize
identically (content-hash dedup): the count mismatch would force a full
re-summarization on EVERY load.

Copy of ``comorag_tpu/timeline/summarizer.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional

from comorag_torch.llm.summarize import Summarizer
from comorag_torch.store.embedding_store import EmbeddingStore
from comorag_torch.utils.logging import get_logger
from comorag_torch.utils.text import TokenCounter

logger = get_logger(__name__)


def adaptive_window_size(total_chunks: int) -> int:
    """Window size heuristic (timeline_utils.py:42-58 semantics)."""
    if total_chunks <= 5:
        return 2
    if total_chunks <= 20:
        return 3
    if total_chunks <= 50:
        return 5
    if total_chunks <= 100:
        return 8
    if total_chunks <= 200:
        return 10
    return min(20, max(10, int(math.log2(total_chunks) * 2)))


_WINDOW_PROMPT = (
    "Summarize the following narrative excerpts as one coherent timeline "
    "segment. Keep chronological order, highlight key events and turning "
    "points, and preserve important names and details:\n\n{text}"
)


class TimelineSummarizer:
    def __init__(
        self,
        chunk_store: EmbeddingStore,
        summarizer: Summarizer,
        encoder,
        directory: str,
        batch_size: int = 32,
        window_size: Optional[int] = None,
    ):
        self.chunk_store = chunk_store
        self.summarizer = summarizer
        self.encoder = encoder
        self.directory = directory
        self.batch_size = batch_size
        total = len(chunk_store)
        self.window_size = window_size or adaptive_window_size(total)
        logger.info("Timeline: %d chunks, window size %d", total, self.window_size)

    # ----------------------------------------------------------- level store
    def level_store(self, level: int = 0) -> EmbeddingStore:
        return EmbeddingStore(
            self.encoder, self.directory, self.batch_size, namespace=f"level_{level}"
        )

    # ------------------------------------------------------------ generation
    def generate(self) -> List[str]:
        texts = self.chunk_store.get_all_texts()
        windows: List[List[str]] = [
            texts[i : i + self.window_size] for i in range(0, len(texts), self.window_size)
        ]
        # Single-text windows pass through unsummarized (timeline_utils.py:255-258).
        to_summarize = [(i, w) for i, w in enumerate(windows) if len(w) > 1]
        summaries: List[str] = ["" for _ in windows]
        for i, w in enumerate(windows):
            if len(w) == 1:
                summaries[i] = w[0]
        if to_summarize:
            contexts = [_WINDOW_PROMPT.format(text="\n\n".join(w)) for _, w in to_summarize]
            results = self.summarizer.batch_summarize(contexts)
            for (i, _), s in zip(to_summarize, results):
                summaries[i] = s
        failed = sum(1 for s in summaries if not s)
        if failed:
            logger.warning(
                "Timeline: %d/%d window summaries failed — recorded in the "
                "meta; the next build retries them", failed, len(windows),
            )
        summaries = [s for s in summaries if s]
        store = self.level_store(0)
        store.clear()  # regeneration replaces any stale windows wholesale
        store.insert_strings(summaries)
        self._write_meta(failed_windows=failed)
        return summaries

    def expected_summaries(self, total_chunks: int) -> int:
        return (total_chunks + self.window_size - 1) // self.window_size

    # ------------------------------------------------------------------ meta
    @property
    def _meta_path(self) -> str:
        return os.path.join(self.directory, "timeline_meta.json")

    def _write_meta(self, failed_windows: int = 0) -> None:
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(
                {"n_chunks": len(self.chunk_store), "window_size": self.window_size,
                 "failed_windows": failed_windows}, f
            )
        os.replace(tmp, self._meta_path)  # atomic: no torn meta on crash

    def validate(self) -> bool:
        """A reusable timeline must have been built over the CURRENT
        corpus (a grown corpus otherwise silently reuses a stale timeline
        — timeline_utils.py:392-491 validate-or-regenerate semantics).
        Coverage is recorded in timeline_meta.json at generation time;
        comparing the deduped store length against the window count would
        permanently invalidate any timeline with a failed or duplicate
        window summary."""
        store = self.level_store(0)
        if len(store) == 0:
            return False
        meta: Dict[str, Any] = {}
        try:
            with open(self._meta_path, encoding="utf-8") as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            meta = {}
        if meta:
            ok = (
                meta.get("n_chunks") == len(self.chunk_store)
                and meta.get("window_size") == self.window_size
                # a build with errored windows must NOT validate forever —
                # regenerate so the failed summaries retry (the LLM cache
                # makes the successful ones cheap to redo)
                and not meta.get("failed_windows", 0)
            )
            if not ok:
                logger.info(
                    "Timeline stale (built over %s chunks @ window %s, now %d @ %d) — regenerating",
                    meta.get("n_chunks"), meta.get("window_size"),
                    len(self.chunk_store), self.window_size,
                )
            return ok
        # Legacy stores without meta: the count check can only
        # false-negative (re-summarize), never reuse a stale timeline.
        expected = self.expected_summaries(len(self.chunk_store))
        if len(store) != expected:
            logger.info(
                "Timeline stale: %d summaries on disk, %d expected — regenerating",
                len(store),
                expected,
            )
            return False
        self._write_meta()  # upgrade the artifact in place
        return True

    def load_or_generate(self) -> EmbeddingStore:
        os.makedirs(self.directory, exist_ok=True)
        if self.validate():
            logger.info("Loaded existing timeline summaries")
        else:
            logger.info("Generating timeline summaries")
            self.generate()
        return self.level_store(0)

    # ------------------------------------------------------------ statistics
    def statistics(self, tokens: Optional[TokenCounter] = None) -> Dict[str, Any]:
        """Per-level summary statistics (reference get_summary_statistics,
        timeline_utils.py:72-119 fields; one level in practice)."""
        tokens = tokens or TokenCounter()
        stats: Dict[str, Any] = {
            "total_levels": 0,
            "levels": [],
            "total_tokens": 0,
            "total_nodes": 0,
            "model_info": {
                "window_size": self.window_size,
                "total_chunks": len(self.chunk_store),
            },
        }
        level = 0
        while True:
            store = self.level_store(level)
            summaries = store.get_all_texts()
            if not summaries:
                break
            tok_counts = [tokens.count(s) for s in summaries]
            char_counts = [len(s) for s in summaries]
            stats["levels"].append(
                {
                    "level": level,
                    "node_count": len(summaries),
                    "total_tokens": sum(tok_counts),
                    "avg_tokens_per_node": sum(tok_counts) / len(summaries),
                    "min_tokens": min(tok_counts),
                    "max_tokens": max(tok_counts),
                    "total_chars": sum(char_counts),
                    "avg_chars_per_node": sum(char_counts) / len(summaries),
                }
            )
            stats["total_tokens"] += sum(tok_counts)
            stats["total_nodes"] += len(summaries)
            level += 1
        stats["total_levels"] = level
        stats["avg_tokens_per_level"] = stats["total_tokens"] / level if level else 0.0
        stats["avg_nodes_per_level"] = stats["total_nodes"] / level if level else 0.0
        return stats

    def save_statistics(self, output_dir: str, tokens: Optional[TokenCounter] = None) -> str:
        """Write the JSON + human-readable TXT statistics artifacts
        (reference save_summary_statistics, timeline_utils.py:121-188;
        deterministic filenames instead of timestamps so reruns are
        idempotent artifacts, not an unbounded pile)."""
        stats = self.statistics(tokens)
        os.makedirs(output_dir, exist_ok=True)
        json_path = os.path.join(output_dir, "timeline_stats.json")
        with open(json_path, "w", encoding="utf-8") as f:
            json.dump(stats, f, ensure_ascii=False, indent=2)
        lines = [
            "=== Summary Statistics ===",
            f"Total Levels: {stats['total_levels']}",
            f"Total Nodes: {stats['total_nodes']}",
            f"Total Tokens: {stats['total_tokens']}",
            f"Average Tokens per Level: {stats['avg_tokens_per_level']:.2f}",
            f"Average Nodes per Level: {stats['avg_nodes_per_level']:.2f}",
            "",
            "=== Model Configuration ===",
            f"Window Size: {stats['model_info']['window_size']}",
            f"Initial Text Chunks: {stats['model_info']['total_chunks']}",
            "",
            "=== Level Details ===",
        ]
        for lv in stats["levels"]:
            lines += [
                f"",
                f"Level {lv['level']}:",
                f"  Node Count: {lv['node_count']}",
                f"  Total Tokens: {lv['total_tokens']}",
                f"  Average Tokens per Node: {lv['avg_tokens_per_node']:.2f}",
                f"  Min Tokens: {lv['min_tokens']}",
                f"  Max Tokens: {lv['max_tokens']}",
                f"  Total Characters: {lv['total_chars']}",
                f"  Average Characters per Node: {lv['avg_chars_per_node']:.2f}",
            ]
        with open(os.path.join(output_dir, "timeline_stats.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        return json_path
