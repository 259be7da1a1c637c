"""Exact MIPS (maximum inner-product search) top-k on one device.

Port of the single-device parts of ``comorag_tpu/ops/topk.py``. Tensors
have their true sizes here (PyTorch needs no static shapes), so nothing is
padded and no row mask exists. Every selection is exact and breaks ties
toward the LOWEST id, the order ``lax.top_k`` gives; ``torch.topk`` makes
no promise about tie order, so ``exact_topk`` fixes it explicitly.

The certified two-pass scan (topk.py:361-505) is not ported yet; the
index serves exact single-pass scores instead, which yield the same ids.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def dense_scores(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Full [P, N] fp32 inner-product matrix (topk.py:508, ``_score_dot``
    :38). A bf16 corpus is scored as JAX scores it: bf16 queries, exact
    products, fp32 sums."""
    if corpus.dtype == torch.bfloat16:
        return torch.matmul(queries.to(torch.bfloat16).float(), corpus.float().T)
    return torch.matmul(queries.float(), corpus.T)


def int8_scores(queries: torch.Tensor, corpus_q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[P, N] scores over a per-row int8 corpus (topk.py:136 ``_int8_scan_dot``):
    bf16 queries, int8 rows exact in bf16, fp32 sums, per-row scale."""
    s = torch.matmul(queries.to(torch.bfloat16).float(), corpus_q.float().T)
    return s * scales[None, :]


def quantize_int8(corpus: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization (topk.py:160): (q [N, d] int8,
    scales [N] f32) with row ~= q * scale."""
    c = np.asarray(corpus, np.float32)
    scales = np.abs(c).max(axis=1) / 127.0 if c.size else np.zeros(c.shape[0], np.float32)
    scales = np.where(scales == 0, 1.0, scales)
    q = np.clip(np.rint(c / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales.astype(np.float32)


def exact_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k per row, sorted descending, ties toward the lowest column id
    (``lax.top_k``'s order, topk.py:56 ``_exact_topk``): a stable
    descending sort keeps equal scores in column order. It never waits on
    the device, so the index's handles stay asynchronous."""
    k = max(0, min(int(k), scores.shape[1]))
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def dense_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner products of each query against the corpus (topk.py:112):
    (scores [P, k], indices [P, k]) sorted descending."""
    return exact_topk(dense_scores(queries, corpus), k)


def topk_min_from_scores(scores: torch.Tensor, k: int):
    """Top-k plus the row minimum (topk.py:290 ``make_packed_topk_min``):
    the fact-linking fetch needs only the candidates and the min-max span."""
    vals, idx = exact_topk(scores, k)
    return vals, idx, scores.amin(dim=1)


def stats_from_scores(scores: torch.Tensor, k: int):
    """Top-k, row min and row sum of a dense score matrix (topk.py:322
    ``make_packed_stats_from_scores``): what the probe fan-out reads on the
    host while the dense matrix stays on the device for the PPR prior."""
    vals, idx = exact_topk(scores, k)
    return vals, idx, scores.amin(dim=1), scores.sum(dim=1, dtype=torch.float32)
