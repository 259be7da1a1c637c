"""Score normalization and dense similarity helpers.

Port of ``comorag_tpu/ops/similarity.py``. ``min_max_normalize`` matches
the reference semantics (scale to [0, 1]; an all-equal vector maps to
ones). The ``_np`` helpers are numpy copies: the JAX module cannot be
imported without jax.
"""

from __future__ import annotations

import numpy as np
import torch


def min_max_normalize(scores: torch.Tensor, valid_mask=None) -> torch.Tensor:
    """Min-max normalize along the last axis (similarity.py:13).

    ``valid_mask`` (same shape, bool) restricts the min/max to valid
    entries. A degenerate row (all equal, or all invalid) maps to ones."""
    if valid_mask is None:
        lo = scores.amin(dim=-1, keepdim=True)
        hi = scores.amax(dim=-1, keepdim=True)
    else:
        big = torch.finfo(scores.dtype).max
        lo = torch.where(valid_mask, scores, big).amin(dim=-1, keepdim=True)
        hi = torch.where(valid_mask, scores, -big).amax(dim=-1, keepdim=True)
    span = hi - lo
    degenerate = span <= 0
    normalized = (scores - lo) / torch.where(degenerate, torch.ones_like(span), span)
    return torch.where(degenerate, torch.ones_like(scores), normalized)


def min_max_normalize_np(scores: np.ndarray) -> np.ndarray:
    """Host-side variant for small vectors (same semantics)."""
    scores = np.asarray(scores)
    if scores.size == 0:
        return scores
    lo, hi = scores.min(), scores.max()
    if hi == lo:
        return np.ones_like(scores)
    return (scores - lo) / (hi - lo)


def min_max_normalize_rows_np(scores: np.ndarray) -> np.ndarray:
    """Row-wise min-max over a [P, N] host matrix, vectorized."""
    scores = np.asarray(scores, np.float64)
    if scores.size == 0:
        return scores
    lo = scores.min(axis=-1, keepdims=True)
    hi = scores.max(axis=-1, keepdims=True)
    span = hi - lo
    out = (scores - lo) / np.where(span == 0, 1.0, span)
    out[np.broadcast_to(span == 0, out.shape)] = 1.0
    return out


def cosine_similarity_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host cosine for tiny matrices (memory-pool bookkeeping)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    a_n = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    b_n = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return a_n @ b_n.T
