"""Seeded Gaussian random projection (numpy, on the host).

Copy of ``comorag_tpu/ops/projection.py``, which cannot be imported
without jax (``comorag_tpu/ops/__init__.py`` loads the jax modules). The
semantic tree replaces the reference's UMAP with this projection; it runs
on the host because the source embeddings are host numpy already.
"""

from __future__ import annotations

import numpy as np


def random_projection(x: np.ndarray, out_dim: int, seed: int = 224) -> np.ndarray:
    """Project [n, d] -> [n, out_dim]; identity when d <= out_dim.
    Deterministic in (d, out_dim, seed), identical to the JAX package's."""
    x = np.asarray(x, np.float32)
    if x.shape[1] <= out_dim:
        return x
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((x.shape[1], out_dim)) / np.sqrt(out_dim)).astype(np.float32)
    return x @ w
