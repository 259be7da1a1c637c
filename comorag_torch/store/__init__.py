"""Copy of ``comorag_tpu/store/__init__.py`` for the port, which imports nothing of the JAX package."""

from comorag_torch.store.embedding_store import EmbeddingStore

__all__ = ["EmbeddingStore"]
