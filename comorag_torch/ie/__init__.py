"""Copy of ``comorag_tpu/ie/__init__.py`` for the port, which imports nothing of the JAX package."""

from comorag_torch.ie.openie import NerResult, OpenIE, TripleResult

__all__ = ["OpenIE", "NerResult", "TripleResult"]
