"""Copy of ``comorag_tpu/timeline/__init__.py`` for the port, which imports nothing of the JAX package."""

from comorag_torch.timeline.summarizer import TimelineSummarizer, adaptive_window_size

__all__ = ["TimelineSummarizer", "adaptive_window_size"]
