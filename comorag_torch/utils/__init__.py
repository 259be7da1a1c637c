"""Copy of ``comorag_tpu/utils/__init__.py`` for the port, which imports nothing of the JAX package."""

from comorag_torch.utils.hashing import content_hash
from comorag_torch.utils.jsonio import load_jsonl, save_jsonl
from comorag_torch.utils.text import text_processing, normalize_answer

__all__ = ["content_hash", "load_jsonl", "save_jsonl", "text_processing", "normalize_answer"]
