"""Copy of ``comorag_tpu/prompts/__init__.py`` for the port, which imports nothing of the JAX package."""

from comorag_torch.prompts.manager import PromptManager
from comorag_torch.prompts.linking import get_query_instruction

__all__ = ["PromptManager", "get_query_instruction"]
