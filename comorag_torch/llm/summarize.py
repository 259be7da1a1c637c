"""Summarization over the chat LLM.

Capability parity with the reference's GPT4SummarizationModel
(utils/summarization_utils.py): detail-preserving summaries at temperature
0, with batch fan-out through ``BaseLLM.batch_infer``.

Copy of ``comorag_tpu/llm/summarize.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

from comorag_torch.llm.base import BaseLLM
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)

_SYSTEM = {"role": "system", "content": "You are a helpful assistant."}


def _summary_messages(context: str) -> List[dict]:
    return [
        _SYSTEM,
        {
            "role": "user",
            "content": "Write a summary of the following, including as many key details as possible: "
            + context,
        },
    ]


class Summarizer:
    def __init__(self, llm: BaseLLM, max_completion_tokens: int = 500):
        self.llm = llm
        self.max_completion_tokens = max_completion_tokens

    def summarize(self, context: str, max_tokens: int | None = None) -> str:
        resp = self.llm.infer(
            _summary_messages(context),
            max_completion_tokens=max_tokens or self.max_completion_tokens,
        )
        return resp.text

    def batch_summarize(self, contexts: Sequence[str], max_tokens: int | None = None) -> List[str]:
        batch = [_summary_messages(c) for c in contexts]
        responses = self.llm.batch_infer(batch, max_completion_tokens=max_tokens or self.max_completion_tokens)
        return [r.text for r in responses]
