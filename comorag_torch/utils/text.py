"""Text normalization used in graph building and QA evaluation.

Semantics match the reference:
  - ``text_processing``: misc_utils.py:91-96 (lowercase, non-alnum -> space).
  - ``normalize_answer``: script/eval_qa.py:15-33 (SQuAD-style).

Copy of ``comorag_tpu/utils/text.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import re
import string
from typing import List, Union


def text_processing(text: Union[str, list]) -> Union[str, List]:
    if isinstance(text, list):
        return [text_processing(t) for t in text]
    if not isinstance(text, str):
        text = str(text)
    return re.sub(r"[^A-Za-z0-9 ]", " ", text.lower()).strip()


def normalize_answer(s: str) -> str:
    """SQuAD answer normalization: lowercase, strip punctuation/articles/extra ws."""
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


_WORD_RE = re.compile(r"\S+")


def approx_token_count(text: str) -> int:
    """Cheap token estimate (~words * 4/3) for context budgeting when no
    tokenizer is configured. Real tokenizers plug in via ``TokenCounter``."""
    return max(1, int(len(_WORD_RE.findall(text)) * 4 / 3))


class TokenCounter:
    """Pluggable token counter. Uses a HF tokenizer when one is supplied,
    otherwise the cheap word-based estimate (matches the budgeting role of
    the reference's tokenizer in ComoRAG.py:558-584)."""

    def __init__(self, tokenizer=None):
        self._tok = tokenizer

    def count(self, text: str) -> int:
        if self._tok is not None:
            return len(self._tok.encode(text))
        return approx_token_count(text)

    def truncate_by_budget(self, texts: List[str], budget: int) -> List[str]:
        """Greedy prefix selection under a token budget (ComoRAG.py:558-584
        semantics: stop at the first item that would overflow)."""
        out: List[str] = []
        used = 0
        for t in texts:
            n = self.count(t)
            if used + n > budget:
                break
            out.append(t)
            used += n
        return out
