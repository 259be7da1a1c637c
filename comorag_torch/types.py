"""Shared result types (reference: misc_utils.py:69-89).

Copy of ``comorag_tpu/types.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class QuerySolution:
    question: str
    docs: Any = None
    summary: Any = None
    timeline: Any = None
    doc_scores: Optional[np.ndarray] = None
    answer: Optional[str] = None
    gold_answers: Optional[List[str]] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "question": self.question,
            "answer": self.answer,
            "gold_answers": self.gold_answers,
            "docs": self.docs if isinstance(self.docs, str) else (self.docs or [])[:5],
            "doc_scores": (
                [round(float(v), 4) for v in self.doc_scores.tolist()[:5]]
                if self.doc_scores is not None
                else None
            ),
        }
