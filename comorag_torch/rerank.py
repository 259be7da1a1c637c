"""LLM fact filter (recognition-based reranking).

Capability parity with the reference's DSPyFilter (rerank.py:15-122): a
few-shot prompt in the DSPy chat-adapter format (``[[ ## field ## ]]``
sections) asks the LLM to keep only the candidate facts relevant to the
query; generated facts are matched back to the candidates with difflib.
Unlike the reference, parsing never uses ``eval`` on model output.

A custom prompt can be supplied as a JSON file (``rerank_dspy_file_path``)
with the same ``{"prog": {"system": ..., "demos": [...]}}`` shape the
reference consumes, so existing tuned prompts carry over.

Copy of ``comorag_tpu/rerank.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import difflib
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

from comorag_torch.llm.base import BaseLLM
from comorag_torch.utils.json_repair import extract_json_object, filter_valid_triples
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)

_INPUT_TEMPLATE = (
    "[[ ## question ## ]]\n{question}\n\n"
    "[[ ## fact_before_filter ## ]]\n{fact_before_filter}\n\n"
    "Respond with the corresponding output fields, starting with the field "
    "`[[ ## fact_after_filter ## ]]` (must be formatted as a valid Python Fact), "
    "and then ending with the marker for `[[ ## completed ## ]]`."
)
_OUTPUT_TEMPLATE = "[[ ## fact_after_filter ## ]]\n{fact_after_filter}\n\n[[ ## completed ## ]]"

_DEFAULT_SYSTEM = (
    "Your input fields are:\n"
    "1. `question` (str): Query for retrieval\n"
    "2. `fact_before_filter` (str): Candidate facts to be filtered\n\n"
    "Your output fields are:\n"
    "1. `fact_after_filter` (Fact): Filtered facts in JSON format\n\n"
    "All interactions are structured:\n\n"
    "[[ ## question ## ]]\n{question}\n\n"
    "[[ ## fact_before_filter ## ]]\n{fact_before_filter}\n\n"
    "[[ ## fact_after_filter ## ]]\n{fact_after_filter}\n\n"
    "[[ ## completed ## ]]\n\n"
    "Objective: select up to 4 facts from the candidate list that bear directly on "
    "answering the question (multi-hop chains count). Output JSON like "
    '{"fact": [["s1","p1","o1"], ["s2","p2","o2"]]}; output {"fact": []} when '
    "nothing is relevant. Use only facts from the candidate list — never invent new ones."
)

_DEFAULT_DEMOS = [
    {
        "question": "Which year did the founder of Harbor Light Museum retire?",
        "fact_before_filter": json.dumps(
            {
                "fact": [
                    ["harbor light museum", "opened in", "1902"],
                    ["edith marsh", "founded", "harbor light museum"],
                    ["edith marsh", "retired in", "1931"],
                    ["atlantic city", "has", "boardwalk"],
                    ["lighthouse", "decommissioned in", "1898"],
                ]
            }
        ),
        "fact_after_filter": json.dumps(
            {
                "fact": [
                    ["edith marsh", "founded", "harbor light museum"],
                    ["edith marsh", "retired in", "1931"],
                ]
            }
        ),
    },
    {
        "question": "What instrument does the composer of the Night Suite play?",
        "fact_before_filter": json.dumps(
            {
                "fact": [
                    ["night suite", "composed by", "ana ruiz"],
                    ["ana ruiz", "plays", "cello"],
                    ["day suite", "composed by", "omar hale"],
                    ["omar hale", "plays", "oboe"],
                    ["night suite", "premiered in", "vienna"],
                ]
            }
        ),
        "fact_after_filter": json.dumps(
            {
                "fact": [
                    ["night suite", "composed by", "ana ruiz"],
                    ["ana ruiz", "plays", "cello"],
                ]
            }
        ),
    },
]


class FactFilter:
    def __init__(self, llm: BaseLLM, model_name: str = "", prompt_file: Optional[str] = None):
        self.llm = llm
        if prompt_file:
            saved = json.load(open(prompt_file))
            system = saved["prog"]["system"]
            demos = saved["prog"]["demos"]
        else:
            system, demos = _DEFAULT_SYSTEM, _DEFAULT_DEMOS
        self.message_template: List[Dict[str, str]] = [{"role": "system", "content": system}]
        for demo in demos:
            self.message_template.append(
                {
                    "role": "user",
                    "content": _INPUT_TEMPLATE.format(
                        question=demo["question"], fact_before_filter=demo["fact_before_filter"]
                    ),
                }
            )
            self.message_template.append(
                {
                    "role": "assistant",
                    "content": _OUTPUT_TEMPLATE.format(fact_after_filter=demo["fact_after_filter"]),
                }
            )

    # -------------------------------------------------------------- parsing
    @staticmethod
    def parse_response(response: str) -> List[List[str]]:
        """Pull the fact list out of the [[ ## fact_after_filter ## ]] section."""
        section = response
        m = re.search(r"\[\[ ## fact_after_filter ## \]\]\s*\n(.*?)(?:\[\[ ## |\Z)", response, re.DOTALL)
        if m:
            section = m.group(1)
        obj = extract_json_object(section)
        if not obj or "fact" not in obj or not isinstance(obj["fact"], list):
            return []
        return filter_valid_triples(obj["fact"])

    # ------------------------------------------------------------------ API
    def rerank(
        self,
        query: str,
        candidate_items: Sequence[Tuple[str, str, str]],
        candidate_indices: Sequence[int],
        len_after_rerank: Optional[int] = None,
    ) -> Tuple[List[int], List[Tuple[str, str, str]], dict]:
        return self.rerank_batch([query], [candidate_items], [candidate_indices], len_after_rerank)[0]

    def rerank_batch(
        self,
        queries: Sequence[str],
        candidate_items_rows: Sequence[Sequence[Tuple[str, str, str]]],
        candidate_indices_rows: Sequence[Sequence[int]],
        len_after_rerank: Optional[int] = None,
    ) -> List[Tuple[List[int], List[Tuple[str, str, str]], dict]]:
        """All rows' filter prompts go to the LLM as ONE batch_infer: the
        window-batching server and the offline engine both coalesce them
        into shared device programs, where per-row ``infer`` calls from a
        single scheduler thread would decode sequentially at batch 1."""
        prompts = []
        for query, candidate_items in zip(queries, candidate_items_rows):
            fact_before_filter = json.dumps({"fact": [list(c) for c in candidate_items]})
            messages = list(self.message_template)
            messages.append(
                {"role": "user", "content": _INPUT_TEMPLATE.format(question=query, fact_before_filter=fact_before_filter)}
            )
            prompts.append(messages)
        try:
            responses = self.llm.batch_infer(prompts, max_completion_tokens=512)
        except Exception as e:  # noqa: BLE001
            logger.error("fact rerank batch failed: %s", e)
            responses = [None] * len(prompts)

        out = []
        for response, candidate_items, candidate_indices in zip(
            responses, candidate_items_rows, candidate_indices_rows
        ):
            generated = self.parse_response(response.text) if response is not None else []
            candidate_strs = [str(list(c)) for c in candidate_items]
            result_indices: List[int] = []
            for fact in generated:
                matches = difflib.get_close_matches(str(fact), candidate_strs, n=1, cutoff=0.0)
                if matches:
                    pos = candidate_strs.index(matches[0])
                    if pos not in result_indices:
                        result_indices.append(pos)

            sorted_indices = [candidate_indices[i] for i in result_indices]
            sorted_items = [tuple(candidate_items[i]) for i in result_indices]
            out.append((
                sorted_indices[:len_after_rerank],
                sorted_items[:len_after_rerank],
                {"confidence": None},
            ))
        return out

    __call__ = rerank
