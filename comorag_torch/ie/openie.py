"""Open information extraction: two-stage LLM pipeline (NER -> triples).

Capability parity with the reference's OpenIE
(information_extraction/openie_openai.py:66-272): per-chunk NER then
entity-conditioned triple extraction, batched; defensive multi-format
parsing of model output (JSON object / bare array / repaired JSON — without
``eval``); truncated responses repaired before parsing.

The batch runs through ``BaseLLM.batch_infer`` (bounded pool) instead of
unbounded thread pools.

Copy of ``comorag_tpu/ie/openie.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

from comorag_torch.llm.base import BaseLLM
from comorag_torch.prompts.manager import PromptManager
from comorag_torch.utils.json_repair import (
    extract_json_array,
    extract_json_object,
    filter_valid_triples,
    repair_json,
)
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class NerResult:
    chunk_id: str
    response: str
    unique_entities: List[str]
    metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TripleResult:
    chunk_id: str
    response: str
    triples: List[List[str]]
    metadata: Dict[str, Any] = field(default_factory=dict)


def _parse_entities(text: str) -> List[str]:
    obj = extract_json_object(text)
    if obj and isinstance(obj.get("named_entities"), list):
        return [str(e) for e in obj["named_entities"]]
    arr = extract_json_array(text)
    if arr is not None:
        return [str(e) for e in arr if isinstance(e, (str, int, float))]
    logger.warning("Could not parse NER response: %.100s", text)
    return []


def _parse_triples(text: str) -> List[List[str]]:
    obj = extract_json_object(text)
    if obj and isinstance(obj.get("triples"), list):
        return obj["triples"]
    arr = extract_json_array(text)
    if arr is not None:
        return [t for t in arr if isinstance(t, list)]
    logger.warning("Could not parse triples response: %.100s", text)
    return []


class OpenIE:
    def __init__(
        self,
        llm: BaseLLM,
        prompts: PromptManager | None = None,
        response_format: dict | None = None,
    ):
        self.llm = llm
        self.prompts = prompts or PromptManager()
        # Guided-JSON decoding applies ONLY to the extraction calls below
        # (per-call gen_kwargs), never client-wide — a schema here must not
        # force JSON output on narrative QA answers.
        self._gen_kwargs = {"response_format": response_format} if response_format else {}

    def _stage_kwargs(self, template: str) -> dict:
        """Per-stage gen kwargs: in-process engines that can constrain
        decoding (JaxOfflineLLM.supports_guided_json) get the stage's JSON
        schema — the counterpart of the reference's guided-JSON OpenIE
        (openie_vllm_offline.py:20-77)."""
        kw = dict(self._gen_kwargs)
        if getattr(self.llm, "supports_guided_json", False):
            kw["json_template"] = template
        return kw

    # -------------------------------------------------------------- stages
    def ner(self, chunk_id: str, passage: str) -> NerResult:
        messages = self.prompts.render("ner", passage=passage)
        try:
            resp = self.llm.infer(messages, **self._stage_kwargs("ner"))
        except Exception as e:  # noqa: BLE001
            logger.warning("NER failed for %s: %s", chunk_id, e)
            return NerResult(chunk_id, "", [], {"error": str(e)})
        text = resp.text
        if resp.metadata.get("finish_reason") == "length":
            text = repair_json(text)
        entities = list(dict.fromkeys(_parse_entities(text)))
        meta = dict(resp.metadata)
        meta["cache_hit"] = resp.cache_hit
        return NerResult(chunk_id, resp.text, entities, meta)

    def extract_triples(self, chunk_id: str, passage: str, entities: Sequence[str]) -> TripleResult:
        messages = self.prompts.render(
            "triple_extraction",
            passage=passage,
            named_entity_json=json.dumps({"named_entities": list(entities)}),
        )
        try:
            resp = self.llm.infer(messages, **self._stage_kwargs("triples"))
        except Exception as e:  # noqa: BLE001
            logger.warning("Triple extraction failed for %s: %s", chunk_id, e)
            return TripleResult(chunk_id, "", [], {"error": str(e)})
        text = resp.text
        if resp.metadata.get("finish_reason") == "length":
            text = repair_json(text)
        triples = filter_valid_triples(_parse_triples(text))
        meta = dict(resp.metadata)
        meta["cache_hit"] = resp.cache_hit
        return TripleResult(chunk_id, resp.text, triples, meta)

    # --------------------------------------------------------------- batch
    def batch_openie(
        self, chunks: Dict[str, str]
    ) -> Tuple[Dict[str, NerResult], Dict[str, TripleResult]]:
        """chunks: chunk_id -> passage text. Two batched stages."""
        ids = list(chunks.keys())

        ner_batch = [self.prompts.render("ner", passage=chunks[cid]) for cid in ids]
        ner_raw = self.llm.batch_infer(ner_batch, **self._stage_kwargs("ner"))
        ner_results: Dict[str, NerResult] = {}
        for cid, resp in zip(ids, ner_raw):
            text = repair_json(resp.text) if resp.metadata.get("finish_reason") == "length" else resp.text
            entities = list(dict.fromkeys(_parse_entities(text)))
            ner_results[cid] = NerResult(cid, resp.text, entities, dict(resp.metadata))

        triple_batch = [
            self.prompts.render(
                "triple_extraction",
                passage=chunks[cid],
                named_entity_json=json.dumps({"named_entities": ner_results[cid].unique_entities}),
            )
            for cid in ids
        ]
        triple_raw = self.llm.batch_infer(triple_batch, **self._stage_kwargs("triples"))
        triple_results: Dict[str, TripleResult] = {}
        for cid, resp in zip(ids, triple_raw):
            text = repair_json(resp.text) if resp.metadata.get("finish_reason") == "length" else resp.text
            triples = filter_valid_triples(_parse_triples(text))
            triple_results[cid] = TripleResult(cid, resp.text, triples, dict(resp.metadata))

        return ner_results, triple_results
