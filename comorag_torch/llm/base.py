"""LLM interface (reference counterpart: llm/base.py:113-194).

Messages are OpenAI-style ``[{"role": ..., "content": ...}]`` lists.
``batch_infer`` is the throughput path: the meta loop and the OpenIE
indexer issue whole batches at once and the client fans them out over a
bounded worker pool (replacing the reference's unbounded ThreadPools,
openie_openai.py:219,245).

Copy of ``comorag_tpu/llm/base.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence

Messages = List[Dict[str, str]]


@dataclass
class LLMResponse:
    text: str
    metadata: Dict[str, Any] = field(default_factory=dict)
    cache_hit: bool = False


class BaseLLM(ABC):
    max_workers: int = 16

    @abstractmethod
    def infer(self, messages: Messages, **gen_kwargs) -> LLMResponse:
        ...

    def batch_infer(self, batch: Sequence[Messages], **gen_kwargs) -> List[LLMResponse]:
        """Concurrent fan-out with per-item failure isolation: one request
        dying yields an empty LLMResponse carrying the error in metadata,
        never an exception that kills the whole batch (the reference's
        batch stages degrade per-chunk the same way, openie_openai.py)."""
        if not batch:
            return []

        def safe(messages: Messages) -> LLMResponse:
            try:
                return self.infer(messages, **gen_kwargs)
            except Exception as e:  # noqa: BLE001 — isolate per item
                return LLMResponse(text="", metadata={"error": str(e), "finish_reason": "error"})

        if len(batch) == 1:
            return [safe(batch[0])]
        with ThreadPoolExecutor(max_workers=min(self.max_workers, len(batch))) as pool:
            futures = [pool.submit(safe, m) for m in batch]
            return [f.result() for f in futures]

    async def ainfer(self, messages: Messages, **gen_kwargs) -> LLMResponse:
        """Async variant (reference BaseLLM.ainfer parity): runs the sync
        client off the event loop so asyncio orchestration can await it."""
        import asyncio

        return await asyncio.to_thread(self.infer, messages, **gen_kwargs)
