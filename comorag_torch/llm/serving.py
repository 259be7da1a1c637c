"""Request-window batching server for the offline generation engine.

The reference's engine gets request batching from vLLM's continuous
batching scheduler (llm/vllm_offline.py wraps ``LLM.generate``, which
joins new requests into the running batch at step granularity). That
design assumes the scheduler sits next to the device; on a
remote-attached TPU every host->device interaction costs ~30 ms, so
step-level joining would pay a round-trip per token. The TPU-appropriate
scheduler is REQUEST-WINDOW batching:

  - callers submit independently (``submit`` returns a Future;
    ``infer``/``batch_infer`` are sync wrappers with the BaseLLM API);
  - a scheduler thread collects arrivals for a short window (or until a
    full batch), groups them by guided-JSON template, and runs each group
    as ONE device program (prefill + while_loop decode, prefix-cache
    aware) through the offline engine;
  - concurrent callers (the meta loop runs <=16 question threads,
    ComoRAG.py:436-437) therefore share device programs instead of
    queueing 16 single-row generations.

Window batching trades a bounded added latency (<= window) for full-batch
device utilization, which wins whenever two requests overlap.

Port of ``comorag_tpu/llm/serving.py`` over the port's ``TorchOfflineLLM``
and ``RequestWindow``; the scheduler is unchanged.

Over an engine whose model axis spans processes
(``engine.across_processes``) the window would form batches by thread
timing, so two processes could form different batches and pair different
collectives. There each ``infer`` / ``batch_infer`` call is served as one
engine call of its own, in call order, in the caller's thread, with no
window, and only from the thread that built the server: a call from any
other thread raises, in every process alike, since whether two threads'
calls overlap is timing that each process sees otherwise (the processes'
lockstep callers, such as ComoRAG's meta loop over a process mesh, build
the server and call it from one thread).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

from comorag_torch.llm.base import BaseLLM, LLMResponse, Messages
from comorag_torch.llm.offline import TorchOfflineLLM
from comorag_torch.utils.logging import get_logger
from comorag_torch.utils.reqwindow import RequestWindow

logger = get_logger(__name__)


class GenerationServer(RequestWindow, BaseLLM):
    """Thread-safe batching front over a TorchOfflineLLM engine.

    Scheduler plumbing (queue/drain/close) lives in RequestWindow — the
    SAME skeleton as retrieval/engine.RetrievalWindow, so cap/close/error
    policies can't diverge between the two again."""

    def __init__(
        self,
        engine: TorchOfflineLLM,
        window_ms: float = 8.0,
        max_batch: int = 64,
    ):
        # 64 rows, the JAX package's width: weight reads amortize across
        # a wider batch. Long-prompt rows don't blow device memory at this
        # width: the engine's KV token-budget admission (offline.batch_infer)
        # splits any group whose padded slots exceed the per-call KV
        # ceiling back into smaller device calls.
        self.engine = engine
        # OpenIE keys guided decoding off this attribute (ie/openie.py
        # _stage_kwargs) — the server forwards gen_kwargs verbatim, so it
        # supports exactly what its engine supports.
        self.supports_guided_json = getattr(engine, "supports_guided_json", False)
        self.max_batch = max_batch
        # an engine whose products merge across processes: calls in order,
        # no window (see the module docstring)
        self.in_order = bool(getattr(engine, "across_processes", False))
        self._owner = threading.get_ident()  # the one thread an in-order server serves
        super().__init__(window_ms / 1000.0, max_batch, "gen-server")

    # ------------------------------------------------------------ interface
    def submit(self, messages: Messages, **gen_kwargs) -> "Future[LLMResponse]":
        fut: "Future[LLMResponse]" = Future()
        if self.in_order:
            fut.set_result(self._call([messages], gen_kwargs)[0])
            return fut
        self._enqueue((messages, gen_kwargs, fut))
        return fut

    def infer(self, messages: Messages, **gen_kwargs) -> LLMResponse:
        return self.submit(messages, **gen_kwargs).result()

    def batch_infer(self, batch: Sequence[Messages], **gen_kwargs) -> List[LLMResponse]:
        if self.in_order:
            return self._call(list(batch), gen_kwargs) if batch else []
        futures = [self.submit(m, **gen_kwargs) for m in batch]
        return [f.result() for f in futures]

    def _call(self, batch: List[Messages], gen_kwargs: Dict[str, Any]) -> List[LLMResponse]:
        """One engine call for one caller's requests, in the caller's
        thread; an engine error raises to the caller (in every process)."""
        if threading.get_ident() != self._owner:
            raise RuntimeError("GenerationServer over a model axis that spans processes serves only the thread that "
                               "built it: every process must make the same calls in the same order, and calls from "
                               "other threads would interleave by thread timing; call it from that thread")
        results = self.engine.batch_infer(batch, **gen_kwargs)
        for r in results:
            r.metadata["batched_with"] = len(batch) - 1
        return results

    # ------------------------------------------------------------ scheduler
    def _on_serve_error(self, batch, e: Exception) -> None:
        for _, _, fut in batch:
            # one response object PER requester: they are mutable (the
            # success path mutates metadata) and two threads sharing one
            # would cross-contaminate
            _resolve(fut, LLMResponse(
                text="", metadata={"error": str(e), "finish_reason": "error"}
            ))

    def _serve(self, batch: List[Tuple[Messages, Dict[str, Any], Future]]) -> None:
        # group by generation options: one device program per distinct
        # (template, max_tokens, temperature) — mixed options can't
        # share a while_loop program
        groups: Dict[Tuple, List[int]] = {}
        for i, (_, kw, _f) in enumerate(batch):
            # `is None` (not falsy-or): an explicit max_tokens=0 must stay
            # a minimal cap, not balloon to the engine default.
            # max_completion_tokens is the OpenAI-client spelling (rerank/
            # summarize pass it) — honor it like openai_client.py does.
            mt = kw.get("max_tokens")
            if mt is None:
                mt = kw.get("max_completion_tokens")
            key = (
                kw.get("json_template"),
                int(self.engine.max_new_tokens if mt is None else mt),
                kw.get("temperature"),
            )
            groups.setdefault(key, []).append(i)
        for key, idxs in groups.items():
            template, max_tokens, temperature = key
            msgs = [batch[i][0] for i in idxs]
            try:
                results = self.engine.batch_infer(
                    msgs,
                    max_tokens=max_tokens,
                    json_template=template,
                    temperature=temperature,
                )
            except Exception as e:  # noqa: BLE001 — fail the futures, not the thread
                logger.warning("generation group failed: %s", e)
                results = [
                    LLMResponse(text="", metadata={"error": str(e), "finish_reason": "error"})
                    for _ in idxs
                ]
            for i, r in zip(idxs, results):
                r.metadata["batched_with"] = len(batch) - 1
                _resolve(batch[i][2], r)


def _resolve(fut: Future, result: LLMResponse) -> None:
    """set_result that tolerates callers who cancelled their future."""
    if not fut.done():
        try:
            fut.set_result(result)
        except Exception:  # pragma: no cover — lost cancel race
            pass
