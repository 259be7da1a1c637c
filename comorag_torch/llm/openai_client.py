"""OpenAI-compatible chat client over httpx.

Capability parity with the reference's ``CacheOpenAI``
(llm/openai_gpt.py:113-197): sqlite response cache, bounded retries with
backoff, temperature/seed-keyed caching. Implemented directly on the HTTP
API (no openai SDK in this image) with a shared connection pool sized for
the meta loop's fan-out.

Copy of ``comorag_tpu/llm/openai_client.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import random
import time
from typing import Any, Dict, Optional

import httpx

from comorag_torch.llm.base import BaseLLM, LLMResponse, Messages
from comorag_torch.llm.cache import ResponseCache
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)


class OpenAIChatLLM(BaseLLM):
    def __init__(
        self,
        model: str,
        base_url: Optional[str] = None,
        api_key: Optional[str] = None,
        cache_path: Optional[str] = None,
        temperature: float = 0.0,
        seed: Optional[int] = None,
        max_new_tokens: int = 2048,
        max_retries: int = 5,
        timeout: float = 300.0,
        max_workers: int = 16,
        n_choices: int = 1,
    ):
        self.model = model
        self.base_url = (base_url or "https://api.openai.com/v1").rstrip("/")
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "EMPTY")
        self.temperature = temperature
        self.seed = seed
        self.max_new_tokens = max_new_tokens
        self.max_retries = max_retries
        self.max_workers = max_workers
        self.n_choices = n_choices
        self.cache = ResponseCache(cache_path) if cache_path else None
        limits = httpx.Limits(max_connections=max(64, max_workers * 4), max_keepalive_connections=32)
        self._client = httpx.Client(limits=limits, timeout=httpx.Timeout(timeout, read=timeout))

    @classmethod
    def from_config(cls, config) -> "OpenAIChatLLM":
        cache_dir = os.path.join(config.save_dir, "llm_cache")
        os.makedirs(cache_dir, exist_ok=True)
        cache_path = os.path.join(cache_dir, f"{config.llm_name.replace('/', '_')}_cache.sqlite")
        return cls(
            model=config.llm_name,
            base_url=config.llm_base_url,
            api_key=config.llm_api_key,
            cache_path=cache_path,
            temperature=config.temperature,
            seed=config.seed,
            max_new_tokens=config.max_new_tokens or 2048,
            max_retries=config.max_retry_attempts,
            max_workers=config.max_concurrent_llm,
            n_choices=config.num_gen_choices,
        )

    def infer(self, messages: Messages, **gen_kwargs) -> LLMResponse:
        temperature = gen_kwargs.pop("temperature", self.temperature)
        max_tokens = gen_kwargs.pop("max_completion_tokens", gen_kwargs.pop("max_tokens", self.max_new_tokens))
        key = None
        if self.cache is not None:
            extra = dict(gen_kwargs)
            # the budget is part of the response identity: a 500-token
            # truncated summary must not be served to a 2000-token request
            extra["max_tokens"] = max_tokens
            if self.n_choices != 1:
                extra["n"] = self.n_choices
            key = ResponseCache.make_key(messages, self.model, self.seed, temperature, extra=extra)
            hit = self.cache.get(key)
            if hit is not None:
                return LLMResponse(text=hit[0], metadata=hit[1], cache_hit=True)

        payload: Dict[str, Any] = {
            "model": self.model,
            "messages": messages,
            "temperature": temperature,
            "max_tokens": max_tokens,
        }
        if self.seed is not None:
            payload["seed"] = self.seed
        # n (reference openai_gpt.py:161); the first choice is the answer
        # (reference :188). response_format is NOT injected client-wide:
        # call sites that want guided JSON pass it via gen_kwargs, so a
        # schema set for extraction never breaks narrative QA parsing.
        if self.n_choices != 1:
            payload["n"] = self.n_choices
        payload.update(gen_kwargs)

        last_err: Optional[Exception] = None
        for attempt in range(self.max_retries):
            try:
                resp = self._client.post(
                    f"{self.base_url}/chat/completions",
                    json=payload,
                    headers={"Authorization": f"Bearer {self.api_key}"},
                )
                resp.raise_for_status()
                data = resp.json()
                choice = data["choices"][0]
                text = choice["message"]["content"] or ""
                usage = data.get("usage", {})
                metadata = {
                    "prompt_tokens": usage.get("prompt_tokens", 0),
                    "completion_tokens": usage.get("completion_tokens", 0),
                    "finish_reason": choice.get("finish_reason"),
                }
                if self.cache is not None and key is not None:
                    self.cache.put(key, text, metadata)
                return LLMResponse(text=text, metadata=metadata, cache_hit=False)
            except Exception as e:  # noqa: BLE001 — network layer
                last_err = e
                status = getattr(getattr(e, "response", None), "status_code", None)
                # permanent client errors (bad key, invalid request,
                # context length) don't heal with retries — a misconfigured
                # batch_infer fan-out would otherwise burn the full backoff
                # budget per item; 429 (rate limit) stays retryable
                if status is not None and 400 <= status < 500 and status != 429:
                    logger.error("LLM call failed permanently (HTTP %d): %s", status, e)
                    break
                logger.warning("LLM call failed (attempt %d/%d): %s", attempt + 1, self.max_retries, e)
                if attempt + 1 < self.max_retries:  # no backoff after the final attempt
                    time.sleep(min(20.0, (2**attempt) + random.random()))
        raise RuntimeError(
            f"LLM call failed after {self.max_retries} attempts: {last_err}"
        ) from last_err
