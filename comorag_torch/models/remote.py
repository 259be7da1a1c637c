"""Remote OpenAI-compatible embeddings encoder.

Capability parity with the reference's OpenAIEmbeddingModel
(embedding_model/OpenAI.py:77-128): batched requests, optional L2
normalization, instruction prefixes. Implemented over the plain HTTP API
(urllib) so it carries no SDK dependency; retries with exponential backoff.

Copy of ``comorag_tpu/models/remote.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request
from typing import List, Optional, Sequence

import numpy as np

from comorag_torch.models.base import BaseEncoder
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)


class RemoteEncoder(BaseEncoder):
    def __init__(
        self,
        model: str,
        base_url: Optional[str] = None,
        api_key: Optional[str] = None,
        batch_size: int = 128,
        max_retries: int = 5,
        timeout: float = 60.0,
    ):
        self.model = model
        self.base_url = (base_url or os.environ.get("OPENAI_BASE_URL") or "https://api.openai.com/v1").rstrip("/")
        self.fingerprint_extra = model  # store validation distinguishes models
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY") or "EMPTY"
        self.batch_size = batch_size
        self.max_retries = max_retries
        self.timeout = timeout

    # ------------------------------------------------------------------ http
    def _post(self, texts: List[str]) -> List[List[float]]:
        body = json.dumps({"model": self.model, "input": texts}).encode("utf-8")
        req = urllib.request.Request(
            self.base_url + "/embeddings",
            data=body,
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.api_key}",
            },
        )
        delay = 1.0
        for attempt in range(self.max_retries):
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    payload = json.loads(resp.read().decode("utf-8"))
                data = sorted(payload["data"], key=lambda d: d["index"])
                if len(data) != len(texts):
                    # a short 200 response (server dropped an over-length
                    # input) would silently misalign EVERY later
                    # text/vector pair in the store
                    raise ValueError(
                        f"embeddings API returned {len(data)} rows for "
                        f"{len(texts)} inputs"
                    )
                return [d["embedding"] for d in data]
            except (urllib.error.URLError, OSError, KeyError, json.JSONDecodeError, ValueError) as exc:
                status = getattr(exc, "code", None)
                if status is not None and 400 <= status < 500 and status != 429:
                    # permanent client error (bad key / invalid request):
                    # retries can never succeed, don't burn the backoff
                    raise
                if attempt == self.max_retries - 1:
                    raise
                logger.warning("embeddings request failed (%s); retry in %.1fs", exc, delay)
                time.sleep(delay)
                delay = min(delay * 2, 30.0)
        raise RuntimeError("unreachable")

    # ---------------------------------------------------------------- encode
    def encode(self, texts: Sequence[str], instruction: str = "", norm=None) -> np.ndarray:
        norm = self.resolve_norm(norm)
        texts = self._as_list(texts)  # a bare str must not iterate per CHAR
        texts = [(instruction + t) if instruction else t for t in texts]
        # the API rejects empty strings — substitute a space (reference
        # behavior: OpenAI.py replaces empties before the call)
        texts = [t if t.strip() else " " for t in texts]
        out: List[List[float]] = []
        for i in range(0, len(texts), self.batch_size):
            out.extend(self._post(texts[i : i + self.batch_size]))
        if not out:
            # [0, dim] like every other encoder — a 1-D (0,) array breaks
            # downstream concatenation/shape access
            dim = getattr(self, "_dim", None)
            return np.zeros((0, dim or 0), np.float32)
        embs = np.asarray(out, np.float32)
        self._dim = embs.shape[1]
        if norm and embs.size:
            norms = np.linalg.norm(embs, axis=1, keepdims=True)
            norms[norms == 0] = 1.0
            embs = embs / norms
        return embs
