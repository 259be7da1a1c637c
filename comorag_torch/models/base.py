"""Encoder interface.

Capability parity with the reference's ``BaseEmbeddingModel.batch_encode``
(embedding_model/base.py:189-218): batched text -> L2-normalized float
vectors, with an optional instruction prefix (prompts/linking.py semantics).

Copy of ``comorag_tpu/models/base.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Union

import numpy as np


class BaseEncoder(ABC):
    """All encoders return ``np.ndarray [n, dim]`` float32, L2-normalized
    (unless ``norm=False``). Device-side encoders (the JAX BGE encoder) do the
    forward pass under jit and only surface host numpy at this boundary."""

    dim: int
    #: default for encode(norm=None) — the reference's
    #: ``embedding_return_as_normalized`` knob (config_utils.py), set by the
    #: factory from ``ComoConfig.embedding_return_as_normalized``
    default_norm: bool = True

    def resolve_norm(self, norm) -> bool:
        return self.default_norm if norm is None else bool(norm)
    #: bump in a subclass whenever its embedding function changes shape or
    #: semantics — persisted stores validate against the fingerprint so a
    #: changed encoder regenerates vectors instead of silently mixing old
    #: corpus embeddings with new query embeddings
    encoder_version: int = 1

    @property
    def fingerprint(self) -> str:
        extra = getattr(self, "fingerprint_extra", "")
        extra = f":{extra}" if extra else ""
        # normalization changes the vector space: a store built normalized
        # must not validate against an unnormalized configuration (mixing
        # scales silently biases rankings toward larger-norm rows)
        raw = "" if self.default_norm else ":raw"
        return f"{type(self).__name__}{extra}:d{getattr(self, 'dim', 0)}:v{self.encoder_version}{raw}"

    @abstractmethod
    def encode(
        self,
        texts: Union[str, List[str]],
        instruction: str = "",
        norm=None,
    ) -> np.ndarray:
        ...

    # Reference-compatible alias (embedding_model/base.py:189)
    def batch_encode(self, texts, instruction: str = "", norm=None) -> np.ndarray:
        return self.encode(texts, instruction=instruction, norm=norm)

    @staticmethod
    def _as_list(texts: Union[str, List[str]]) -> List[str]:
        return [texts] if isinstance(texts, str) else list(texts)

    @staticmethod
    def _l2_normalize(x: np.ndarray) -> np.ndarray:
        n = np.linalg.norm(x, axis=-1, keepdims=True)
        return x / np.maximum(n, 1e-12)
