"""Encoder factory (port of ``comorag_tpu/models/registry.py``).

Name scheme, as in the JAX package:
  - ``hash``                 -> hermetic HashEncoder (reused as it is)
  - ``bge:<local path>``     -> BGETorchEncoder on a local HF checkpoint
                                (``transformers`` is imported only then)
  - ``openai:<model-name>``  -> remote OpenAI-compatible embeddings API
"""

from __future__ import annotations

import torch

from comorag_torch.config import ComoConfig
from comorag_torch.models.base import BaseEncoder
from comorag_torch.models.hash_encoder import HashEncoder


def get_encoder(config: ComoConfig, device: torch.device, mesh=None) -> BaseEncoder:
    """The encoder ``config`` names, on ``device``; a BGE encoder under
    ``mesh`` splits its batches over the mesh's ``data`` axis."""
    enc = _build_encoder(config, device, mesh)
    # encode() calls without norm= follow the config, so queries and corpus
    # stay in one vector space
    enc.default_norm = bool(config.embedding_return_as_normalized)
    return enc


def _build_encoder(config: ComoConfig, device: torch.device, mesh=None) -> BaseEncoder:
    name = config.embedding_model_name
    if name == "hash" or name.startswith("hash:"):
        return HashEncoder(dim=config.embedding_dim)
    if name.startswith("bge:") or "bge" in name.lower():
        from comorag_torch.models.bge import BGETorchEncoder

        path = name.split(":", 1)[1] if ":" in name else name
        return BGETorchEncoder(
            path,
            max_seq_len=config.embedding_max_seq_len,
            batch_size=config.embedding_batch_size,
            device=device,
            compute_dtype=torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32,
            mesh=mesh,
        )
    if name.startswith("openai:") or name.startswith("text-embedding"):
        from comorag_torch.models.remote import RemoteEncoder

        model = name.split(":", 1)[1] if ":" in name else name
        return RemoteEncoder(model=model, base_url=config.embedding_base_url,
                             api_key=config.embedding_api_key)
    raise ValueError(
        f"Unknown embedding model name: {name!r}. "
        "Use 'hash', 'bge:<local path>', or 'openai:<model>'."
    )
