"""LLM factory of the port (counterpart of ``comorag_tpu/llm/__init__.py``).

The same ``llm_name`` values route to the same kinds of client, so a config
written for the JAX package runs unchanged; the in-process generation
engine is the torch one (``llm/offline.py``) on the device the caller gives.
"""

from __future__ import annotations

from typing import Union

import torch

from comorag_torch.llm.base import BaseLLM, LLMResponse
from comorag_torch.llm.fake import FakeLLM


def get_llm(config, device: Union[str, torch.device, None] = None, mesh=None) -> BaseLLM:
    """LLM factory. Routes:

      - ``fake`` / ``fake:*``       -> hermetic scripted test LLM
      - ``jax-offline``             -> in-process engine, hermetic tiny
                                       random weights
      - ``jax-tiny``                -> in-process engine on the committed
                                       trained tiny checkpoint
                                       (assets/tiny_lm.npz)
      - ``jax:<local checkpoint>``  -> in-process engine on a local llama-,
                                       qwen2/3- or gemma-family checkpoint
      - anything else              -> OpenAI-compatible HTTP client

    The in-process routes run on ``device`` (``cuda`` when None, and the
    mesh's first device under a mesh; a CUDA device without a card raises)
    behind the request-window ``GenerationServer``. The names keep the JAX
    package's spelling so that one config serves both packages.

    ``mesh`` goes to the in-process engine as in JAX (llm/__init__.py:40,
    :59): a ``model`` axis splits its weights for tensor-parallel
    generation, also where the axis spans processes (each process holds
    its own blocks, the products merge across processes and the server
    takes the calls in order, one at a time); a mesh without one changes
    nothing (over a mesh that spans processes each process then runs its
    own replica of the engine).
    """
    name = str(config.llm_name)
    if name == "fake" or name.startswith("fake:"):
        return FakeLLM()
    if name == "jax-tiny":
        from comorag_torch.llm.offline import TorchOfflineLLM
        from comorag_torch.llm.serving import GenerationServer
        from comorag_torch.models.curriculum import default_checkpoint_path, load_tiny_checkpoint

        params, arch = load_tiny_checkpoint(default_checkpoint_path())
        engine = TorchOfflineLLM(
            params=params,
            arch=arch,
            mesh=mesh,
            temperature=0.0,  # the trained behaviors are greedy-decoded
            max_new_tokens=384,  # matches the training curriculum's budget
            seed=getattr(config, "seed", 0) or 0,
            speculative=bool(getattr(config, "speculative_decoding", False)),
            device=device,
        )
        return GenerationServer(engine)
    if name == "jax-offline" or name.startswith("jax:"):
        from comorag_torch.llm.offline import TorchOfflineLLM
        from comorag_torch.llm.serving import GenerationServer

        path = name[len("jax:"):] if name.startswith("jax:") else ""
        path = path or None  # "jax-offline" / bare "jax:" -> hermetic tiny engine
        bf16 = getattr(config, "compute_dtype", "float32") == "bfloat16"
        engine = TorchOfflineLLM(
            model_name_or_path=path,
            mesh=mesh,
            temperature=getattr(config, "temperature", 0.0) or 0.0,
            max_new_tokens=getattr(config, "max_new_tokens", 2048) or 2048,
            seed=getattr(config, "seed", 0) or 0,
            compute_dtype=torch.bfloat16 if bf16 else torch.float32,
            param_dtype=torch.bfloat16 if bf16 else None,
            speculative=bool(getattr(config, "speculative_decoding", False)),
            kv_dtype=getattr(config, "kv_cache_dtype", None),
            device=device,
        )
        # the meta loop calls infer() from up to 16 question threads; the
        # window scheduler turns those into shared device calls
        return GenerationServer(engine)
    from comorag_torch.llm.openai_client import OpenAIChatLLM

    return OpenAIChatLLM.from_config(config)


__all__ = ["BaseLLM", "LLMResponse", "FakeLLM", "get_llm"]
