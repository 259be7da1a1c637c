"""LLM factory of the port.

The LLM clients themselves are host code and are reused from the JAX
package as they are (``comorag_tpu.llm.fake``, ``.openai_client``). What
differs is the routing: the in-process generation engine (``jax-offline``,
``jax-tiny``, ``jax:<checkpoint>``) is JAX code whose port is a later
slice (ROADMAP queue 1, item 12), so those names raise here instead of
loading jax.
"""

from __future__ import annotations

from comorag_tpu.llm.base import BaseLLM
from comorag_tpu.llm.fake import FakeLLM


def get_llm(config) -> BaseLLM:
    """``fake`` / ``fake:*`` -> FakeLLM; ``jax-*`` / ``jax:*`` -> error;
    anything else -> the OpenAI-compatible HTTP client (imported lazily)."""
    name = str(config.llm_name)
    if name == "fake" or name.startswith("fake:"):
        return FakeLLM()
    if name in ("jax-offline", "jax-tiny") or name.startswith("jax:"):
        raise NotImplementedError(
            f"llm_name={name!r} is the JAX in-process generation engine, not ported to "
            "comorag_torch yet (ROADMAP queue 1, item 12); use 'fake' or a remote "
            "OpenAI-compatible model name"
        )
    from comorag_tpu.llm.openai_client import OpenAIChatLLM

    return OpenAIChatLLM.from_config(config)


__all__ = ["BaseLLM", "FakeLLM", "get_llm"]
