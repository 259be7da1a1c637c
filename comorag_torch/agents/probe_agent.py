"""ProbeAgent: generate exploratory sub-queries at an impasse.

Capability parity with the reference's ProbeAgent (utils/agents.py:133-166):
up to 3 entity-targeted probes as ``{"probe_N": ...}`` JSON; parse failures
return an empty list (the meta loop then proceeds without new evidence).
Parsing uses the defensive JSON extractor, never ``eval``.

Copy of ``comorag_tpu/agents/probe_agent.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Optional

from comorag_torch.llm.base import BaseLLM
from comorag_torch.prompts.manager import PromptManager
from comorag_torch.utils.json_repair import extract_json_object
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)


class ProbeAgent:
    def __init__(self, llm: BaseLLM, prompts: Optional[PromptManager] = None, max_probes: int = 3):
        self.llm = llm
        self.prompts = prompts or PromptManager()
        self.max_probes = max_probes

    def find_probes(self, query: str, context: str = "", previous_probes: str = "") -> List[str]:
        messages = self.prompts.render(
            "agent_probe", query=query, context=context or "", previous_probes=previous_probes or ""
        )
        try:
            response = self.llm.infer(messages, max_completion_tokens=500)
        except Exception as e:  # noqa: BLE001
            logger.error("probe generation failed: %s", e)
            return []
        obj = extract_json_object(response.text or "")
        if not obj:
            return []
        probes = [str(v) for k, v in sorted(obj.items()) if k.startswith("probe_") and v]
        return probes[: self.max_probes]
