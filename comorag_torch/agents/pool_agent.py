"""PoolAgent: cue fusion over retrieved evidence.

Capability parity with the reference's PoolAgent (utils/agents.py:55-130):
  - ``fusion``: distill each memory layer's retrieved content into a "cue"
    (key findings) — the reference runs the three layers in 3 threads; here
    it's a single ``batch_infer`` so a server-backed LLM still gets
    concurrency and a batched backend gets one batch.
  - ``fuse_memory_nodes``: merge similar historical nodes into one finding.

Copy of ``comorag_tpu/agents/pool_agent.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

from comorag_torch.llm.base import BaseLLM
from comorag_torch.prompts.manager import PromptManager
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)


class PoolAgent:
    def __init__(self, llm: BaseLLM, prompts: Optional[PromptManager] = None):
        self.llm = llm
        self.prompts = prompts or PromptManager()

    def fusion(self, query: str, vers: str, sems: str, epis: str) -> Tuple[str, str, str]:
        """One cue per layer: (ver_cue, sem_cue, epi_cue). Empty layers skip
        the LLM call and yield empty cues."""
        contents = [vers, sems, epis]
        batch = []
        positions = []
        for i, content in enumerate(contents):
            if content:
                batch.append(self.prompts.render("memory_fusion", query=query, content=content))
                positions.append(i)
        cues = ["", "", ""]
        if batch:
            try:
                responses = self.llm.batch_infer(batch, max_completion_tokens=500)
                for pos, resp in zip(positions, responses):
                    cues[pos] = resp.text or ""
            except Exception as e:  # noqa: BLE001 — keep the loop alive on LLM failure
                logger.error("fusion failed: %s", e)
        return cues[0], cues[1], cues[2]

    def fuse_memory_nodes(self, query: str, content: str, max_completion_tokens: int = 1000) -> str:
        try:
            messages = self.prompts.render("node_fusion", query=query, content=content)
            return self.llm.infer(messages, max_completion_tokens=max_completion_tokens).text
        except Exception as e:  # noqa: BLE001
            logger.error("node fusion failed: %s", e)
            return f"Error during fusion. Original content:\n{content}"
