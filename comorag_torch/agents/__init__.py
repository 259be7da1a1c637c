"""Copy of ``comorag_tpu/agents/__init__.py`` for the port, which imports nothing of the JAX package."""

from comorag_torch.agents.pool_agent import PoolAgent
from comorag_torch.agents.probe_agent import ProbeAgent

__all__ = ["PoolAgent", "ProbeAgent"]
