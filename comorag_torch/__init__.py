"""comorag_torch — the PyTorch/CUDA port of comorag_tpu for NVIDIA Hopper.

Module names mirror ``comorag_tpu`` so each counterpart is easy to find:
``comorag_torch.ops.topk`` ports ``comorag_tpu.ops.topk`` and so on. The
JAX package stays the reference; this package imports torch and never
jax, and nothing of ``comorag_tpu`` either: the host modules that never
touch jax (config, prompts, agents, OpenIE, the LLM clients, the
embedding store, the timeline, the native PPR solver) are copies kept in
this package, each naming its counterpart.

Every Pallas kernel on the main path has a hand-written Hopper kernel here
(``csrc/*.cu``), built with nvcc at first use; each wrapper runs its
kernel for a CUDA tensor and the plain PyTorch version beside it for a
CPU tensor.
"""

__version__ = "0.1.0"

from comorag_torch.config import ComoConfig
from comorag_torch.utils import trace


def __getattr__(name):
    # lazy: keep `import comorag_torch` cheap (no torch until needed)
    if name == "ComoRAG":
        from comorag_torch.comorag import ComoRAG

        return ComoRAG
    raise AttributeError(name)


__all__ = ["ComoConfig", "ComoRAG", "trace", "__version__"]
