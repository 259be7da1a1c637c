"""Device selection and host transfers for the port.

Every component takes an explicit ``torch.device``; this module resolves
the user's choice (``"cuda"``, ``"cuda:1"``, ``"cpu"``) and refuses to
carry on quietly on the CPU when a card was asked for.

fp32 precision: the JAX package computes its fp32 paths with
``Precision.HIGHEST`` (models/bge.py:203, ops/topk.py:38); PyTorch's
matching setting is "no TF32", for matmuls AND cuDNN.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is
    requested but none is available (no silent CPU fallback)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev


class HostCopy:
    """A device->host copy in flight: on CUDA the tensor lands in pinned
    memory with ``non_blocking=True`` and an event recorded on the current
    stream of the tensor's own device (the copy's stream, which need not
    be the current device's: a mesh merges on its first device) — the
    port's counterpart of JAX's ``copy_to_host_async``; ``numpy()`` waits
    on this copy alone."""

    def __init__(self, t: torch.Tensor):
        self._event: Optional[torch.cuda.Event] = None
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            stream = torch.cuda.current_stream(t.device)
            with torch.cuda.stream(stream):
                host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(stream)
            self._host = host
        else:
            self._host = t

    def numpy(self):
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._host.numpy()
