"""Processes of one mesh (the port's counterpart of ``jax.distributed``).

JAX's multi-controller contract: every process runs the same program and
calls the same sharded functions in the same order; each holds only its
own devices' shards, and the collectives inside the functions meet across
processes. ``initialize`` joins this process to such a group
(``torch.distributed`` over a TCP rendezvous at ``coordinator_address``);
``parallel/mesh.build_mesh`` then builds a mesh over every process's local
devices, process-major, as ``jax.devices()`` lists them under
``jax.distributed``.

Backends, as the caller names them, never swapped:

  - ``"nccl"`` (the default on CUDA): the collectives run on the card, on
    the mesh's merge device, which must be the device passed to
    ``initialize``; two processes of one host on one card are refused
    (NCCL cannot run two ranks on one GPU);
  - ``"gloo"`` (the default on the CPU; also allowed with CUDA devices,
    e.g. two processes on one card): each collective copies its small
    candidate or state tensor to the host, exchanges it there and copies
    the result back to the tensor's device.

Without an initialized group every collective is the identity (``agree``
passes), so a single-process mesh never calls into
``torch.distributed``. Trace spans: ``dist.all_gather_cols``,
``dist.all_gather_rows``, ``dist.all_reduce`` and ``dist.agree`` (a whole
collective), inside each ``dist.stage`` (the copy of the tensor to
exchange, which under gloo waits for the card's work on it).
"""

from __future__ import annotations

import datetime
import hashlib
import json
from typing import Any, List, Optional, Union

import torch
import torch.distributed as dist

from comorag_torch.device import resolve_device
from comorag_torch.utils import trace

BACKENDS = ("nccl", "gloo")
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}

# the device passed to ``initialize``: under NCCL, the one card this
# process's collectives run on
_home: Optional[torch.device] = None


def duplicate_cards(card_ids: List[str]) -> Optional[tuple]:
    """The first pair of ranks whose card identifiers are equal, or None."""
    seen = {}
    for rank, card in enumerate(card_ids):
        if card in seen:
            return seen[card], rank
        seen[card] = rank
    return None


def exchange(store: dist.Store, process_id: int, num_processes: int, value: str) -> List[str]:
    """Every process's ``value`` through the rendezvous store, in process
    order. Process 0 holds the store, so it returns only once every
    process has read all the values: a process that then raises (two ranks
    on one card) cannot close the store under another's read."""
    store.set(f"comorag/value/{process_id}", json.dumps(value))
    values = [json.loads(store.get(f"comorag/value/{r}")) for r in range(num_processes)]
    store.set(f"comorag/read/{process_id}", "1")
    if process_id == 0:
        store.wait([f"comorag/read/{r}" for r in range(num_processes)])
    return values


def _card_id(dev: torch.device) -> str:
    """The card's UUID: one physical card has one UUID in every process,
    whatever each process's CUDA_VISIBLE_DEVICES numbers it."""
    return str(torch.cuda.get_device_properties(dev).uuid)


def initialize(coordinator_address: str, num_processes: int, process_id: int, backend: Optional[str] = None,
               timeout_s: float = 60, device: Union[str, torch.device, None] = None) -> None:
    """Join process ``process_id`` of ``num_processes`` to the group whose
    rendezvous (process 0 listens) is ``coordinator_address``
    ("host:port"). ``device``: this process's home device, "cuda" when
    None (raises without a card); ``backend`` defaults to "nccl" on CUDA
    and "gloo" on the CPU. Under NCCL the home device becomes the current
    CUDA device, and the ranks' cards are compared before the group forms:
    two ranks on one card raise ValueError in every process."""
    global _home
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {dev}; use backend='gloo' on the CPU")
    host, port = coordinator_address.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0, timeout=timeout)
    if backend == "nccl":
        torch.cuda.set_device(dev)
        cards = exchange(store, process_id, num_processes, _card_id(dev))
        pair = duplicate_cards(cards)
        if pair is not None:
            raise ValueError(f"nccl: ranks {pair[0]} and {pair[1]} are on the same card ({cards[pair[0]]}); "
                             "NCCL needs one card per rank: give each process its own card, or name "
                             "backend='gloo'")
    dist.init_process_group(backend, store=store, rank=process_id, world_size=num_processes, timeout=timeout)
    _home = dev


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def backend() -> Optional[str]:
    return dist.get_backend() if initialized() else None


def home_device() -> Optional[torch.device]:
    """The device passed to ``initialize`` (None without a group)."""
    return _home if initialized() else None


def shutdown() -> None:
    global _home
    if initialized():
        dist.destroy_process_group()
    _home = None


def all_gather_object(obj: Any) -> List[Any]:
    """Every process's ``obj``, in process order (``[obj]`` without a group)."""
    if not initialized():
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def _staged(t: torch.Tensor) -> torch.Tensor:
    """The tensor the collective runs on, a new one: a host copy under
    gloo, a copy on ``t``'s own device (the merge device) under nccl."""
    if backend() != "gloo" and t.device.type != "cuda":
        raise ValueError(f"the nccl backend exchanges CUDA tensors, got one on {t.device}")
    with trace.span("dist.stage"):
        if backend() == "gloo":
            return t.detach().to("cpu", copy=True).contiguous()
        return t.detach().clone().contiguous()


def _gather_cols(t: torch.Tensor) -> torch.Tensor:
    x = _staged(t)
    width = torch.tensor([x.shape[1]], dtype=torch.int64, device=x.device)
    widths = [torch.empty_like(width) for _ in range(process_count())]
    dist.all_gather(widths, width)
    widths = [int(w) for w in torch.cat(widths).tolist()]
    padded = x.new_zeros((x.shape[0], max(widths)))
    padded[:, : x.shape[1]] = x
    blocks = [torch.empty_like(padded) for _ in widths]
    dist.all_gather(blocks, padded)
    return torch.cat([b[:, :w] for b, w in zip(blocks, widths)], dim=1).to(t.device)


def all_gather_cols(t: torch.Tensor) -> torch.Tensor:
    """Each process's [P, c_i] block concatenated along dim 1 in process
    order, on ``t``'s device (the widths may differ: they are exchanged
    first, and each block is padded to the widest for the gather)."""
    if not initialized():
        return t
    with trace.span("dist.all_gather_cols"):
        return _gather_cols(t)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Each process's [r_i, d] block concatenated along dim 0 in process
    order, on ``t``'s device (``all_gather_cols`` on the transpose: the
    row counts may differ, a process may give none)."""
    if not initialized():
        return t
    with trace.span("dist.all_gather_rows"):
        return _gather_cols(t.T).T.contiguous()


def agree(value: Any, what: str) -> None:
    """Raise RuntimeError in every process unless every process passed an
    equal ``value`` (compared by a digest of its ``repr``, so only the
    digests travel); the message names ``what`` and the processes whose
    value differs from process 0's."""
    if not initialized():
        return
    with trace.span("dist.agree"):
        digests = all_gather_object(hashlib.sha256(repr(value).encode()).hexdigest()[:16])
    differ = [p for p, d in enumerate(digests) if d != digests[0]]
    if differ:
        raise RuntimeError(f"{what}: process(es) {differ} disagree with process 0 (digests {digests})")


def all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """``t`` reduced elementwise over the processes with ``op`` ("sum",
    "min" or "max"), a new tensor on ``t``'s device."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
    if not initialized():
        return t
    with trace.span("dist.all_reduce"):
        x = _staged(t)
        dist.all_reduce(x, _OPS[op])
        return x.to(t.device)
