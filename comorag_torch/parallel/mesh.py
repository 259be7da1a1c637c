"""Device mesh construction (port of ``comorag_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process drives every device of
a ``jax.sharding.Mesh``. The port keeps that shape without
``torch.distributed``: a mesh is a named grid of ``torch.device``s, a
sharded tensor is a list of per-device tensors in mesh order, a
``shard_map`` body is a function run once per shard on that shard's
device, and ``all_gather`` / ``psum`` / ``pmax`` / ``pmin`` are a
concatenation, sum, max or min of the shard results copied to the mesh's
first device (the merge device). On a multi-card mesh each shard's work is
queued on its own device's current stream, so the shards overlap without
threads, and the cross-device copies order the merge after them. A
process group would turn every retrieval call into a collective that all
ranks must enter in step: the corpus programs, and the meta loop with its
questions in lockstep, do so over a mesh that spans processes (below).

Axes (as in the JAX package):

  - ``corpus``: retrieval indexes shard their rows and the PPR graph its
    arcs over this axis; the shards live on the devices along it, at index
    0 of every other axis (JAX's replicas along the other axes compute the
    same values from replicated queries, so the port keeps none);
  - ``data``: the encoder splits each batch over this axis's devices, and
    the training steps split theirs (``split_batch``) and run each part on
    a differentiable replica of the parameters (``data_replica``), so the
    backward sums every replica's gradients into the masters: JAX's
    gradient all-reduce;
  - ``model``: tensor-parallel generation (``models/decoder.shard_params``):
    a weight is a ``Sharded`` leaf, one block per device along the axis
    (JAX's Megatron split: output columns or input rows); a product runs
    once per shard on the shard's device and merges on the first device by
    a column gather (``gather_columns``) or a sum of partial products
    (``sum_partials``). Activations, the KV cache and attention stay whole
    on the merge device. Where the axis spans processes, each process
    holds only its own blocks (``model_part``) and the merges meet across
    processes (below).

A device list may repeat a device: ``[torch.device("cpu")] * 8`` or
``[torch.device("cuda", 0)] * 4`` build a mesh of 8 or 4 positions on one
device, the counterpart of ``--xla_force_host_platform_device_count``.

Across processes (``parallel/distributed.py``, JAX's multi-controller
mesh under ``jax.distributed``): after ``distributed.initialize``,
``build_mesh`` takes this process's local devices and exchanges them once
with every process; the mesh's positions are every process's local
devices, process-major. A position another process owns holds a
``RemoteDevice`` placeholder that no code places a tensor on
(``process_of``, ``is_local``), and ``Mesh.device`` is this process's
first local position. Every process then runs the same calls in the same
order: the corpus programs (``ops/topk.make_sharded_*``,
``ops/ppr.make_sharded_ppr*``, ``MipsIndex(mesh=)``, ``PPRGraph(mesh=)``)
compute on their local shards and meet in the collectives of
``distributed``, and every process returns the same result. ``ComoRAG``
runs its meta loop over such a mesh with the questions in lockstep, and
the encoder splits a batch over the ``data`` axis by process: each
encodes the sub-batches of its own data indices (``local_indices``) and
the rows are gathered. TP generation splits the decoder over a ``model``
axis that spans processes: a ``Sharded`` leaf holds this process's blocks
alone, with their axis ``indices``; every process computes the
activations, the KV cache and the whole leaves itself from the same
inputs (JAX's replicated activations), runs its own blocks' products and
merges them with every other process's (``distributed.all_gather_cols``:
the column blocks in position order, or every shard's partial product,
summed in shard order as ``sum_partials`` sums them), so every process
holds the same merged values. The encoder's split weights and the
training batch split run on one process's meshes only (``one_process``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from comorag_torch.device import resolve_device
from comorag_torch.parallel import distributed

DeviceLike = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class RemoteDevice:
    """A mesh position owned by another process: its process index and its
    device's name there. It is no ``torch.device``, so no tensor can be
    placed on it."""

    process: int
    name: str


def is_local_device(dev) -> bool:
    """Whether a mesh position's device belongs to this process."""
    return not isinstance(dev, RemoteDevice)


class Mesh:
    """A named grid of devices: ``devices`` is a numpy object array shaped
    by the axis sizes, ``shape`` maps axis name -> size. ``processes``
    (same shape; zeros when None) gives the process that owns each
    position; this process (``process_index``) holds ``torch.device``s at
    its own positions and ``RemoteDevice``s at the others."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], processes: Optional[np.ndarray] = None,
                 process_index: int = 0):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.processes = np.zeros(devices.shape, np.int64) if processes is None else processes
        self.process_index = process_index

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def process_count(self) -> int:
        """The number of processes that own positions of this mesh."""
        return len(np.unique(self.processes))

    @property
    def device(self) -> torch.device:
        """The merge device: this process's first position's device."""
        return next(d for d in self.devices.flat if is_local_device(d))

    def _index(self, index: Dict[str, int]) -> tuple:
        return tuple(index.get(name, 0) for name in self.axis_names)

    def at(self, **index: int) -> torch.device:
        """The device at ``index`` (axis name -> position), at position 0
        of every axis not named (or not in the mesh)."""
        return self.devices[self._index(index)]

    def process_of(self, **index: int) -> int:
        """The process that owns the position at ``index`` (as ``at``)."""
        return int(self.processes[self._index(index)])

    def is_local(self, **index: int) -> bool:
        """Whether this process owns the position at ``index`` (as ``at``)."""
        return self.process_of(**index) == self.process_index

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis (the
        first device alone when the mesh has no such axis)."""
        if axis not in self.axis_names:
            return [self.device]
        at = tuple(slice(None) if name == axis else 0 for name in self.axis_names)
        return list(self.devices[at])

    def local_indices(self, axis: str) -> List[int]:
        """The indices along ``axis`` (at index 0 of every other axis) whose
        position this process owns, in order; ``[0]`` when the mesh has no
        such axis (the first device alone, as ``axis_devices``). The
        positions are process-major, so along any axis the owners never
        decrease: every process's indices follow those of the processes
        before it, and a process may own none."""
        if axis not in self.axis_names:
            return [0]
        return [i for i in range(self.shape[axis]) if self.is_local(**{axis: i})]

    def __repr__(self) -> str:
        procs = f", {self.process_count} processes" if self.process_count > 1 else ""
        return f"Mesh({self.shape}, first device {self.device}{procs})"


def build_mesh(shape: Optional[Dict[str, int]] = None,
               devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Build a mesh. Default: every visible CUDA device on the ``corpus``
    axis (without a card this raises: pass ``devices``, e.g.
    ``[torch.device("cpu")] * 8``, to build one on the CPU).

    ``shape`` maps axis name -> size, e.g. ``{"data": 2, "corpus": 4}``.
    After ``distributed.initialize`` in a group of several processes,
    ``devices`` are this process's local devices and the mesh spans every
    process's (``process_mesh``).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_mesh: devices=None means every CUDA device, and "
                               "torch.cuda.is_available() is False; pass devices=[torch.device('cpu')] * n "
                               "(device='cpu' for ComoRAG) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if distributed.process_count() > 1:
        return process_mesh(shape, devices)
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"a mesh's devices must be of one type, got {sorted({str(d) for d in devices})}")
    return _grid(shape, devices, None, 0)


def _grid(shape: Optional[Dict[str, int]], devices: list, processes: Optional[list], me: int) -> Mesh:
    if shape is None:
        shape = {"corpus": len(devices)}
    sizes = list(shape.values())
    total = int(np.prod(sizes))
    if total != len(devices):
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    procs = None if processes is None else np.asarray(processes, np.int64).reshape(sizes)
    return Mesh(grid.reshape(sizes), tuple(shape.keys()), procs, me)


def process_mesh(shape: Optional[Dict[str, int]], local: Sequence[torch.device]) -> Mesh:
    """A mesh over every process of the group: each process passes its
    local devices (at least one), the lists are exchanged once, and the
    positions are every process's devices, process-major (rank 0's first).
    Under NCCL the merge device (this process's first) must be the device
    passed to ``distributed.initialize``: its collectives run there."""
    names = distributed.all_gather_object([str(d) for d in local])
    me = distributed.process_index()
    if not all(names):
        raise ValueError(f"every process needs a local device: {names}")
    kinds = {torch.device(n).type for per in names for n in per}
    if len(kinds) > 1:
        raise ValueError(f"a mesh's devices must be of one type, got {sorted(kinds)} across processes")
    home = distributed.home_device()
    if distributed.backend() == "nccl" and local[0] != home:
        raise ValueError(f"nccl: this process's first mesh device {local[0]} is not the device passed to "
                         f"initialize ({home}), where its collectives run")
    devices, processes = [], []
    for p, per in enumerate(names):
        devices += list(local) if p == me else [RemoteDevice(p, n) for n in per]
        processes += [p] * len(per)
    return _grid(shape, devices, processes, me)


def one_process(mesh: Optional[Mesh], what: str) -> None:
    """Refuse a mesh that spans processes where ``what`` runs on one
    process's meshes only."""
    if mesh is not None and mesh.process_count > 1:
        raise NotImplementedError(f"{what} over a mesh of {mesh.process_count} processes is not ported: across "
                                  "processes run the corpus programs (MipsIndex, PPRGraph, ops/topk, ops/ppr), "
                                  "ComoRAG's meta loop, the encoder's data axis and TP generation (the decoder's "
                                  "model axis); the encoder's model axis and training (its batch split) run on "
                                  "one process's meshes")


def parse_mesh_shape(spec: str) -> Dict[str, int]:
    """A CLI's ``--mesh_shape``, e.g. ``"data=2,model=2"``, as the shape
    ``build_mesh`` takes (empty parts skipped, as the JAX train CLI's
    ``parse_mesh`` skips them); anything else raises ValueError."""
    shape = {}
    for part in spec.split(","):
        if part.strip():
            axis, size = part.split("=")
            shape[axis.strip()] = int(size)
    return shape


def device_mesh(shape: Dict[str, int], device: Optional[DeviceLike]) -> Mesh:
    """A mesh of ``shape`` over devices that follow ``device``: every card
    for CUDA (too few raise), the CPU repeated to the mesh's size for
    "cpu"."""
    dev = resolve_device(device)
    return build_mesh(shape, [dev] * int(np.prod(list(shape.values()))) if dev.type == "cpu" else None)


def corpus_axis_size(mesh: Mesh) -> int:
    return mesh.shape.get("corpus", 1)


def mesh_device(mesh: Optional[Mesh], device: Optional[DeviceLike] = None) -> torch.device:
    """The device a component runs its unsharded work on and merges on:
    the mesh's first device under a mesh (a device passed beside the mesh
    must be that one), else ``resolve_device(device)`` ("cuda" when None)."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {str(device)!r} is not the mesh's first device {mesh.device}")
    return mesh.device


def on_device(device: torch.device):
    """Make ``device`` the current CUDA device for a shard's work (the
    kernels' C entries launch on the current device); no-op on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_bounds(n: int, n_shards: int, rows_per_shard: int) -> List[range]:
    """Row ranges of ``n`` rows over ``n_shards`` shards of
    ``rows_per_shard`` rows each: the last shards hold what is left, which
    may be nothing (the JAX layout without its padding rows)."""
    return [range(min(s * rows_per_shard, n), min((s + 1) * rows_per_shard, n)) for s in range(n_shards)]


# ------------------------------------------------------ the ``model`` axis
@dataclasses.dataclass(frozen=True)
class Sharded:
    """A weight split over a mesh's ``model`` axis: ``shards`` holds one
    block per device of ``devices`` (the axis, in mesh order), each a
    contiguous tensor of its own on its device, or a ``QuantWeight`` /
    ``Int4Weight`` of such tensors; ``dim`` is ``"col"`` for a split of the
    output columns (the last dim) or ``"row"`` for a split of the input
    rows (the dim before it). ``indices``: None where ``shards`` are every
    position's; on an axis that spans processes, the axis indices of the
    blocks this process holds (``model_part``), the others' held by the
    other processes, whose merges meet across processes."""

    shards: Tuple[Any, ...]
    dim: str
    devices: Tuple[torch.device, ...]
    indices: Optional[Tuple[int, ...]] = None

    def __getitem__(self, index) -> "Sharded":
        """The same index of every shard (a layer of stacked [L, ...] blocks)."""
        shards = tuple(type(s)(*(t[index] for t in s)) if isinstance(s, tuple) else s[index] for s in self.shards)
        return dataclasses.replace(self, shards=shards)

    def position(self, i: int) -> int:
        """The axis index of ``shards[i]``."""
        return i if self.indices is None else self.indices[i]


def model_part(mesh: Mesh) -> Tuple[Optional[Tuple[int, ...]], Tuple[torch.device, ...]]:
    """This process's part of ``mesh``'s ``model`` axis: (the axis indices
    whose blocks it holds, or None where it holds every block; the device
    of each block it holds). Block m lives on this process's first
    position at model index m (on one process's mesh: index 0 of every
    other axis). Where every process owns a position at every model index,
    each holds every block (a replica: no merge leaves the process);
    otherwise the positions of each model index must lie in one process,
    which alone holds that block (JAX's blocks, one per device, with the
    copies of a block all in one process), and the merges meet across
    processes. A mesh without the axis gives one block on its first
    device."""
    if "model" not in mesh.shape:
        return None, (mesh.device,)
    size, axis, me = mesh.shape["model"], mesh.axis_names.index("model"), mesh.process_index
    procs = np.moveaxis(mesh.processes, axis, 0).reshape(size, -1)
    devs = np.moveaxis(mesh.devices, axis, 0).reshape(size, -1)
    held = [m for m in range(size) if me in procs[m]]
    devices = tuple(next(d for d, p in zip(devs[m], procs[m]) if p == me) for m in held)
    everyone = set(mesh.processes.flat)
    if all(set(procs[m]) == everyone for m in range(size)):
        return None, devices
    shared = [m for m in range(size) if len(set(procs[m])) > 1]
    if shared:
        raise NotImplementedError(f"model indices {shared} of {mesh!r} have positions in several processes, but "
                                  "not in every one: a block copied across some processes is not ported (put the "
                                  "model axis first, or give every process positions at every model index)")
    return tuple(held), devices


def split_blocks(t: torch.Tensor, dim: int, devices: Sequence[torch.device],
                 indices: Optional[Sequence[int]] = None, size: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """``t`` cut along ``dim`` into ``size`` equal blocks (JAX's blocks:
    block i holds [i * n / size, (i + 1) * n / size)), of which block
    ``indices[j]`` is copied into a new contiguous tensor on
    ``devices[j]``: no block is a view of ``t`` (a column view would carry
    the whole width as its row stride). By default every block, one a
    device (``size = len(devices)``)."""
    n = t.shape[dim]
    s = len(devices) if size is None else size
    if n % s:
        raise ValueError(f"dimension {dim} of a {tuple(t.shape)} weight is not divisible by the model axis size {s}")
    blocks = []
    for i, dev in zip(range(s) if indices is None else indices, devices):
        block = t.narrow(dim, i * (n // s), n // s)
        blocks.append(torch.empty(block.shape, dtype=t.dtype, device=dev).copy_(block))
    return tuple(blocks)


def gather_columns(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The merge of a column-parallel product: the shards' outputs
    concatenated on their last dim on ``device``, in shard order."""
    return torch.cat([p.to(device) for p in parts], dim=-1)


def sum_partials(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The merge of a row-parallel product: the shards' partial products
    summed on ``device``, in shard order."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def gather_processes(t: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Every process's ``t`` concatenated along ``axis`` in process order,
    on t's device (``distributed.all_gather_cols``; the other dims must
    agree). On a model axis that spans processes, process order is
    position order: the owners of the positions never decrease."""
    moved = t.movedim(axis, -1)
    flat = distributed.all_gather_cols(moved.reshape(-1, moved.shape[-1]))
    return flat.reshape(*moved.shape[:-1], flat.shape[-1]).movedim(-1, axis)


def sharded_matmul(inp: torch.Tensor, w: Sharded, dot, bias: Optional[Sharded] = None) -> torch.Tensor:
    """[..., in] @ a ``Sharded`` weight, merged on inp's device:
    ``dot(x, shard, bias_block)`` runs once per shard on the shard's device
    (current there: the kernels' C entries launch on the current device).
    A column split gives each shard its block of ``bias`` (a ``Sharded`` of
    the same columns, or None) and gathers the outputs; a row split gives
    each shard its block of inp's last dim and sums the partial products
    (a row split's bias is whole: the caller adds it once to the sum).
    Every step is differentiable, so the backward runs per shard too.
    Across processes (``w.indices``) the outputs of this process's shards
    are gathered with every other process's (``gather_processes``), and a
    row split sums every shard's partial product, in shard order, on every
    process: the sum of one process's mesh, bit for bit (no
    ``all_reduce``, whose association is the library's). That merge is not
    differentiable."""
    parts = []
    for i, (shard, dev) in enumerate(zip(w.shards, w.devices)):
        x = inp
        if w.dim == "row":
            k = shard.shape[-2]
            x = inp[..., w.position(i) * k:(w.position(i) + 1) * k]
        with on_device(dev):
            parts.append(dot(x.to(dev), shard, None if bias is None else bias.shards[i]))
    if w.indices is None:
        return gather_columns(parts, inp.device) if w.dim == "col" else sum_partials(parts, inp.device)
    merged = gather_processes(gather_columns(parts, inp.device))
    if w.dim == "col":
        return merged
    return sum_partials(merged.split(parts[0].shape[-1], dim=-1), inp.device)


def merge_blocks(w: Sharded, device: torch.device) -> Any:
    """The whole weight of a ``Sharded`` leaf on ``device``: its blocks
    concatenated along the split dim (field by field for quantized
    shards), the inverse of ``split_blocks``; across processes with every
    other process's blocks (``gather_processes``), so any process can
    write the whole weight."""
    axis = -1 if w.dim == "col" else -2

    def cat(blocks):
        local = torch.cat([b.to(device) for b in blocks], dim=axis)
        return local if w.indices is None else gather_processes(local, axis).contiguous()

    if isinstance(w.shards[0], tuple):
        return type(w.shards[0])(*(cat(fields) for fields in zip(*w.shards)))
    return cat(w.shards)


# ------------------------------------------------------- the ``data`` axis
def split_batch(batch: Dict[str, torch.Tensor], mesh: Mesh) -> List[Dict[str, torch.Tensor]]:
    """``batch``'s leading dim over the mesh's ``data`` axis, as JAX's
    ``P("data", None)`` places it: part d holds rows [d * B / dp,
    (d + 1) * B / dp) on the device of data index d (position 0 of every
    other axis). A mesh without the axis gives one part, the whole batch on
    the first device (JAX's replicated batch); a batch the axis does not
    divide raises."""
    one_process(mesh, "a batch split over the data axis")
    dp = mesh.shape.get("data", 1)
    rows = {int(t.shape[0]) for t in batch.values()}
    if len(rows) != 1:
        raise ValueError(f"the batch's tensors disagree on their leading dim: {sorted(rows)}")
    b = rows.pop()
    if b % dp:
        raise ValueError(f"a batch of {b} rows is not divisible by the data axis size {dp}")
    n = b // dp
    return [{k: t[d * n:(d + 1) * n].to(mesh.at(data=d)) for k, t in batch.items()} for d in range(dp)]


def data_replica(tree: Any, mesh: Mesh, d: int) -> Any:
    """``tree`` (dicts, lists and tuples of tensors and ``Sharded`` leaves)
    on the devices of data index ``d``: a whole tensor on
    ``mesh.at(data=d)``, block m of a ``Sharded`` leaf on ``mesh.at(data=d,
    model=m)``. The copies are differentiable, so gradients of the replica
    flow back into the masters and add up there. The masters live at data
    index 0 (``shard_params`` puts them there), so index 0 is ``tree``
    itself."""
    if d == 0:
        return tree
    tp = mesh.shape.get("model", 1)
    devices = tuple(mesh.at(data=d, model=m) for m in range(tp))
    first = mesh.at(data=d)

    def rep(x):
        if isinstance(x, dict):
            return {k: rep(v) for k, v in x.items()}
        if isinstance(x, list):
            return [rep(v) for v in x]
        if isinstance(x, Sharded):
            return dataclasses.replace(x, shards=tuple(rep_on(s, dev) for s, dev in zip(x.shards, devices)),
                                       devices=devices)
        if isinstance(x, tuple):
            values = [rep(v) for v in x]
            return type(x)(*values) if hasattr(x, "_fields") else tuple(values)
        return x.to(first) if isinstance(x, torch.Tensor) else x

    def rep_on(s, dev):
        return type(s)(*(t.to(dev) for t in s)) if isinstance(s, tuple) else s.to(dev)

    return rep(tree)
