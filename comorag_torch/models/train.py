"""Contrastive retrieval training for the encoder (InfoNCE, in-batch
negatives).

Port of ``comorag_tpu/models/train.py``: the same loss, the same AdamW
(learning rate, decay and decay mask), the same ``TrainState`` and
``step(state, batch) -> (state, loss)`` contract, in PyTorch's idiom:

  - ``TrainState.opt_state`` is the ``torch.optim.AdamW`` that owns the
    parameters, and a step updates them in place (JAX returns new arrays);
    ``make_optimizer`` returns the function that builds it from the
    parameters, as optax's ``optimizer.init(params)`` builds its state;
  - optax computes ``p - lr * (adam + wd * p)``, torch
    ``p * (1 - lr * wd) - lr * adam``: the same arithmetic in another order;
  - checkpoints are ``torch.save`` files of whole parameters and Adam
    moments by tree name and the step (orbax is a JAX library);
  - the forward takes the encoder's plain path: the Hopper kernels have no
    backward, as JAX's Pallas kernels have no VJP.

With a mesh (``mesh=``) the step is JAX's global step over a ``data`` x
``model`` mesh in one process (``parallel/mesh.py``): the weights split
over ``model`` (``bge.shard_params``: each block a parameter of its own,
so the optimizer's moments live with their block, as JAX's
``_shard_opt_like`` gives them the parameters' shardings), the batch over
``data`` (``split_batch``), each part running on a differentiable replica
of the parameters (``data_replica``). The parts' pooled rows meet on the
mesh's first device, the loss is taken over the global batch there (every
part's rows are negatives of every other's), and one backward sums each
replica's gradients into the masters (JAX's all-reduce) before one
``opt.step()``: on the same parameters and batch the result is the
unsharded step's up to fp32 summation order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple, Union

import torch

from comorag_torch.models.bge import Encoder, EncoderArch, encode_pooled, init_params, shard_params
from comorag_torch.parallel.mesh import Mesh, Sharded, data_replica, merge_blocks, mesh_device, split_batch


class TrainState(NamedTuple):
    params: Any                     # bge.Encoder, or the decoder's dict of tensors
    opt_state: torch.optim.Optimizer
    step: int


def info_nce(q: torch.Tensor, p: torch.Tensor, temperature: float) -> torch.Tensor:
    """Symmetric InfoNCE of pooled [B, H] queries and passages: row i's
    positive is passage i, every other row of the batch a negative."""
    logits = torch.matmul(q, p.T) / temperature  # fp32: encode_pooled returns fp32
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss_qp = torch.nn.functional.cross_entropy(logits, labels)
    loss_pq = torch.nn.functional.cross_entropy(logits.T, labels)
    return 0.5 * (loss_qp + loss_pq)


def contrastive_loss(
    params: Encoder,
    batch: Dict[str, torch.Tensor],
    arch: EncoderArch,
    temperature: float = 0.05,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives. batch keys:
    q_ids/q_mask/p_ids/p_mask, each [B, S]."""
    del arch  # the Encoder carries it; kept for the JAX signature
    q = encode_pooled(params, batch["q_ids"], batch["q_mask"], compute_dtype)
    p = encode_pooled(params, batch["p_ids"], batch["p_mask"], compute_dtype)
    return info_nce(q, p, temperature)


def whole_leaves(params) -> Iterator[Tuple[str, Any]]:
    """(name, leaf) of every parameter of the tree, in order: a tensor, or
    the ``Sharded`` of a weight split over a ``model`` axis. Encoder names
    are ``named_parameters()``'s (``layers.<i>.<name>``), decoder names the
    dict path."""
    if isinstance(params, Encoder):
        tree = params.leaves()
        yield from tree.embed.items()
        for i, layer in enumerate(tree.layers):
            for name, leaf in layer.items():
                yield f"layers.{i}.{name}", leaf
        return

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, dict):
                yield from walk(value, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", value

    yield from walk(params, "")


def named_leaves(params) -> Iterator[Tuple[str, torch.Tensor, int]]:
    """(name, tensor, ndim in the JAX tree) of every parameter tensor; a
    split weight gives one entry per block (``<name>.<block>``, as
    ``named_parameters()`` names them), each with the JAX ndim of its whole
    leaf. The JAX encoder stacks each layer tensor on a leading [L] axis,
    so a port layer tensor counts one dimension more; the decoder's tree is
    stacked in both packages."""
    stacked = isinstance(params, Encoder)
    for name, leaf in whole_leaves(params):
        extra = 1 if stacked and name.startswith("layers.") else 0
        if isinstance(leaf, Sharded):
            for i, block in enumerate(leaf.shards):
                yield f"{name}.{i}", block, block.dim() + extra
        else:
            yield name, leaf, leaf.dim() + extra


def make_optimizer(learning_rate: float = 2e-5, weight_decay: float = 0.01
                   ) -> Callable[[Any], torch.optim.Optimizer]:
    """AdamW (optax's defaults: b1 0.9, b2 0.999, eps 1e-8) with JAX's
    decay mask, ``ndim >= 2`` over the JAX tree: every encoder layer tensor
    (LayerNorm scales and biases too, as they are [L, H] there) and the
    three embedding tables decay; the embedding LayerNorm and the decoder's
    ``final_norm`` do not. Returns the function that builds the optimizer
    over a parameter set (the blocks of a split weight, each on its device)
    and turns its gradients on."""

    def build(params) -> torch.optim.Optimizer:
        decay, no_decay = [], []
        for _, p, jax_ndim in named_leaves(params):
            p.requires_grad_(True)
            (decay if jax_ndim >= 2 else no_decay).append(p)
        groups = [{"params": decay, "weight_decay": weight_decay},
                  {"params": no_decay, "weight_decay": 0.0}]
        return torch.optim.AdamW(groups, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    return build


def create_train_state(arch: EncoderArch, generator: torch.Generator, optimizer=None,
                       device: Union[str, torch.device, None] = None, mesh: Optional[Mesh] = None) -> TrainState:
    """Random fp32 parameters (``bge.init_params``) on ``device`` ("cuda"
    when None; the mesh's first device under a mesh, the weights split
    over its ``model`` axis by ``bge.shard_params``) with a fresh optimizer
    at step 0."""
    params = init_params(arch, generator, mesh_device(mesh, device))
    if mesh is not None:
        params = shard_params(params, mesh)
    return TrainState(params, (optimizer or make_optimizer())(params), 0)


def make_step(loss_fn: Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor]):
    """``step(state, batch) -> (state, loss)``: one backward of ``loss_fn``
    and one in-place update by the state's optimizer."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, torch.Tensor]:
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, batch)
        loss.backward()
        opt.step()
        return TrainState(state.params, opt, state.step + 1), loss.detach()

    return step


def make_train_step(
    arch: EncoderArch,
    temperature: float = 0.05,
    compute_dtype: torch.dtype = torch.float32,
    mesh: Optional[Mesh] = None,
):
    """The training step. The update is the state's own optimizer (built
    by ``make_optimizer``), so the step takes no optimizer of its own.
    With a mesh the state's parameters must be split over it
    (``create_train_state(mesh=)`` or ``bge.shard_params``); the batch may
    sit anywhere and is split over the ``data`` axis, which must divide it."""
    if mesh is None:
        return make_step(lambda params, batch: contrastive_loss(params, batch, arch, temperature, compute_dtype))

    def loss_fn(params: Encoder, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        tree = params.leaves()
        q: List[torch.Tensor] = []
        p: List[torch.Tensor] = []
        for d, part in enumerate(split_batch(batch, mesh)):
            replica = data_replica(tree, mesh, d)
            q.append(encode_pooled(replica, part["q_ids"], part["q_mask"], compute_dtype).to(mesh.device))
            p.append(encode_pooled(replica, part["p_ids"], part["p_mask"], compute_dtype).to(mesh.device))
        return info_nce(torch.cat(q), torch.cat(p), temperature)

    return make_step(loss_fn)


# -------------------------------------------------------------- checkpoints
def _whole(leaf, device: torch.device) -> torch.Tensor:
    return merge_blocks(leaf, device) if isinstance(leaf, Sharded) else leaf.detach().to(device)


def _blocks(leaf) -> Tuple[torch.Tensor, ...]:
    return leaf.shards if isinstance(leaf, Sharded) else (leaf,)


def _like(leaf, blocks) -> Any:
    """Tensors of a parameter's blocks (its Adam moments) split as it is."""
    return dataclasses.replace(leaf, shards=tuple(blocks)) if isinstance(leaf, Sharded) else blocks[0]


def _pieces(leaf, whole: torch.Tensor) -> List[torch.Tensor]:
    """``whole`` cut as ``leaf`` is split, each piece a tensor of its own."""
    if not isinstance(leaf, Sharded):
        return [whole]
    return [c.clone(memory_format=torch.contiguous_format)
            for c in torch.chunk(whole, len(leaf.shards), dim=-1 if leaf.dim == "col" else -2)]


# the file's layout: whole tensors by tree name, moments keyed as the
# parameters (an older file held the optimizer's own state_dict, keyed by
# position, and is refused rather than restored without its moments)
CHECKPOINT_FORMAT = "whole-by-name"


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write a TrainState with torch.save: the parameters and their Adam
    moments as whole tensors by tree name (a split weight's blocks
    concatenated, as orbax writes global arrays) and the step, so the file
    loads into a state of either layout."""
    cpu = torch.device("cpu")
    opt = state.opt_state
    params, moments = {}, {}
    with torch.no_grad():
        for name, leaf in whole_leaves(state.params):
            params[name] = _whole(leaf, cpu)
            states = [opt.state.get(b) for b in _blocks(leaf)]
            if states[0]:  # Adam's state appears at the first step
                moments[name] = {key: _whole(_like(leaf, [s[key] for s in states]), cpu) if value.dim() else value.cpu()
                                 for key, value in states[0].items()}
    torch.save({"format": CHECKPOINT_FORMAT, "params": params, "opt_state": moments, "step": int(state.step)}, path)


def load_checkpoint(path: str, state_like: TrainState) -> TrainState:
    """Restore a TrainState saved by ``save_checkpoint`` into ``state_like``
    (e.g. a fresh ``create_train_state``, split over a mesh or not), which
    supplies the structure, the devices and the optimizer with its
    hyperparameters; its tensors are overwritten in place."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if saved.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"{path}: not a {CHECKPOINT_FORMAT!r} checkpoint (format {saved.get('format')!r}); "
                         "files written before the mesh steps keep the optimizer's state_dict and do not load")
    ours = dict(whole_leaves(state_like.params))
    if set(ours) != set(saved["params"]):
        raise ValueError(f"checkpoint tree differs: {sorted(set(ours) ^ set(saved['params']))[:5]}")
    opt = state_like.opt_state
    index = {id(p): i for i, p in enumerate(p for group in opt.param_groups for p in group["params"])}
    opt_state = opt.state_dict()
    opt_state["state"] = {}
    with torch.no_grad():
        for name, leaf in ours.items():
            blocks = _blocks(leaf)
            for block, piece in zip(blocks, _pieces(leaf, saved["params"][name])):
                block.copy_(piece)
            for key, value in saved["opt_state"].get(name, {}).items():
                # the step count: a tensor per block (AdamW increments each in place)
                pieces = [value.clone() for _ in blocks] if value.dim() == 0 else _pieces(leaf, value)
                for block, piece in zip(blocks, pieces):
                    opt_state["state"].setdefault(index[id(block)], {})[key] = piece
    opt.load_state_dict(opt_state)
    return TrainState(state_like.params, opt, int(saved["step"]))
