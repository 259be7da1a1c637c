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
  - checkpoints are ``torch.save`` files of the parameters, the optimizer
    state and the step (orbax is a JAX library);
  - the forward takes the encoder's plain path: the Hopper kernels have no
    backward, as JAX's Pallas kernels have no VJP.

The sharded step (``mesh=``) is not ported (ROADMAP queue 1, item 6c).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, NamedTuple, Tuple, Union

import torch

from comorag_torch.device import MESH_NOT_PORTED
from comorag_torch.models.bge import Encoder, EncoderArch, encode_pooled, init_params


class TrainState(NamedTuple):
    params: Any                     # bge.Encoder, or the decoder's dict of tensors
    opt_state: torch.optim.Optimizer
    step: int


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
    logits = torch.matmul(q, p.T) / temperature  # fp32: encode_pooled returns fp32
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss_qp = torch.nn.functional.cross_entropy(logits, labels)
    loss_pq = torch.nn.functional.cross_entropy(logits.T, labels)
    return 0.5 * (loss_qp + loss_pq)


def named_leaves(params) -> Iterator[Tuple[str, torch.Tensor, int]]:
    """(name, tensor, ndim in the JAX tree) of every parameter. The JAX
    encoder stacks each layer tensor on a leading [L] axis, so a port layer
    tensor counts one dimension more; the decoder's tree is stacked in both
    packages."""
    if isinstance(params, Encoder):
        for name, p in params.named_parameters():
            yield name, p, p.dim() + (1 if name.startswith("layers.") else 0)
        return

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, dict):
                yield from walk(value, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", value, value.dim()

    yield from walk(params, "")


def make_optimizer(learning_rate: float = 2e-5, weight_decay: float = 0.01
                   ) -> Callable[[Any], torch.optim.Optimizer]:
    """AdamW (optax's defaults: b1 0.9, b2 0.999, eps 1e-8) with JAX's
    decay mask, ``ndim >= 2`` over the JAX tree: every encoder layer tensor
    (LayerNorm scales and biases too, as they are [L, H] there) and the
    three embedding tables decay; the embedding LayerNorm and the decoder's
    ``final_norm`` do not. Returns the function that builds the optimizer
    over a parameter set and turns its gradients on."""

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
                       device: Union[str, torch.device] = "cuda") -> TrainState:
    """Random fp32 parameters (``bge.init_params``) on ``device`` with a
    fresh optimizer at step 0."""
    params = init_params(arch, generator, device)
    return TrainState(params, (optimizer or make_optimizer())(params), 0)


def check_mesh(mesh, what: str = "mesh") -> None:
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED.format(what=what))


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
    mesh=None,
):
    """The training step. The update is the state's own optimizer (built
    by ``make_optimizer``), so the step takes no optimizer of its own."""
    check_mesh(mesh)
    return make_step(lambda params, batch: contrastive_loss(params, batch, arch, temperature, compute_dtype))


def _params_state(params) -> Dict[str, torch.Tensor]:
    return {name: p.detach() for name, p, _ in named_leaves(params)}


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write a TrainState (parameters, optimizer state, step) with torch.save."""
    torch.save({"params": _params_state(state.params), "opt_state": state.opt_state.state_dict(),
                "step": int(state.step)}, path)


def load_checkpoint(path: str, state_like: TrainState) -> TrainState:
    """Restore a TrainState saved by ``save_checkpoint`` into ``state_like``
    (e.g. a fresh ``create_train_state``), which supplies the structure,
    the device and the optimizer; its tensors are overwritten in place."""
    ours = _params_state(state_like.params)
    saved = torch.load(path, map_location=next(iter(ours.values())).device, weights_only=True)
    if set(ours) != set(saved["params"]):
        raise ValueError(f"checkpoint tree differs: {sorted(set(ours) ^ set(saved['params']))[:5]}")
    with torch.no_grad():
        for name, p in ours.items():
            p.copy_(saved["params"][name])
    state_like.opt_state.load_state_dict(saved["opt_state"])
    return TrainState(state_like.params, state_like.opt_state, int(saved["step"]))
