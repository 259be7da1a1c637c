"""Causal-LM finetuning for the offline generation engine
(models/decoder.py): next-token cross-entropy, mirroring the encoder's
contrastive step (models/train.py).

Port of ``comorag_tpu/models/train_lm.py``: the same loss (causal and
valid mask, targets where both neighbours are valid, the optional
completion-only ``loss_mask``) and the same per-layer recomputation
(``remat``), on the decoder's cache-free training route
(``decoder_forward(cache=None)``). The state and the step follow
``models.train``: AdamW with JAX's decay mask, updated in place. With a
mesh (``mesh=``) the step is the encoder's (``models.train``): the weights
split over ``model`` (``decoder.shard_params``), the batch over ``data``,
each part's summed cross-entropy and target count brought to the mesh's
first device, so the loss is the global batch's mean, as JAX's
``lm_loss`` takes it under its sharded jit.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from comorag_torch.models.decoder import DecoderArch, decoder_forward, init_params, shard_params
from comorag_torch.models.train import TrainState, make_optimizer, make_step
from comorag_torch.parallel.mesh import Mesh, data_replica, mesh_device, one_process, split_batch


def lm_loss_terms(
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],  # ids: [B, S] int, mask: [B, S]
    arch: DecoderArch,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The next-token cross-entropy summed over the counted target
    positions, and their count (fp32 scalars)."""
    ids, mask = batch["ids"], batch["mask"]
    b, s = ids.shape
    valid = mask.to(torch.bool)
    positions = torch.arange(s, device=ids.device)[None, :].expand(b, s)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=ids.device))
    attn = causal[None, :, :] & valid[:, None, :]
    logits, _ = decoder_forward(params, ids, positions, attn, None, 0, arch, compute_dtype, remat=remat)
    targets = ids[:, 1:].to(torch.int64)
    target_mask = (valid[:, :-1] & valid[:, 1:]).to(torch.float32)
    # optional completion-only loss (the curriculum trainer): loss_mask
    # marks TARGET tokens that count
    if "loss_mask" in batch:
        target_mask = target_mask * batch["loss_mask"][:, 1:].to(torch.float32)
    ce = torch.nn.functional.cross_entropy(logits[:, :-1].flatten(0, 1), targets.flatten(),
                                           reduction="none").view(b, s - 1)
    return torch.sum(ce * target_mask), torch.sum(target_mask)


def lm_loss(
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],  # ids: [B, S] int, mask: [B, S]
    arch: DecoderArch,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = True,
) -> torch.Tensor:
    """Mean next-token cross-entropy over valid (non-pad) target positions."""
    total, count = lm_loss_terms(params, batch, arch, compute_dtype, remat)
    return total / torch.clamp(count, min=1.0)


def create_lm_train_state(arch: DecoderArch, generator: torch.Generator, optimizer=None,
                          device: Union[str, torch.device, None] = None,
                          mesh: Optional[Mesh] = None) -> TrainState:
    """Random fp32 parameters (``decoder.init_params``, drawn on the
    generator's device: the CPU or ``device``) on ``device`` ("cuda" when
    None; the mesh's first device under a mesh, where
    ``decoder.shard_params`` splits the weights over its ``model`` axis)
    with a fresh optimizer at step 0. A mesh that spans processes raises
    (dp x tp training runs on one process's meshes)."""
    one_process(mesh, "the decoder's training (dp x tp)")
    params = init_params(arch, generator, mesh_device(mesh, device))
    if mesh is not None:
        params = shard_params(params, mesh)
    return TrainState(params, (optimizer or make_optimizer())(params), 0)


def mesh_lm_loss(
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    arch: DecoderArch,
    mesh: Mesh,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = True,
) -> torch.Tensor:
    """``lm_loss`` of the global batch over a mesh: each ``data`` part on
    its replica of the (split) parameters, its summed cross-entropy and
    target count brought to the mesh's first device, and their quotient
    taken there."""
    totals, counts = [], []
    for d, part in enumerate(split_batch(batch, mesh)):
        total, count = lm_loss_terms(data_replica(params, mesh, d), part, arch, compute_dtype, remat)
        totals.append(total.to(mesh.device))
        counts.append(count.to(mesh.device))
    return torch.stack(totals).sum() / torch.clamp(torch.stack(counts).sum(), min=1.0)


def make_lm_train_step(
    arch: DecoderArch,
    compute_dtype: torch.dtype = torch.float32,
    mesh: Optional[Mesh] = None,
):
    """The LM training step: ``step(state, batch) -> (state, loss)``, the
    state's optimizer updating its parameters in place. With a mesh the
    state's parameters must be split over it (``create_lm_train_state(
    mesh=)`` or ``decoder.shard_params``), and the ``data`` axis must
    divide the batch."""
    if mesh is None:
        return make_step(lambda params, batch: lm_loss(params, batch, arch, compute_dtype))
    return make_step(lambda params, batch: mesh_lm_loss(params, batch, arch, mesh, compute_dtype))
