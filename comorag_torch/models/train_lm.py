"""Causal-LM finetuning for the offline generation engine
(models/decoder.py): next-token cross-entropy, mirroring the encoder's
contrastive step (models/train.py).

Port of ``comorag_tpu/models/train_lm.py``: the same loss (causal and
valid mask, targets where both neighbours are valid, the optional
completion-only ``loss_mask``) and the same per-layer recomputation
(``remat``), on the decoder's cache-free training route
(``decoder_forward(cache=None)``). The state and the step follow
``models.train``: AdamW with JAX's decay mask, updated in place. The
sharded step (``mesh=``) is not ported (ROADMAP queue 1, item 6c).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from comorag_torch.models.decoder import DecoderArch, decoder_forward, init_params
from comorag_torch.models.train import TrainState, check_mesh, make_optimizer, make_step


def lm_loss(
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],  # ids: [B, S] int, mask: [B, S]
    arch: DecoderArch,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = True,
) -> torch.Tensor:
    """Mean next-token cross-entropy over valid (non-pad) target positions."""
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
    return torch.sum(ce * target_mask) / torch.clamp(torch.sum(target_mask), min=1.0)


def create_lm_train_state(arch: DecoderArch, generator: torch.Generator, optimizer=None,
                          device: Union[str, torch.device] = "cuda") -> TrainState:
    """Random fp32 parameters (``decoder.init_params``; the generator lives
    on ``device``) with a fresh optimizer at step 0."""
    params = init_params(arch, generator, device)
    return TrainState(params, (optimizer or make_optimizer())(params), 0)


def make_lm_train_step(
    arch: DecoderArch,
    compute_dtype: torch.dtype = torch.float32,
    mesh=None,
):
    """The LM training step: ``step(state, batch) -> (state, loss)``, the
    state's optimizer updating its parameters in place."""
    check_mesh(mesh)
    return make_step(lambda params, batch: lm_loss(params, batch, arch, compute_dtype))
