"""Driver entry points of the port (``__graft_entry__.py``'s counterpart).

- ``entry(device=None)``: the flagship model's single-device forward (the
  BGE-class retrieval encoder at bert-base width: transformer stack ->
  masked mean pool -> L2 norm) as ``(fn, example_args)``.
- ``dryrun_multichip(n, devices=None)``: the FULL contrastive training
  step over an n-position ``data x model`` mesh, then the causal-LM step,
  tensor-parallel int8 and int4 serving of its decoder, two more decoder
  families, a corpus-sharded index and an edge-sharded PPR graph, each
  once at tiny shapes, in the JAX function's order and with its checks.

Devices: a mesh position is a ``torch.device`` (``parallel/mesh.py``).
``devices=None`` places position i on ``cuda:(i % cards)``, so with n
cards or more the positions lie on n distinct cards, and with fewer they
share them round robin (each ``model`` axis then spans as many distinct
cards as it can). Without a card it raises: the CPU runs only when the
caller asks, ``devices=[torch.device("cpu")] * n``. JAX's respawn onto
virtual CPU devices has no counterpart.

    python -m comorag_torch.graft_entry

runs ``entry()``'s ``fn`` on the card, then ``dryrun_multichip`` over
every visible card (4 positions at least, sharing the cards).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from comorag_torch.device import resolve_device
from comorag_torch.llm.offline import TorchOfflineLLM
from comorag_torch.models import bge, decoder, train, train_lm
from comorag_torch.ops import attention, ffn, int4, mips
from comorag_torch.ops.ppr import PPRGraph
from comorag_torch.parallel.mesh import DeviceLike, Sharded, build_mesh
from comorag_torch.retrieval.index import MipsIndex

# __graft_entry__.py:29-36
ENTRY_ARCH = bge.EncoderArch(vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12,
                             intermediate_size=3072, max_position=512)
ENTRY_BATCH, ENTRY_SEQ = 8, 128
# num_heads / intermediate divisible by the model axis for clean TP splits (:151-157, :178-181)
DRYRUN_ENCODER = bge.EncoderArch(vocab_size=512, hidden_size=64, num_layers=2, num_heads=8,
                                 intermediate_size=128, max_position=64)
DRYRUN_DECODER = decoder.DecoderArch(vocab_size=259, hidden_size=64, num_layers=2, num_heads=8, num_kv_heads=4,
                                     intermediate_size=128, max_seq_len=128, qkv_bias=True)
KERNEL_COUNTERS = (attention.LAUNCHES, ffn.LAUNCHES, mips.LAUNCHES, mips.INT8_LAUNCHES, int4.LAUNCHES,
                   int4.TAIL_LAUNCHES)


def entry(device: Optional[DeviceLike] = None) -> Tuple[Any, Tuple[bge.Encoder, torch.Tensor, torch.Tensor]]:
    """Returns ``(fn, (model, input_ids, attention_mask))``: the encoder
    forward at bert-base width on ``device`` (the card when None), random
    weights from seed 0, ones ids and mask [8, 128]. ``fn`` runs without
    autograd, in fp32 on the plain attention (JAX's ``encode_pooled``
    defaults, which reach no Pallas kernel), and returns [8, 768] fp32
    unit rows."""
    device = resolve_device(device)
    model = bge.init_params(ENTRY_ARCH, torch.Generator().manual_seed(0), device)
    input_ids = torch.ones((ENTRY_BATCH, ENTRY_SEQ), dtype=torch.int64, device=device)
    attention_mask = torch.ones((ENTRY_BATCH, ENTRY_SEQ), dtype=torch.int64, device=device)

    @torch.no_grad()
    def fn(model, input_ids, attention_mask):
        return bge.encode_pooled(model, input_ids, attention_mask)

    return fn, (model, input_ids, attention_mask)


def _factor_mesh(n: int) -> dict:
    """Split n devices into data x model so BOTH axes are exercised when
    the device count allows (8 -> 2x4, 4 -> 2x2, 2 -> 1x2)."""
    if n % 8 == 0:
        return {"data": n // 4, "model": 4}
    if n % 4 == 0:
        return {"data": n // 2, "model": 2}
    if n % 2 == 0:
        return {"data": n // 2, "model": 2}
    return {"data": n, "model": 1}


def _positions(n: int, devices: Optional[Sequence[DeviceLike]] = None) -> List[torch.device]:
    """The device of each of n mesh positions: ``devices`` as given (n of
    them, else ValueError), or position i on ``cuda:(i % cards)`` (no card:
    RuntimeError, as ``build_mesh`` raises)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: devices=None means the visible CUDA cards, and "
                               "torch.cuda.is_available() is False; pass devices=[torch.device('cpu')] * n "
                               "to run on the CPU")
        cards = torch.cuda.device_count()
        return [torch.device("cuda", i % cards) for i in range(n)]
    devices = [resolve_device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"dryrun_multichip({n}) needs {n} devices, got {len(devices)}")
    return devices


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _launches() -> Dict[str, int]:
    return {c.name: c.value for c in KERNEL_COUNTERS}


def _split_over(w, tp: int, kind: type) -> bool:
    """Whether w is split over a model axis of tp positions (whole at
    tp = 1), each shard a ``kind`` whose first tensor is int8."""
    if tp == 1:
        return isinstance(w, kind) and w[0].dtype == torch.int8
    return (isinstance(w, Sharded) and len(w.shards) == tp
            and all(isinstance(s, kind) and s[0].dtype == torch.int8 for s in w.shards))


def dryrun_multichip(n_devices: int, devices: Optional[Sequence[DeviceLike]] = None) -> Dict[str, Any]:
    """One sharded training step on an n-position mesh (tiny shapes), then
    the rest of ``__graft_entry__.dryrun_multichip``'s sequence (:148-278)
    over the same positions; ``devices`` as ``_positions`` takes it.
    Each check raises AssertionError. Returns the losses, the serving and
    retrieval results, ``int4_matmul``'s launches beside the count
    ``decoder.product_route`` gives (equal on a card; the CPU launches
    none), the kernel launches of the two training steps (none) and each
    position's device."""
    positions = _positions(n_devices, devices)
    shape = _factor_mesh(n_devices)
    mesh = build_mesh(shape, positions)
    dev = mesh.device
    tp = shape["model"]

    arch = DRYRUN_ENCODER
    state = train.create_train_state(arch, torch.Generator().manual_seed(0), mesh=mesh)
    b = max(8, shape["data"] * 4)
    ones = torch.ones((b, 16), dtype=torch.int64, device=dev)
    before = _launches()
    state, loss = train.make_train_step(arch, mesh=mesh)(
        state, {"q_ids": ones, "q_mask": ones, "p_ids": ones, "p_mask": ones})
    loss_val = float(loss)
    _require(np.isfinite(loss_val), f"non-finite loss {loss_val}")

    # Decoder family: causal-LM train step (dp x tp) + tensor-parallel
    # constrained generation over the same mesh.
    dec_arch = DRYRUN_DECODER
    lm_state = train_lm.create_lm_train_state(dec_arch, torch.Generator().manual_seed(1), mesh=mesh)
    lm_state, lm_loss = train_lm.make_lm_train_step(dec_arch, mesh=mesh)(lm_state, {"ids": ones, "mask": ones})
    lm_loss_val = float(lm_loss)
    _require(np.isfinite(lm_loss_val), f"non-finite LM loss {lm_loss_val}")
    train_launches = {name: v - before[name] for name, v in _launches().items()}

    # int8 weights AND tensor parallelism together
    messages = [{"role": "user", "content": "dryrun"}]
    llm = TorchOfflineLLM(params=lm_state.params, arch=dec_arch, mesh=mesh, temperature=0.8, speculative=True,
                          param_dtype="int8")
    _require(_split_over(llm.params["layers"]["qkv_w"], tp, decoder.QuantWeight),
             "int8 decoder weights must shard over the TP axis")
    gen = llm.infer(messages, max_tokens=8, json_template="ner")
    _require(isinstance(gen.text, str), "no int8 text")
    # temperature=0 routes through the speculative (prompt-lookup) decode
    # loop: per-row scatter cache writes under the same TP split
    gen_spec = llm.infer(messages, max_tokens=8, json_template="ner", temperature=0)
    _require(gen_spec.metadata.get("decode_steps", 0) >= 1, f"no speculative decode step: {gen_spec.metadata}")

    # int4 nibble-packed weights under the same TP mesh (column-parallel,
    # packed bytes and grouped scales together)
    launched = int4.LAUNCHES.value
    llm4 = TorchOfflineLLM(params=lm_state.params, arch=dec_arch, mesh=mesh, param_dtype="int4")
    _require(_split_over(llm4.params["layers"]["qkv_w"], tp, decoder.Int4Weight),
             "int4 decoder weights must shard over the TP axis")
    gen4 = llm4.infer(messages, max_tokens=8)
    launched = int4.LAUNCHES.value - launched
    _require(isinstance(gen4.text, str), "no int4 text")
    per_forward = decoder.int4_forward_launches(llm4.params, dec_arch, 1, 1)[0]
    if dev.type == "cuda":
        expected = per_forward * gen4.metadata["decode_steps"]
        _require(launched == expected, f"int4 over the model axis launched int4_matmul {launched} times, "
                                       f"decoder.product_route gives {expected}")

    # Other decoder families over the same TP mesh: qwen3-class (per-head
    # qk-norm, head_dim decoupled from hidden/heads) and gemma-class
    # (scaled embeddings, (1+w) RMSNorm, tanh-GeLU, MQA).
    texts = {"int8": gen.text, "int8_speculative": gen_spec.text, "int4": gen4.text}
    for name, fam_arch in (
            ("qwen3", dataclasses.replace(dec_arch, qkv_bias=False, qk_norm=True, head_dim_override=16)),
            ("gemma", dataclasses.replace(dec_arch, qkv_bias=False, num_kv_heads=1, embed_scale=True,
                                          rms_unit_offset=True, mlp_act="gelu_tanh", tie_embeddings=True))):
        fam = TorchOfflineLLM(params=decoder.init_params(fam_arch, torch.Generator().manual_seed(2), dev),
                              arch=fam_arch, mesh=mesh)
        texts[name] = fam.infer(messages, max_tokens=4).text
        _require(isinstance(texts[name], str), f"no {name}-class text")

    # The inference-side shardings: corpus-sharded MIPS top-k (gathered on
    # the first device) and edge-sharded PPR (partial sums summed there).
    corpus_mesh = build_mesh({"corpus": n_devices}, positions)
    rng = np.random.default_rng(0)
    index = MipsIndex(rng.standard_normal((n_devices * 256, 32)).astype(np.float32), mesh=corpus_mesh)
    _require(index.mesh is not None, "corpus index failed to shard")
    # default-config ("auto") indexes serve the exact two-pass even sharded
    _require(index.scan_dtype == "int8", "sharded index should auto-select the two-pass scan")
    _, idx = index.topk(rng.standard_normal((4, 32)).astype(np.float32), k=8)
    # fused fact-linking fetch (top-k + row min, one packed transfer) sharded
    _, _, row_min = index.topk_min_async(rng.standard_normal((4, 32)).astype(np.float32), k=8).result()
    _require(np.isfinite(row_min).all(), "non-finite sharded row minima")
    src = np.arange(0, 64, dtype=np.int32)
    dst = (src + 1) % 64
    graph = PPRGraph(np.concatenate([src, dst]), np.concatenate([dst, src]), np.ones(128, np.float32), 64,
                     backend="device", mesh=corpus_mesh)
    scores = graph.query(np.ones(64, np.float32))
    _require(np.isfinite(scores).all(), "non-finite sharded PPR scores")

    placement = [str(d) for d in positions]
    distinct = len(set(placement))
    print(f"dryrun_multichip OK: mesh={shape}, loss={loss_val:.4f}, lm_loss={lm_loss_val:.4f}, "
          f"guided_gen={len(gen.text)}B, sharded-topk idx shape={np.asarray(idx).shape}, "
          f"sharded-ppr sum={scores.sum():.3f}, devices={placement} ({n_devices} positions on {distinct} "
          f"distinct device{'s' if distinct > 1 else ''})", flush=True)
    return {"mesh": shape, "loss": loss_val, "lm_loss": lm_loss_val, "train_launches": train_launches,
            "int8_text_bytes": len(gen.text), "speculative_decode_steps": gen_spec.metadata["decode_steps"],
            "int4_matmul_launches": launched, "int4_matmul_per_forward": per_forward,
            "int4_decode_steps": gen4.metadata["decode_steps"], "texts": texts,
            "topk_shape": list(np.asarray(idx).shape), "topk_ids": np.asarray(idx).tolist(),
            "ppr_sum": float(scores.sum()), "devices": placement}


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", tuple(out.shape))
    # at least 4 positions: the dry run's corpus of n x 256 rows takes the
    # auto two-pass it checks from 1,024 rows on, in JAX's function too
    dryrun_multichip(max(torch.cuda.device_count(), 4))
