"""Llama-class decoder-only LM in PyTorch: the in-process generation model.

Port of ``comorag_tpu/models/decoder.py``: the same architecture knobs,
parameter tree ([L, ...] stacked weights; fused [q|k|v] and [gate|up]
columns), quantized weight kinds, KV caches, left-padded batched
generation, guided-JSON token masking, prefix caching, chunked prefill and
self-speculative decoding. What changes with the framework:

  - the layer stack is a Python loop over the stacked weights and the KV
    cache is updated IN PLACE (JAX threads it through ``lax.scan``);
  - the decode loops are host loops that stop once every row is done (one
    host sync per step), with the same step counts as JAX's while_loops;
  - random numbers come from a ``torch.Generator`` (Gumbel-max sampling),
    so sampled tokens differ from ``jax.random``'s; greedy decoding is
    identical;
  - int4 weights (``Int4Weight``) follow the TPU route: every product goes
    to ``ops.int4.int4_matmul`` at every M, and a decode-sized layer takes
    ``ops.int4.int4_fused_layer_tail`` where ``fused_tail_supported``
    holds. The wrappers launch the Hopper kernels for CUDA tensors and run
    their plain versions for CPU tensors;
  - tensor parallelism (``shard_params``, JAX's ``param_shardings``): a
    weight split over the mesh's ``model`` axis is a
    ``parallel.mesh.Sharded`` leaf, and activations, the KV cache and
    attention stay whole on the first device, where products merge. An
    int4 column split whose shards all lie on that device (a mesh of one
    card) or on cards it may read (distinct cards with peer access, read
    over NVLink) is one ``int4_matmul`` call over the shards, read in
    place, where the kernel takes its blocks (``product_route``), and a
    decode-sized layer's o / gate-up / down take the fused tail over them
    (``tail_route``), as JAX launches both kernels once over gathered
    shards; every other product runs once per shard on the shard's device
    (a shard on a card the first device may not read, blocks the kernel
    refuses, float and int8 weights). Over a ``model``
    axis that spans processes each process holds its own blocks alone; it runs the same routes over them and
    merges the products with the other processes' (``sharded_matmul``),
    and computes the activations, the KV cache, attention and the whole
    leaves itself, so every process holds the same logits and draws the
    same tokens (JAX's replicated activations). The fused tail takes the
    per-product route there: its o / gate-up / down columns lie in several
    processes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint

from comorag_torch.device import resolve_device
from comorag_torch.ops import int4 as int4_ops
from comorag_torch.parallel.mesh import (Mesh, Sharded, gather_processes, merge_blocks, model_part, sharded_matmul,
                                         split_blocks)


@dataclasses.dataclass(frozen=True)
class DecoderArch:
    vocab_size: int = 32000
    hidden_size: int = 2048
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int = 16
    intermediate_size: int = 5632
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    qkv_bias: bool = False  # qwen2-class: bias on the fused [q|k|v] output
    # ("llama3", factor, low_freq_factor, high_freq_factor, orig_max_pos) or ("linear", factor)
    rope_scaling: Optional[Tuple] = None
    qk_norm: bool = False  # qwen3-class: per-head RMSNorm on q and k before RoPE
    head_dim_override: Optional[int] = None
    embed_scale: bool = False  # gemma-class: embeddings times sqrt(hidden)
    rms_unit_offset: bool = False  # gemma-class: RMSNorm applies (1 + w)
    mlp_act: str = "silu"  # "silu" | "gelu_tanh" | "gelu"

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, vocab_size: int = 259) -> "DecoderArch":
        """Byte-vocab test shape (259 = ByteTokenizer vocab)."""
        return cls(vocab_size=vocab_size, hidden_size=64, num_layers=2, num_heads=4,
                   num_kv_heads=2, intermediate_size=128, max_seq_len=512)


class QuantWeight(NamedTuple):
    """Symmetric int8 weight with per-output-channel fp32 scales."""

    q: torch.Tensor      # [..., in, out] int8
    scale: torch.Tensor  # [..., 1, out] fp32


class Int4Weight(NamedTuple):
    """Nibble-packed int4 weight with per-(input-group, out-channel) fp32
    scales, in ``ops.int4``'s (and the JAX package's) layout."""

    packed: torch.Tensor  # [..., in/2, out] int8
    scale: torch.Tensor   # [..., in/group_size, out] fp32


# ------------------------------------------------------------------- params
def init_params(arch: DecoderArch, generator: torch.Generator, device: Union[str, torch.device] = "cuda",
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random weights (std 0.02, norms ones) in ``dtype``, drawn from
    ``generator`` on its own device one tensor at a time and placed on
    ``device`` (a CUDA generator and bf16 build an 8B-parameter tree on the
    card without a host copy; a CPU generator gives one seed the same
    weights on every device). The draws differ from ``jax.random``'s:
    parity tests convert JAX's tree instead (``params_from_jax``)."""
    device = resolve_device(device)
    h, i, l = arch.hidden_size, arch.intermediate_size, arch.num_layers
    q_dim = arch.num_heads * arch.head_dim
    kv_dim = arch.num_kv_heads * arch.head_dim

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=generator.device, dtype=dtype).mul_(0.02).to(device)

    def ones(*shape):
        return torch.ones(*shape, device=device, dtype=dtype)

    params: Dict[str, Any] = {
        "embed": normal(arch.vocab_size, h),
        "layers": {
            "attn_norm": ones(l, h),
            "qkv_w": normal(l, h, q_dim + 2 * kv_dim),
            "o_w": normal(l, q_dim, h),
            "ffn_norm": ones(l, h),
            "gateup_w": normal(l, h, 2 * i),
            "down_w": normal(l, i, h),
        },
        "final_norm": ones(h),
    }
    if arch.qkv_bias:
        params["layers"]["qkv_b"] = normal(l, q_dim + 2 * kv_dim)
    if arch.qk_norm:
        params["layers"]["q_norm"] = ones(l, arch.head_dim)
        params["layers"]["k_norm"] = ones(l, arch.head_dim)
    if not arch.tie_embeddings:
        params["lm_head"] = normal(h, arch.vocab_size)
    return params


def params_from_jax(tree: Any, device: Union[str, torch.device] = "cuda") -> Any:
    """The JAX package's parameter tree (its leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``, or a checkpoint's numpy tree)
    as the port's: dicts stay dicts, arrays become tensors on ``device``,
    and JAX ``QuantWeight`` / ``Int4Weight`` leaves (recognized by their
    fields) become the port's, packed bytes and scales unchanged."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    fields = getattr(tree, "_fields", None)
    if fields == ("packed", "scale"):
        return Int4Weight(*(params_from_jax(v, device) for v in tree))
    if fields == ("q", "scale"):
        return QuantWeight(*(params_from_jax(v, device) for v in tree))
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.from_numpy(np.array(tree)).to(device)


def map_weights(params: Dict[str, Any], fn) -> Dict[str, Any]:
    """``fn`` applied to every tensor of the tree (quantized leaves whole)."""
    if isinstance(params, dict):
        return {k: map_weights(v, fn) for k, v in params.items()}
    return fn(params)


def _quantize(w: torch.Tensor) -> QuantWeight:
    """Per-output-channel symmetric int8, computed on w's device."""
    arr = w.to(torch.float32)
    amax = arr.abs().amax(dim=-2, keepdim=True)
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(arr / scale), -127, 127).to(torch.int8)
    return QuantWeight(q, scale)


def _per_layer(w: torch.Tensor, fn):
    """``fn`` on each [in, out] layer of a stacked [L, in, out] weight (one
    fp32 temporary at a time), stacked back."""
    if w.dim() == 2:
        return fn(w)
    parts = [fn(w[li]) for li in range(w.shape[0])]
    return type(parts[0])(*(torch.stack(field) for field in zip(*parts)))


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """int8-quantize every matmul weight (qkv/o/gateup/down, lm_head);
    embeddings and norms stay float."""
    out = {
        "embed": params["embed"],
        "layers": {name: (_per_layer(w, _quantize) if name.endswith("_w") else w)
                   for name, w in params["layers"].items()},
        "final_norm": params["final_norm"],
    }
    if "lm_head" in params:
        out["lm_head"] = _per_layer(params["lm_head"], _quantize)
    return out


def _quantize_int4(w: torch.Tensor, group_size: int = 128) -> Int4Weight:
    """Group-quantize one [in, out] or [L, in, out] weight on its device."""
    d_in = w.shape[-2]
    gs = group_size
    while gs > 2 and d_in % gs:
        gs //= 2  # tiny test archs: shrink to an aligned (even) group
    return _per_layer(w, lambda m: Int4Weight(*int4_ops.quantize_int4_grouped(m, gs)))


def quantize_params_int4(params: Dict[str, Any], group_size: int = 128) -> Dict[str, Any]:
    """int4-quantize every matmul weight; embeddings and norms stay float."""
    out = {
        "embed": params["embed"],
        "layers": {name: (_quantize_int4(w, group_size) if name.endswith("_w") else w)
                   for name, w in params["layers"].items()},
        "final_norm": params["final_norm"],
    }
    if "lm_head" in params:
        out["lm_head"] = _quantize_int4(params["lm_head"], group_size)
    return out


def shard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The tree split over ``mesh``'s ``model`` axis as JAX's
    ``param_shardings`` (decoder.py:133-223) splits it, the leaf kinds
    standing for its ``quantized`` flag:
      - float and int8 weights: ``qkv_w``, ``gateup_w`` (and ``qkv_b``, added
        on each shard's columns as JAX adds it) on their output columns, ``o_w`` and ``down_w`` on their input rows;
        an int8 weight's scale goes with ``q`` on a column split and stays
        whole on a row split (applied to the summed product);
      - int4 weights: every product on its output columns, packed bytes and
        grouped scales together, unless the width does not divide the axis
        (``_int4_col``: the tiny model's 259-token head), which stays whole;
      - embeddings, norms and a float or int8 ``lm_head``: whole.
    A split leaf is a ``Sharded`` of JAX's contiguous blocks, one per
    device along the axis; a whole leaf lives once, on the mesh's first
    device (JAX's replicas compute the same values, so the port keeps
    none). A mesh without the axis splits nothing. Over a ``model`` axis
    that spans processes every process passes the same whole tree and
    keeps its own blocks alone (``parallel.mesh.model_part``), and the
    whole leaves on its own first device."""
    merge = mesh.device
    size = mesh.shape.get("model", 1)
    indices, devices = model_part(mesh)

    def whole(w):
        return type(w)(*(t.to(merge) for t in w)) if isinstance(w, tuple) else w.to(merge)

    def split(w, dim: str):
        if size < 2:
            return whole(w)
        axis = -1 if dim == "col" else -2

        def blocks(t):
            return split_blocks(t, axis, devices, indices, size)

        if isinstance(w, tuple):
            shards = tuple(type(w)(*parts) for parts in zip(*(blocks(t) for t in w)))
        else:
            shards = blocks(w)
        return Sharded(shards, dim, devices, indices)

    def weight(w, dim: str):
        if isinstance(w, Int4Weight):  # column-parallel where the width divides the axis
            return split(w, "col") if w.packed.shape[-1] % size == 0 else whole(w)
        if isinstance(w, QuantWeight) and dim == "row":
            return QuantWeight(split(w.q, "row"), whole(w.scale))
        return split(w, dim)

    splits = {"qkv_w": "col", "gateup_w": "col", "o_w": "row", "down_w": "row"}
    layers = {name: (weight(w, splits[name]) if name in splits else split(w, "col") if name == "qkv_b" else whole(w))
              for name, w in params["layers"].items()}
    out = {"embed": whole(params["embed"]), "layers": layers, "final_norm": whole(params["final_norm"])}
    if "lm_head" in params:
        head = params["lm_head"]
        out["lm_head"] = weight(head, "col") if isinstance(head, Int4Weight) else whole(head)
    return out


def unshard_params(params: Dict[str, Any], device: Union[str, torch.device]) -> Dict[str, Any]:
    """The inverse of ``shard_params``: every ``Sharded`` leaf's blocks
    concatenated on ``device`` (``parallel.mesh.merge_blocks``; across
    processes with the other processes' blocks, so every process must call
    it), every whole leaf moved there; detached, as a serving engine or a
    checkpoint takes them."""
    device = resolve_device(device)

    def whole(w):
        if isinstance(w, dict):
            return {k: whole(v) for k, v in w.items()}
        if isinstance(w, Sharded):
            return merge_blocks(w, device)
        if isinstance(w, tuple):
            return type(w)(*(whole(t) for t in w))
        return w.detach().to(device)

    with torch.no_grad():
        return whole(params)


# ------------------------------------------------------------------ forward
def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, unit_offset: bool = False) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    if unit_offset:
        return (normed * (1.0 + scale.to(torch.float32))).to(x.dtype)
    return normed.to(x.dtype) * scale.to(x.dtype)


def _rope_inv_freq(hd: int, theta: float, scaling: Optional[Tuple], device=None) -> torch.Tensor:
    """Per-channel inverse frequencies with HF-style "linear" / "llama3"
    rescaling, in fp32 as the JAX package computes them."""
    exps = torch.arange(0, hd // 2, dtype=torch.float32, device=device) * 2.0 / hd
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)
    if scaling is None:
        return freqs
    kind = scaling[0]
    if kind == "linear":
        return freqs / float(scaling[1])
    if kind == "llama3":
        _, factor, low_ff, high_ff, orig_max = scaling
        low_wavelen = orig_max / low_ff
        high_wavelen = orig_max / high_ff
        wavelen = 2.0 * math.pi / freqs
        smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
        smoothed = (1.0 - smooth) * freqs / factor + smooth * freqs
        out = torch.where(wavelen > low_wavelen, freqs / factor, freqs)
        mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        return torch.where(mid, smoothed, out)
    raise ValueError(f"unsupported rope_scaling kind: {kind!r}")


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
          scaling: Optional[Tuple] = None) -> torch.Tensor:
    """HF-convention rotary embedding (half-split rotate). x: [B, S, heads,
    head_dim]; positions: [B, S]."""
    hd = x.shape[-1]
    freqs = _rope_inv_freq(hd, theta, scaling, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _int4_dot(inp: torch.Tensor, packed, scale, compute_dtype: torch.dtype) -> torch.Tensor:
    """[..., in] @ an int4 weight -> [..., out] in compute_dtype, through
    one ``int4_matmul`` call at every M (the TPU route); the weight is an
    ``Int4Weight``'s (packed, scale) or the lists of its column blocks'."""
    first = (packed, scale) if isinstance(packed, torch.Tensor) else (packed[0], scale[0])
    lead = inp.shape[:-1]
    out = int4_ops.int4_matmul(inp.reshape(-1, inp.shape[-1]), packed, scale, int4_ops.group_size_of(*first))
    return out.reshape(*lead, out.shape[-1]).to(compute_dtype)


# The two routes of a ``Sharded`` int4 product (``product_route``)
BLOCKS = "blocks"
PER_SHARD = "per_shard"


def _column_blocks(w, device: torch.device):
    """The lists of a ``Sharded`` int4 column leaf's packed and scale
    shards when every shard lies on ``device`` or on a card a kernel there
    may read (``int4.peer_readable``: a ``model`` axis on one card, or over
    distinct cards with peer access; across processes, this process's
    shards): the kernels read them in place. None for any other leaf."""
    if (isinstance(w, Sharded) and w.dim == "col" and all(isinstance(sh, Int4Weight) for sh in w.shards)
            and all(int4_ops.peer_readable(device, d) for d in w.devices)):
        return [sh.packed for sh in w.shards], [sh.scale for sh in w.shards]
    return None


def product_route(w, m: int, device: torch.device) -> str:
    """The route of a ``Sharded`` product of m (= batch x chunk) rows
    merged on ``device``:
      - ``BLOCKS``: one ``int4_matmul`` call on ``device`` over the column
        shards read in place, where w is an int4 column split whose shards
        all lie on ``device`` or on cards it may read
        (``int4.peer_readable``: distinct cards with peer access, read over
        NVLink) and ``int4_matmul_blocks_supported`` holds at m (the JAX
        package's one launch a product);
      - ``PER_SHARD``: ``sharded_matmul``, one product a shard on its
        device, merged on ``device``: a shard on a card ``device`` may not
        read (decided here, before any launch), blocks the kernel refuses
        (off the 16-column block unit of its split-K and wgmma routes, more
        than ``TAIL_MAX_BLOCKS`` = 8), float and int8 weights, row splits.
    Over ``{"model": 8}`` every product of Llama-3.1-8B (qkv 768 columns a
    shard, o and down 512, gate/up 3,584, the head 16,032) and of
    Qwen2.5-7B (qkv 576, o and down 448, gate/up 4,736, the head 19,008)
    takes ``BLOCKS`` at every m: a block's last tile is ragged where its
    width is off a tile.
    Over a model axis that spans processes both routes run over this
    process's shards, and the outputs are then gathered from every
    process."""
    return PER_SHARD if _product_blocks(w, m, device) is None else BLOCKS


def _product_blocks(w, m: int, device: torch.device):
    """w's ``_column_blocks`` where ``int4_matmul`` takes them at m rows
    (``product_route``'s ``BLOCKS``); None where it takes the per-shard
    route."""
    blocks = _column_blocks(w, device)
    if blocks is not None and int4_ops.int4_matmul_blocks_supported(m, [p.shape[-1] for p in blocks[0]]):
        return blocks
    return None


def _dot(inp: torch.Tensor, w, compute_dtype: torch.dtype, bias=None) -> torch.Tensor:
    """[..., in] @ w (+ ``bias``, split as w's columns under a model axis)."""
    if isinstance(w, Sharded):
        blocks = _product_blocks(w, inp.numel() // inp.shape[-1], inp.device)  # product_route's BLOCKS
        if blocks is not None:
            out = _int4_dot(inp, *blocks, compute_dtype)
            if bias is not None:  # this process's bias blocks, on its own columns
                out = out + torch.cat([b.to(inp.device) for b in bias.shards], dim=-1).to(compute_dtype)
            return out if w.indices is None else gather_processes(out)
        return sharded_matmul(inp, w, lambda x, shard, b: _dot(x, shard, compute_dtype, b), bias)
    if bias is not None:
        return _dot(inp, w, compute_dtype) + bias.to(compute_dtype)
    if isinstance(w, Int4Weight):
        return _int4_dot(inp, w.packed, w.scale, compute_dtype)
    if isinstance(w, QuantWeight):
        out = _dot(inp, w.q, compute_dtype)  # a row split's q: the scale goes on the summed product
        return out * w.scale.to(compute_dtype)
    return torch.matmul(inp.to(compute_dtype), w.to(compute_dtype))


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, T, kv_heads, head_dim]
    v: torch.Tensor

    @classmethod
    def zeros(cls, arch: DecoderArch, batch: int, max_len: int, dtype=torch.float32, device="cuda"):
        shape = (arch.num_layers, batch, max_len, arch.num_kv_heads, arch.head_dim)
        device = resolve_device(device)
        return cls(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))


class QuantKVCache(NamedTuple):
    """int8 KV cache with per-(token, head) symmetric scales (the engine's
    ``kv_dtype="int8"``)."""

    k: torch.Tensor        # [L, B, T, kv_heads, head_dim] int8
    v: torch.Tensor
    k_scale: torch.Tensor  # [L, B, T, kv_heads] f32
    v_scale: torch.Tensor

    @classmethod
    def zeros(cls, arch: DecoderArch, batch: int, max_len: int, dtype=None, device="cuda"):
        shape = (arch.num_layers, batch, max_len, arch.num_kv_heads, arch.head_dim)
        device = resolve_device(device)
        return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                   torch.zeros(shape[:-1], dtype=torch.float32, device=device))


def _quant_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8: x [B, S, kvh, hd] -> (q, scale [B, S, kvh])."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def _is_int8_kv(kv_dtype) -> bool:
    return kv_dtype in ("int8", torch.int8)


def make_kv_cache(arch: DecoderArch, batch: int, max_len: int, compute_dtype, kv_dtype=None, device="cuda"):
    if _is_int8_kv(kv_dtype):
        return QuantKVCache.zeros(arch, batch, max_len, device=device)
    return KVCache.zeros(arch, batch, max_len, compute_dtype, device)


def _write(dst: torch.Tensor, li: int, src: torch.Tensor, write_index) -> None:
    """dst[li, :, slots] = src in place; write_index is a slot (int) or a
    [B] tensor of per-row slot starts (speculative decode)."""
    s = src.shape[1]
    if isinstance(write_index, int):
        dst[li, :, write_index:write_index + s] = src.to(dst.dtype)
    else:
        rows = torch.arange(src.shape[0], device=dst.device)[:, None]
        cols = write_index[:, None] + torch.arange(s, device=dst.device)[None, :]
        dst[li, rows, cols] = src.to(dst.dtype)


def _layer_qkv(x: torch.Tensor, layer: Dict[str, Any], positions: torch.Tensor, arch: DecoderArch,
               cd: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer's attention norm, fused [q|k|v] product, qk-norm and RoPE:
    q [B, S, heads, hd], k and v [B, S, kv_heads, hd]."""
    b, s = x.shape[:2]
    heads, kv_heads, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    q_dim, kv_dim = heads * hd, kv_heads * hd
    xn = _rms_norm(x, layer["attn_norm"], arch.rms_norm_eps, arch.rms_unit_offset)
    qkv = _dot(xn, layer["qkv_w"], cd, layer["qkv_b"] if arch.qkv_bias else None)
    q = qkv[..., :q_dim].reshape(b, s, heads, hd)
    k = qkv[..., q_dim:q_dim + kv_dim].reshape(b, s, kv_heads, hd)
    v = qkv[..., q_dim + kv_dim:].reshape(b, s, kv_heads, hd)
    if arch.qk_norm:
        q = _rms_norm(q, layer["q_norm"], arch.rms_norm_eps)
        k = _rms_norm(k, layer["k_norm"], arch.rms_norm_eps)
    q = _rope(q, positions, arch.rope_theta, arch.rope_scaling)
    k = _rope(k, positions, arch.rope_theta, arch.rope_scaling)
    return q, k, v


# The two routes of a layer's o / gate-up / down half (``tail_route``)
FUSED_TAIL = "fused_tail"
PER_PRODUCT = "per_product"
_TAIL_WEIGHTS = ("o_w", "gateup_w", "down_w")


def _tail_blocks(w, device: torch.device):
    """An o / gate-up / down leaf as the fused tail reads it: the (packed,
    scale) of a whole int4 weight, or its column shards' lists, each shard
    on ``device`` or on a card a kernel there may read
    (``_column_blocks``); None for any other leaf, and for
    shards of an axis that spans processes (the tail would need the
    others' columns)."""
    if isinstance(w, Sharded) and w.indices is not None:
        return None
    return (w.packed, w.scale) if isinstance(w, Int4Weight) else _column_blocks(w, device)


def _tail_weights(layer: Dict[str, Any], arch: DecoderArch, m: int, device: torch.device):
    """(the o, gate-up and down weights as ``_tail_blocks`` gives them, the
    group size) where a layer of m tokens merged on ``device`` takes the
    fused tail; None where it takes the per-product route."""
    weights = [_tail_blocks(layer[name], device) for name in _TAIL_WEIGHTS]
    if any(w is None for w in weights):
        return None
    packed, scale = (t if isinstance(t, torch.Tensor) else t[0] for t in weights[0])
    gs = int4_ops.group_size_of(packed, scale)
    blocks = max(1 if isinstance(p, torch.Tensor) else len(p) for p, _ in weights)
    if not int4_ops.fused_tail_supported(arch.hidden_size, arch.intermediate_size, gs, m, blocks=blocks):
        return None
    return weights, gs


def _layer_at(layers: Dict[str, Any], li: int) -> Dict[str, Any]:
    """Layer ``li`` of the stacked [L, ...] tree (views; a ``Sharded`` leaf
    indexes every shard)."""
    return {name: (type(w)(*(t[li] for t in w)) if isinstance(w, tuple) else w[li]) for name, w in layers.items()}


def tail_route(params: Dict[str, Any], arch: DecoderArch, m: int) -> str:
    """The route of the layers' o / gate-up / down half in a forward of m
    (= batch x chunk) tokens:
      - ``FUSED_TAIL``: one ``int4_fused_layer_tail`` launch a layer on the
        merge device, where o_w, gateup_w and down_w are int4,
        ``fused_tail_supported`` holds at m (at most ``TAIL_MAX_BLOCKS`` =
        8 shards, o and down shards each a multiple of 16 columns, gate/up
        of 128: Llama-3.1-8B's 512 and Qwen2.5-7B's 448 o / down columns
        over ``{"model": 8}`` among them), and each is whole or a column split
        of this process whose shards lie on the merge device or on cards
        it may read (``int4.peer_readable``: a ``model`` axis on one card,
        or over distinct cards with peer access): the kernel reads every
        shard in place, a peer card's over NVLink;
      - ``PER_PRODUCT``: each product on its own (under a model axis, by
        ``product_route``), with the residuals, RMSNorm and activation in
        PyTorch between them: float and int8 weights, prefill sizes (m >
        64), more than ``TAIL_MAX_BLOCKS`` shards, a shard on a card
        without peer access from the
        merge device (decided here, before any launch, from
        ``torch.cuda.can_device_access_peer``) and a model axis that spans
        processes (the o / gate-up / down columns lie in several
        processes)."""
    layer = _layer_at(params["layers"], 0)
    return PER_PRODUCT if _tail_weights(layer, arch, m, params["embed"].device) is None else FUSED_TAIL


def _product_launches(w, m: int, device: torch.device) -> int:
    if not isinstance(w, Sharded) or product_route(w, m, device) == BLOCKS:
        return 1
    return len(w.shards)


def int4_forward_launches(params: Dict[str, Any], arch: DecoderArch, m: int, head_m: int) -> Tuple[int, int]:
    """(``int4_matmul``, fused tail) launches of one forward of m tokens on
    int4 weights whose head takes head_m rows, as ``tail_route`` and
    ``product_route`` route them: a whole weight or a ``BLOCKS`` split
    once, a ``PER_SHARD`` split once a shard (this process's shards: the
    launches this process makes). Over ``{"model": 2}``, 4 or 8, on one
    card or on distinct cards with peer access, at Llama-3.1-8B width a
    decode forward makes (33, 32): qkv once a layer and the head once
    over its shards (over 8, eight 16,032-column shards on split-K's
    16-column unit), the tail once a layer; a prefill forward whose head
    takes the last position's rows (129, 0): JAX's launches. At
    Qwen2.5-7B width over ``{"model": 8}`` a decode forward makes (29,
    28), JAX's, the tail over o / down shards of 448 columns; a prefill
    forward (113, 0), JAX's too: qkv's 576 and o / down's 448 columns
    run once over their blocks on wgmma, each block's last tile
    ragged."""
    device, layer = params["embed"].device, params["layers"]
    tail = tail_route(params, arch, m) == FUSED_TAIL
    names = ("qkv_w",) if tail else ("qkv_w", "o_w", "gateup_w", "down_w")
    per_layer = sum(_product_launches(layer[name], m, device) for name in names)
    return arch.num_layers * per_layer + _product_launches(params["lm_head"], head_m, device), arch.num_layers * tail


def _layer_rest(x: torch.Tensor, layer: Dict[str, Any], q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, mask_bias: torch.Tensor, arch: DecoderArch, cd: torch.dtype,
                k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rest of one layer: attention of q over T keys and values
    ([B, T, kv_heads, hd], in the compute dtype or int8 with per-(token,
    head) scales [B, T, kv_heads]), the output product and residual, and
    the FFN half with its residual. Returns the new x."""
    b, s = x.shape[:2]
    heads, kv_heads, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    groups = heads // kv_heads
    q_dim, i_dim = heads * hd, arch.intermediate_size

    # GQA in kv-head layout; scores as an fp32 product of compute-dtype
    # operands (exact products, fp32 sums: JAX's preferred_element_type)
    qg = q.reshape(b, s, kv_heads, groups, hd)
    scores = torch.einsum("bskgd,btkd->bskgt", qg.to(torch.float32), k_cache.to(torch.float32))
    if k_scale is not None:
        scores = scores * k_scale.permute(0, 2, 1)[:, None, :, None, :]
    scores = scores / math.sqrt(float(hd)) + mask_bias
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, None, :, None, :]
    ctx = torch.einsum("bskgt,btkd->bskgd", probs.to(cd), v_cache)

    tail = _tail_weights(layer, arch, b * s, x.device)  # tail_route's FUSED_TAIL
    if tail is not None:
        (o, gu, down), gs4 = tail
        return int4_ops.int4_fused_layer_tail(
            ctx.reshape(b * s, q_dim), x.reshape(b * s, arch.hidden_size), layer["ffn_norm"], *o, *gu, *down,
            group_size=gs4, eps=float(arch.rms_norm_eps), unit_offset=bool(arch.rms_unit_offset),
            act=arch.mlp_act,
        ).reshape(b, s, arch.hidden_size).to(cd)
    x = x + _dot(ctx.reshape(b, s, q_dim), layer["o_w"], cd)
    xn = _rms_norm(x, layer["ffn_norm"], arch.rms_norm_eps, arch.rms_unit_offset)
    gu = _dot(xn, layer["gateup_w"], cd)
    return x + _dot(int4_ops.activation(gu[..., :i_dim], arch.mlp_act) * gu[..., i_dim:], layer["down_w"], cd)


def _own_kv_layer(x: torch.Tensor, layer: Dict[str, Any], positions: torch.Tensor, mask_bias: torch.Tensor,
                  arch: DecoderArch, cd: torch.dtype) -> torch.Tensor:
    """One layer attending to the chunk's own keys and values (no cache):
    the training route, where every tensor autograd saves is the layer's
    own."""
    q, k, v = _layer_qkv(x, layer, positions, arch, cd)
    return _layer_rest(x, layer, q, k, v, mask_bias, arch, cd)


def decoder_forward(
    params: Dict[str, Any],
    input_ids: torch.Tensor,   # [B, S] int
    positions: torch.Tensor,   # [B, S] int (RoPE position per token)
    attn_mask: torch.Tensor,   # [B, S, T] bool: query token -> cache slot visibility
    cache,                     # KVCache | QuantKVCache, updated IN PLACE; None: no cache (T = S)
    write_index,               # int slot OR [B] tensor of per-row slots
    arch: DecoderArch,
    compute_dtype: torch.dtype = torch.float32,
    last_only: bool = False,   # logits for the final position only ([B, 1, V])
    remat: bool = False,       # recompute each layer in the backward (cache=None only)
):
    """One forward chunk (prefill S=P or decode S=1) against a KV cache of
    T slots: writes the chunk's keys and values at ``write_index`` (in
    place) and returns (logits [B, S, V] f32, cache).

    ``cache=None`` is the training route: each layer attends to the
    chunk's own keys and values (what JAX's ``lm_loss`` gets from a fresh
    cache of S slots written at 0), so autograd saves no view of a tensor
    that a later layer writes. ``remat=True`` wraps each layer in
    ``torch.utils.checkpoint`` (``jax.checkpoint`` at decoder.py:658-662):
    the backward recomputes one layer at a time instead of keeping every
    layer's [B, S, heads, S] scores.

    Products and roundings are the JAX package's: matmuls in the compute
    dtype, attention scores and softmax in fp32, logits in fp32 (with a
    bf16 float head the logits are the bf16 product's, widened)."""
    if remat and cache is not None:
        raise ValueError("remat=True needs cache=None (the cache path writes the cache in place)")
    cd = compute_dtype
    layers = params["layers"]

    x = params["embed"][input_ids].to(cd)
    if arch.embed_scale:
        x = x * torch.tensor(arch.hidden_size ** 0.5, dtype=cd)
    mask_bias = torch.where(attn_mask, 0.0, -1e30).to(torch.float32)[:, :, None, None, :]  # [B,S,1,1,T]
    quant_kv = isinstance(cache, QuantKVCache)

    for li in range(arch.num_layers):
        layer = _layer_at(layers, li)
        if cache is None:
            if remat:
                # reentrant: the layer recomputes inside its own backward node,
                # once, whichever of autograd's per-device threads reaches it
                # (the non-reentrant checkpoint raced between them on a layer
                # split over distinct cards)
                x = torch.utils.checkpoint.checkpoint(_own_kv_layer, x, layer, positions, mask_bias, arch, cd,
                                                      use_reentrant=True)
            else:
                x = _own_kv_layer(x, layer, positions, mask_bias, arch, cd)
            continue
        q, k, v = _layer_qkv(x, layer, positions, arch, cd)
        if quant_kv:
            k_w, k_s = _quant_kv(k)
            v_w, v_s = _quant_kv(v)
            _write(cache.k, li, k_w, write_index)
            _write(cache.v, li, v_w, write_index)
            _write(cache.k_scale, li, k_s, write_index)
            _write(cache.v_scale, li, v_s, write_index)
            x = _layer_rest(x, layer, q, cache.k[li].to(cd), cache.v[li].to(cd), mask_bias, arch, cd,
                            cache.k_scale[li], cache.v_scale[li])
        else:
            _write(cache.k, li, k, write_index)
            _write(cache.v, li, v, write_index)
            x = _layer_rest(x, layer, q, cache.k[li].to(cd), cache.v[li].to(cd), mask_bias, arch, cd)

    x = _rms_norm(x, params["final_norm"], arch.rms_norm_eps, arch.rms_unit_offset)
    if last_only:
        x = x[:, -1:, :]
    head = params["embed"].T if arch.tie_embeddings else params["lm_head"]
    if isinstance(head, (Int4Weight, Sharded)):  # shard_params splits an int4 head only
        logits = _dot(x, head, torch.float32)
    elif isinstance(head, QuantWeight):
        logits = torch.matmul(x.to(cd), head.q.to(cd)).to(torch.float32) * head.scale
    else:
        logits = torch.matmul(x.to(cd), head.to(cd)).to(torch.float32)
    return logits, cache


# ----------------------------------------------------------------- generate
# Prefill query-chunk width: bounds the live [B, heads, C, total] score slab.
_PREFILL_CHUNK = 512


class GenerateResult(NamedTuple):
    tokens: torch.Tensor   # [B, max_new_tokens] int64, pad_id after EOS
    lengths: torch.Tensor  # [B]: emitted tokens incl. EOS
    steps: int             # decode loop iterations taken


def _device_of(params) -> torch.device:
    return params["embed"].device


def prefill_prefix(params: Dict[str, Any], prefix_ids, arch: DecoderArch,
                   compute_dtype=torch.float32, kv_dtype=None):
    """Prefill a SHARED prompt prefix once at batch 1; the returned cache
    (T = P0 slots) broadcasts across a later batch via ``generate``'s
    ``prefix`` argument (prefix caching)."""
    dev = _device_of(params)
    ids = torch.as_tensor(prefix_ids, device=dev).long().reshape(1, -1)
    p0 = ids.shape[1]
    positions = torch.arange(p0, device=dev)[None, :]
    attn = torch.tril(torch.ones(p0, p0, dtype=torch.bool, device=dev))[None]
    cache = make_kv_cache(arch, 1, p0, compute_dtype, kv_dtype, dev)
    bounds = list(range(0, p0, _PREFILL_CHUNK)) + [p0]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        decoder_forward(params, ids[:, lo:hi], positions[:, lo:hi], attn[:, lo:hi, :], cache, lo, arch,
                        compute_dtype, last_only=True)
    return cache


def _prefill_batch(params, input_ids, prompt_mask, arch, total: int, prefix, compute_dtype, kv_dtype=None):
    """Shared prompt prefill for both decode loops: builds the cache
    (broadcasting a shared-prefix cache into slots [0, p0)), prefills the
    prompts at slots [p0, p0+P), and returns (last_logits [B, V], cache,
    slot_valid [B, total], row_len [B])."""
    dev = input_ids.device
    b, p = input_ids.shape
    p0 = 0 if prefix is None else prefix.k.shape[2]
    if prefix is not None:
        expected = QuantKVCache if _is_int8_kv(kv_dtype) else KVCache
        assert type(prefix) is expected, (
            "prefix cache kind must match kv_dtype (rebuild the prefix cache: "
            f"got {type(prefix).__name__} for kv_dtype={kv_dtype!r})")

        def _place(src):
            out = torch.zeros((src.shape[0], b, total) + tuple(src.shape[3:]), dtype=src.dtype, device=dev)
            out[:, :, : src.shape[2]] = src
            return out

        cache = type(prefix)(*(_place(t) for t in prefix))
    else:
        cache = make_kv_cache(arch, b, total, compute_dtype, kv_dtype, dev)
    valid = prompt_mask.to(torch.bool)
    # per-row token positions directly after the shared prefix
    positions = p0 + torch.clamp(torch.cumsum(valid.to(torch.int64), dim=1) - 1, min=0)
    row_len = valid.to(torch.int64).sum(dim=1)
    causal = torch.tril(torch.ones(p, p, dtype=torch.bool, device=dev))
    attn = torch.zeros(b, p, total, dtype=torch.bool, device=dev)
    attn[:, :, p0:p0 + p] = causal[None, :, :] & valid[:, None, :]
    if p0:
        attn[:, :, :p0] = True
    bounds = list(range(0, p, _PREFILL_CHUNK)) + [p]
    for ci, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        logits, cache = decoder_forward(params, input_ids[:, lo:hi], positions[:, lo:hi], attn[:, lo:hi, :],
                                        cache, p0 + lo, arch, compute_dtype,
                                        last_only=ci == len(bounds) - 2)
    last_logits = logits[:, -1, :]
    slot_valid = torch.zeros(b, total, dtype=torch.bool, device=dev)
    slot_valid[:, p0:p0 + p] = valid
    if p0:
        slot_valid[:, :p0] = True
    return last_logits, cache, slot_valid, row_len


def _gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    e = -torch.log(u.clamp_min(1e-20))  # Exp(1) noise
    return -torch.log(e.clamp_min(1e-20))


def _masked(logits: torch.Tensor, token_table: Optional[torch.Tensor], state: torch.Tensor) -> torch.Tensor:
    if token_table is None:
        return logits
    return torch.where(token_table[state] >= 0, logits, torch.tensor(float("-inf"), device=logits.device))


def _step_cap(max_new_tokens: int, limit) -> int:
    return max_new_tokens if limit is None else min(int(limit), max_new_tokens)


def generate(
    params: Dict[str, Any],
    input_ids: torch.Tensor,    # [B, P], LEFT-padded with pad_id
    prompt_mask: torch.Tensor,  # [B, P], 1 on real prompt tokens
    arch: DecoderArch,
    max_new_tokens: int,
    eos_id: int,
    pad_id: int,
    temperature: float = 0.0,
    rng: Optional[torch.Generator] = None,
    token_table: Optional[torch.Tensor] = None,  # [S, V] DFA, -1 = forbidden
    limit: Optional[int] = None,                 # step cap <= max_new_tokens
    prefix=None,                                 # shared-prefix cache from prefill_prefix
    row_valid: Optional[torch.Tensor] = None,    # [B] bool: False = batch-pad row
    compute_dtype=torch.float32,
    kv_dtype=None,
) -> GenerateResult:
    """Batched constrained generation: prefill once, then single-token steps
    until every row has emitted EOS or the step cap is reached (the JAX
    package's while_loop, run as a host loop with one sync per step).
    ``token_table`` masks each step's logits to the DFA's allowed tokens
    and advances every row's automaton state; ``prefix`` shares a cached
    prompt header across the batch. Over a ``model`` axis that spans
    processes every process runs this loop in step with the others: each
    stop decision reads only the merged logits, the tokens drawn from them
    and ``rng`` (seeded alike in every process), which every process holds
    bit for bit, so none leaves the loop alone (the others would wait in
    the next merge)."""
    dev = input_ids.device
    b, p = input_ids.shape
    p0 = 0 if prefix is None else prefix.k.shape[2]
    base = p0 + p
    total = base + max_new_tokens
    logits, cache, slot_valid, row_len = _prefill_batch(
        params, input_ids, prompt_mask, arch, total, prefix, compute_dtype, kv_dtype)
    cap = _step_cap(max_new_tokens, limit)
    out = torch.full((b, max_new_tokens), pad_id, dtype=torch.int64, device=dev)
    done = (torch.zeros(b, dtype=torch.bool, device=dev) if row_valid is None
            else ~row_valid.to(device=dev, dtype=torch.bool))
    dfa = torch.zeros(b, dtype=torch.int64, device=dev)
    i = 0
    while i < cap and not bool(done.all()):
        lg = _masked(logits, token_table, dfa)
        if temperature > 0.0:
            lg = lg / temperature + _gumbel(lg.shape, rng, dev)
        tok = torch.argmax(lg, dim=-1)
        tok = torch.where(done, pad_id, tok)
        emitted = ~done
        done = done | (tok == eos_id)
        if token_table is not None:
            nxt = token_table[dfa, tok].to(torch.int64)
            dfa = torch.where(emitted, nxt.clamp_min(0), dfa)
        out[:, i] = torch.where(emitted, tok, pad_id)
        slot_valid[:, base + i] = emitted
        i += 1
        if i >= cap or bool(done.all()):
            break  # the loop ends here: the next step's logits are never read
        pos = (p0 + row_len + i - 1)[:, None]
        step_logits, cache = decoder_forward(params, tok[:, None], pos, slot_valid[:, None, :], cache,
                                             base + i - 1, arch, compute_dtype)
        logits = step_logits[:, 0, :]
    lengths = slot_valid[:, base:].to(torch.int64).sum(dim=1)
    return GenerateResult(out, lengths, i)


def generate_speculative(
    params: Dict[str, Any],
    input_ids: torch.Tensor,
    prompt_mask: torch.Tensor,
    arch: DecoderArch,
    max_new_tokens: int,
    eos_id: int,
    pad_id: int,
    draft_len: int = 7,
    token_table: Optional[torch.Tensor] = None,
    limit: Optional[int] = None,
    prefix=None,
    row_valid: Optional[torch.Tensor] = None,
    temperature: float = 0.0,
    rng: Optional[torch.Generator] = None,
    compute_dtype=torch.float32,
    kv_dtype=None,
) -> GenerateResult:
    """Self-speculative (prompt-lookup) decoding, as the JAX package's
    ``generate_speculative``: each step drafts ``draft_len`` tokens by
    continuing the most recent 2-gram match in the row's own history and
    verifies draft + bonus token in ONE forward chunk. Greedy output equals
    ``generate(temperature=0)``; at temperature > 0 verification is
    rejection sampling (a rejected draft's logit is carried as -inf into
    the next entry draw), so the committed sequence is distributed as
    sequential sampling. Its stop decisions, like ``generate``'s, read only
    values that every process of a model axis holds alike."""
    dev = input_ids.device
    b, p = input_ids.shape
    k_draft = int(draft_len)
    c = k_draft + 1
    p0 = 0 if prefix is None else prefix.k.shape[2]
    base = p0 + p
    total = base + max_new_tokens + c  # +c slack: the last step may write a full chunk past the cap
    last_logits, cache, slot_valid, row_len = _prefill_batch(
        params, input_ids, prompt_mask, arch, total, prefix, compute_dtype, kv_dtype)
    h = p + max_new_tokens
    hist = torch.zeros(b, h, dtype=torch.int64, device=dev)
    hist[:, :p] = input_ids
    cap = _step_cap(max_new_tokens, limit)
    sampling = temperature > 0.0
    neg_inf = torch.tensor(float("-inf"), device=dev)

    out = torch.full((b, max_new_tokens), pad_id, dtype=torch.int64, device=dev)
    done = (torch.zeros(b, dtype=torch.bool, device=dev) if row_valid is None
            else ~row_valid.to(device=dev, dtype=torch.bool))
    dfa = torch.zeros(b, dtype=torch.int64, device=dev)
    n_emit = torch.zeros(b, dtype=torch.int64, device=dev)
    pos_idx = torch.arange(h - 1, device=dev)
    uw = torch.arange(c, device=dev)[None, :]
    steps = 0
    while steps < cap and not bool(done.all()):
        live = ~done
        if sampling:
            lg = _masked(last_logits, token_table, dfa) / temperature
            tok0 = torch.argmax(lg + _gumbel(lg.shape, rng, dev), dim=-1)
        else:
            tok0 = torch.argmax(_masked(last_logits, token_table, dfa), dim=-1)

        # draft: continue the most recent (prev, tok0) 2-gram in the history
        hend = p + n_emit
        prev = torch.gather(hist, 1, (hend - 1)[:, None])[:, 0]
        in_range = (pos_idx[None, :] >= (p - row_len)[:, None]) & (pos_idx[None, :] + 1 < hend[:, None])
        m = (hist[:, :-1] == prev[:, None]) & (hist[:, 1:] == tok0[:, None]) & in_range
        score = torch.where(m, pos_idx[None, :] + 1, 0)
        jstar = torch.argmax(score, dim=1)  # most recent match (0 if none: a junk draft, rejected)
        didx = torch.clamp(jstar[:, None] + 2 + torch.arange(k_draft, device=dev)[None, :], 0, h - 1)
        draft = torch.gather(hist, 1, didx)
        chunk = torch.cat([tok0[:, None], draft], dim=1)
        chunk = torch.where(live[:, None], chunk, pad_id)

        # forward the chunk at per-row slots
        starts = base + n_emit
        pos = (p0 + row_len + n_emit)[:, None] + uw
        rel = torch.arange(total, device=dev)[None, None, :] - starts[:, None, None]
        attn = slot_valid[:, None, :] | ((rel >= 0) & (rel <= uw[:, :, None]))
        logits, cache = decoder_forward(params, chunk, pos, attn, cache, starts, arch, compute_dtype)

        # verify: DFA advanced along the chunk; the accepted prefix by
        # greedy equality (temperature 0) or rejection sampling
        states_after, greedy, pd = [], [], []
        s = dfa
        for u in range(c):
            if token_table is not None:
                s = token_table[s, chunk[:, u]].to(torch.int64).clamp_min(0)
            states_after.append(s)
            if sampling:
                if u < c - 1:
                    probs = torch.softmax(_masked(logits[:, u, :], token_table, s) / temperature, dim=-1)
                    pd.append(torch.gather(probs, 1, chunk[:, u + 1][:, None])[:, 0])
            else:
                greedy.append(torch.argmax(_masked(logits[:, u, :], token_table, s), dim=-1))
        states_after = torch.stack(states_after, 1)
        if sampling:
            accept_p = torch.stack(pd, dim=1)
            u01 = torch.rand(accept_p.shape, generator=rng, device=dev, dtype=torch.float32)
            match = (u01 < accept_p).to(torch.int64)
        else:
            greedy = torch.stack(greedy, dim=1)
            match = (chunk[:, 1:] == greedy[:, :-1]).to(torch.int64)
        n_acc = 1 + torch.cumprod(match, dim=1).sum(dim=1)
        n_acc0 = n_acc
        is_eos = chunk == eos_id
        first_eos = torch.where(is_eos & (uw < n_acc[:, None]), uw, c).min(dim=1).values
        n_acc = torch.minimum(n_acc, first_eos + 1)
        n_acc = torch.minimum(n_acc, cap - n_emit)
        n_acc = torch.where(live, n_acc, 0)
        acc = uw < n_acc[:, None]

        # commit the accepted tokens
        oidx = (n_emit[:, None] + uw)
        out_rows, out_cols = torch.nonzero(acc, as_tuple=True)
        out[out_rows, oidx[out_rows, out_cols]] = chunk[out_rows, out_cols]
        slot_valid[out_rows, (starts[:, None] + uw)[out_rows, out_cols]] = True
        hist[out_rows, ((p + n_emit)[:, None] + uw)[out_rows, out_cols]] = chunk[out_rows, out_cols]

        n_emit = n_emit + n_acc
        done = done | (acc & is_eos).any(dim=1) | (n_emit >= cap)
        last_idx = torch.clamp(n_acc - 1, 0, c - 1)
        if token_table is not None:
            dfa = torch.where(live, torch.gather(states_after, 1, last_idx[:, None])[:, 0], dfa)
        nxt = logits[torch.arange(b, device=dev), last_idx]
        if sampling:
            rejected = live & (n_acc0 < c) & (n_acc == n_acc0)
            rej_tok = torch.gather(chunk, 1, torch.clamp(n_acc, 0, c - 1)[:, None])[:, 0]
            excl = (torch.arange(nxt.shape[1], device=dev)[None, :] == rej_tok[:, None]) & rejected[:, None]
            nxt = torch.where(excl, neg_inf, nxt)
        last_logits = torch.where(live[:, None], nxt, last_logits)
        steps += 1
    return GenerateResult(out, n_emit, steps)


# ------------------------------------------------------- HF weight conversion
def load_hf_decoder_checkpoint(model_name_or_path: str, device: Union[str, torch.device] = "cuda"):
    """A local HuggingFace llama-, mistral-, qwen2-, qwen3- or gemma-family
    causal-LM checkpoint as (params, DecoderArch), with the JAX package's
    family detection and refusals. ``transformers`` is imported here only."""
    device = resolve_device(device)
    from transformers import AutoConfig, AutoModelForCausalLM

    hf_config = AutoConfig.from_pretrained(model_name_or_path)
    model = AutoModelForCausalLM.from_pretrained(model_name_or_path, torch_dtype=torch.float32)
    state = {k: v.detach().to(torch.float32).cpu() for k, v in model.state_dict().items()}
    del model

    qkv_bias = "model.layers.0.self_attn.q_proj.bias" in state
    model_type = getattr(hf_config, "model_type", "llama")
    supported = {"llama", "mistral", "qwen2", "qwen3", "gemma"}
    if model_type not in supported:
        raise ValueError(f"model_type {model_type!r} is not supported by the decoder "
                         f"(supported: {sorted(supported)})")
    is_gemma = model_type == "gemma"
    qk_norm = "model.layers.0.self_attn.q_norm.weight" in state
    sw = getattr(hf_config, "sliding_window", None)
    if sw and getattr(hf_config, "use_sliding_window", True) and sw < hf_config.max_position_embeddings:
        raise ValueError(f"active sliding_window={sw} (< max_position_embeddings="
                         f"{hf_config.max_position_embeddings}) is not supported by the decoder's "
                         "full-context attention")
    act = getattr(hf_config, "hidden_activation", None) or getattr(hf_config, "hidden_act", "silu")
    act_map = {"silu": "silu", "gelu_pytorch_tanh": "gelu_tanh", "gelu": "gelu"}
    if act not in act_map:
        raise ValueError(f"unsupported hidden activation {act!r}")
    hd_cfg = getattr(hf_config, "head_dim", None)
    default_hd = hf_config.hidden_size // hf_config.num_attention_heads
    head_dim_override = hd_cfg if hd_cfg and hd_cfg != default_hd else None
    rs = getattr(hf_config, "rope_scaling", None)
    rope_scaling = None
    if rs:
        kind = rs.get("rope_type", rs.get("type", "default"))
        if kind in ("default", None):
            rope_scaling = None
        elif kind == "linear":
            rope_scaling = ("linear", float(rs["factor"]))
        elif kind == "llama3":
            rope_scaling = ("llama3", float(rs["factor"]), float(rs["low_freq_factor"]),
                            float(rs["high_freq_factor"]), float(rs["original_max_position_embeddings"]))
        else:
            raise ValueError(f"rope_scaling type {kind!r} is not supported by the decoder "
                             "(supported: default, linear, llama3)")
    arch = DecoderArch(
        qkv_bias=qkv_bias,
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        intermediate_size=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        rope_scaling=rope_scaling,
        qk_norm=qk_norm,
        head_dim_override=head_dim_override,
        embed_scale=is_gemma,
        rms_unit_offset=is_gemma,
        mlp_act=act_map[act],
        rms_norm_eps=hf_config.rms_norm_eps,
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)),
    )
    prefix = "model.layers.{}."

    def stack(fmt, transpose=True):
        return torch.stack([state[fmt.format(i)].T if transpose else state[fmt.format(i)]
                            for i in range(arch.num_layers)]).contiguous().to(device)

    def stack_fused(*fmts):
        return torch.stack([torch.cat([state[f.format(i)].T for f in fmts], dim=-1)
                            for i in range(arch.num_layers)]).contiguous().to(device)

    params: Dict[str, Any] = {
        "embed": state["model.embed_tokens.weight"].to(device),
        "layers": {
            "attn_norm": stack(prefix + "input_layernorm.weight", transpose=False),
            "qkv_w": stack_fused(prefix + "self_attn.q_proj.weight", prefix + "self_attn.k_proj.weight",
                                 prefix + "self_attn.v_proj.weight"),
            "o_w": stack(prefix + "self_attn.o_proj.weight"),
            "ffn_norm": stack(prefix + "post_attention_layernorm.weight", transpose=False),
            "gateup_w": stack_fused(prefix + "mlp.gate_proj.weight", prefix + "mlp.up_proj.weight"),
            "down_w": stack(prefix + "mlp.down_proj.weight"),
        },
        "final_norm": state["model.norm.weight"].to(device),
    }
    if qkv_bias:
        params["layers"]["qkv_b"] = torch.stack([
            torch.cat([state[prefix.format(i) + f"self_attn.{p}_proj.bias"] for p in ("q", "k", "v")])
            for i in range(arch.num_layers)]).to(device)
    if qk_norm:
        params["layers"]["q_norm"] = stack(prefix + "self_attn.q_norm.weight", transpose=False)
        params["layers"]["k_norm"] = stack(prefix + "self_attn.k_norm.weight", transpose=False)
    if not arch.tie_embeddings:
        params["lm_head"] = state["lm_head.weight"].T.contiguous().to(device)
    return params, arch
