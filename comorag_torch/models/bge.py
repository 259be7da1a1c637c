"""BGE-class text encoder in PyTorch.

Port of ``comorag_tpu/models/bge.py``: a BERT/XLM-R-family encoder whose
parameters keep the JAX package's names and [in, out] layout (so weights
convert without transposes, ``params_from_jax``), masked mean pooling, L2
normalization, and the same sequence bucketing and batch padding on the
host side.

On a CUDA device with bf16 compute, every layer runs the two hand-written
Hopper kernels, as the JAX encoder runs its two Pallas kernels on a TPU:
``ops.attention.encoder_attention`` and ``ops.ffn.encoder_ffn``. fp32
compute (the HF-parity contract) takes the plain path, as in JAX
(bge.py:455-462).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from comorag_torch.device import HostCopy, resolve_device
from comorag_torch.ops.attention import encoder_attention, encoder_attention_plain
from comorag_torch.ops.ffn import encoder_ffn, fused_ffn_supported, layer_norm
from comorag_torch.models.base import BaseEncoder


@dataclasses.dataclass(frozen=True)
class EncoderArch:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    position_offset: int = 0  # RoBERTa-family uses pad_token_id + 1

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "EncoderArch":
        return cls(vocab_size=vocab_size, hidden_size=64, num_layers=2, num_heads=4,
                   intermediate_size=128, max_position=128)


_LAYER_SHAPES = {
    "q_w": ("h", "h"), "q_b": ("h",), "k_w": ("h", "h"), "k_b": ("h",),
    "v_w": ("h", "h"), "v_b": ("h",), "o_w": ("h", "h"), "o_b": ("h",),
    "attn_ln_scale": ("h",), "attn_ln_bias": ("h",),
    "ffn_in_w": ("h", "i"), "ffn_in_b": ("i",), "ffn_out_w": ("i", "h"), "ffn_out_b": ("h",),
    "ffn_ln_scale": ("h",), "ffn_ln_bias": ("h",),
}
_EMBED_SHAPES = {"word": ("v", "h"), "position": ("p", "h"), "token_type": ("t", "h"),
                 "ln_scale": ("h",), "ln_bias": ("h",)}


def _dims(arch: EncoderArch) -> Dict[str, int]:
    return {"h": arch.hidden_size, "i": arch.intermediate_size, "v": arch.vocab_size,
            "p": arch.max_position, "t": arch.type_vocab_size}


class EncoderLayer(nn.Module):
    """One transformer layer's parameters, named and laid out as the JAX
    package's stacked ``params["layers"]`` entries ([in, out] matrices)."""

    def __init__(self, arch: EncoderArch):
        super().__init__()
        d = _dims(arch)
        for name, shape in _LAYER_SHAPES.items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(tuple(d[s] for s in shape)), requires_grad=False))


class Encoder(nn.Module):
    """Embedding tables + layer stack (the JAX ``params`` pytree as a module)."""

    def __init__(self, arch: EncoderArch):
        super().__init__()
        self.arch = arch
        d = _dims(arch)
        for name, shape in _EMBED_SHAPES.items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(tuple(d[s] for s in shape)), requires_grad=False))
        self.layers = nn.ModuleList(EncoderLayer(arch) for _ in range(arch.num_layers))

    def cast_matrices_(self, dtype: torch.dtype) -> "Encoder":
        """Cast the layers' weight matrices to the compute dtype, in place
        and once (JAX casts the fp32 masters on every call; the values are
        the same). Vectors and embedding tables stay fp32."""
        for layer in self.layers:
            for name, shape in _LAYER_SHAPES.items():
                if len(shape) == 2:
                    p = getattr(layer, name)
                    p.data = p.data.to(dtype)
        return self


# ------------------------------------------------------------------- params
def init_params(arch: EncoderArch, generator: torch.Generator) -> Encoder:
    """Random weights (bge.py:69): N(0, 0.02) matrices and tables, unit LN
    scales, zero biases, drawn from ``generator`` on the CPU."""
    model = Encoder(arch)

    def fill(p: nn.Parameter, name: str) -> None:
        if name.endswith("ln_scale"):
            p.data.fill_(1.0)
        elif p.dim() == 2:
            p.data.normal_(0.0, 0.02, generator=generator)

    for name, p in model.named_parameters(recurse=False):
        fill(p, name)
    for layer in model.layers:
        for name, p in layer.named_parameters():
            fill(p, name)
    return model


def params_from_jax(tree: Dict[str, Dict[str, np.ndarray]], arch: EncoderArch) -> Encoder:
    """An ``Encoder`` holding the weights of a ``comorag_tpu.models.bge``
    parameter tree (``init_params`` or ``load_hf_checkpoint`` output) given
    as numpy arrays: ``tree["embed"][name]`` and the [L, ...] stacked
    ``tree["layers"][name]``."""
    model = Encoder(arch)
    with torch.no_grad():
        for name in _EMBED_SHAPES:
            getattr(model, name).copy_(torch.from_numpy(np.array(tree["embed"][name], np.float32)))
        for name in _LAYER_SHAPES:
            stacked = np.array(tree["layers"][name], np.float32)
            for i, layer in enumerate(model.layers):
                getattr(layer, name).copy_(torch.from_numpy(stacked[i]))
    return model


def load_hf_checkpoint(model_name_or_path: str) -> Tuple[Encoder, EncoderArch]:
    """Convert a local HuggingFace BERT/XLM-R-family checkpoint (bge.py:306).
    ``transformers`` is imported only here."""
    from transformers import AutoConfig, AutoModel

    cfg = AutoConfig.from_pretrained(model_name_or_path)
    state = {k: v.detach().float().cpu() for k, v in AutoModel.from_pretrained(model_name_or_path).state_dict().items()}
    is_roberta = "roberta" in cfg.model_type
    arch = EncoderArch(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_layers=cfg.num_hidden_layers, num_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size, max_position=cfg.max_position_embeddings,
        type_vocab_size=getattr(cfg, "type_vocab_size", 1), layer_norm_eps=cfg.layer_norm_eps,
        pad_token_id=cfg.pad_token_id or 0,
        position_offset=(cfg.pad_token_id + 1) if is_roberta else 0,
    )
    prefix = "encoder.layer.{}."
    hf_layer = {
        "q_w": "attention.self.query.weight", "q_b": "attention.self.query.bias",
        "k_w": "attention.self.key.weight", "k_b": "attention.self.key.bias",
        "v_w": "attention.self.value.weight", "v_b": "attention.self.value.bias",
        "o_w": "attention.output.dense.weight", "o_b": "attention.output.dense.bias",
        "attn_ln_scale": "attention.output.LayerNorm.weight",
        "attn_ln_bias": "attention.output.LayerNorm.bias",
        "ffn_in_w": "intermediate.dense.weight", "ffn_in_b": "intermediate.dense.bias",
        "ffn_out_w": "output.dense.weight", "ffn_out_b": "output.dense.bias",
        "ffn_ln_scale": "output.LayerNorm.weight", "ffn_ln_bias": "output.LayerNorm.bias",
    }
    hf_embed = {
        "word": "embeddings.word_embeddings.weight",
        "position": "embeddings.position_embeddings.weight",
        "token_type": "embeddings.token_type_embeddings.weight",
        "ln_scale": "embeddings.LayerNorm.weight", "ln_bias": "embeddings.LayerNorm.bias",
    }
    model = Encoder(arch)
    with torch.no_grad():
        for name, key in hf_embed.items():
            getattr(model, name).copy_(state[key])
        for i, layer in enumerate(model.layers):
            for name, key in hf_layer.items():
                w = state[prefix.format(i) + key]
                getattr(layer, name).copy_(w.T if name.endswith("_w") else w)  # HF is [out, in]
    return model, arch


# ------------------------------------------------------------------ forward
def encoder_forward(
    model: Encoder,
    input_ids: torch.Tensor,       # [B, S] int
    attention_mask: torch.Tensor,  # [B, S] int/bool
    compute_dtype: torch.dtype = torch.float32,
    attention: str = "plain",      # "plain" | "kernel"
) -> torch.Tensor:
    """Token embeddings -> transformer stack -> [B, S, H] fp32 (bge.py:155).

    ``attention="kernel"`` routes each layer through the two Hopper kernels
    (``encoder_attention``, and ``encoder_ffn`` where it takes the shape);
    on CPU tensors those wrappers run their plain versions, which is how
    the CPU tests check this route against JAX's ``pallas_interpret``."""
    arch = model.arch
    b, s = input_ids.shape
    eps = arch.layer_norm_eps
    cd = compute_dtype
    dev = input_ids.device
    positions = torch.arange(s, device=dev) + arch.position_offset
    x = model.word[input_ids] + model.position[positions][None] + model.token_type[0][None, None]
    x = layer_norm(x, model.ln_scale, model.ln_bias, eps).to(cd)
    use_kernel = attention == "kernel"
    kernel_ffn = use_kernel and fused_ffn_supported(arch.hidden_size, arch.intermediate_size)
    attend = encoder_attention if use_kernel else encoder_attention_plain

    for layer in model.layers:
        def proj(w, bias):
            return torch.matmul(x, w.to(cd)) + bias.to(cd)

        ctx = attend(proj(layer.q_w, layer.q_b), proj(layer.k_w, layer.k_b),
                     proj(layer.v_w, layer.v_b), attention_mask, arch.num_heads)
        attn_out = torch.matmul(ctx, layer.o_w.to(cd)) + layer.o_b.to(cd)
        if kernel_ffn:
            x = encoder_ffn(x + attn_out, layer.attn_ln_scale, layer.attn_ln_bias,
                            layer.ffn_in_w.to(cd), layer.ffn_in_b, layer.ffn_out_w.to(cd),
                            layer.ffn_out_b, layer.ffn_ln_scale, layer.ffn_ln_bias, eps=eps).to(cd)
            continue
        x1 = layer_norm((x + attn_out).float(), layer.attn_ln_scale, layer.attn_ln_bias, eps).to(cd)
        mid = torch.matmul(x1, layer.ffn_in_w.to(cd)) + layer.ffn_in_b.to(cd)
        mid = torch.nn.functional.gelu(mid, approximate="none")
        f = torch.matmul(mid, layer.ffn_out_w.to(cd)) + layer.ffn_out_b.to(cd)
        x = layer_norm((x1 + f).float(), layer.ffn_ln_scale, layer.ffn_ln_bias, eps).to(cd)
    return x.float()


def encode_pooled(
    model: Encoder,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    normalize: bool = True,
    attention: str = "plain",
) -> torch.Tensor:
    """Forward -> masked mean pooling -> optional L2 normalization (bge.py:282)."""
    hidden = encoder_forward(model, input_ids, attention_mask, compute_dtype, attention)
    mask = attention_mask[..., None].float()
    pooled = (hidden * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1e-9)
    if normalize:
        pooled = pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return pooled


# -------------------------------------------------------------- host wrapper
_SEQ_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


def _seq_bucket(n: int, cap: int) -> int:
    for b in _SEQ_BUCKETS:
        if n <= b:
            return min(b, cap)
    return cap


class SimpleHashTokenizer:
    """Vocab-free tokenizer for hermetic runs: word -> stable hash bucket
    (copy of bge.py:379, so both packages tokenize identically)."""

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size
        self.pad_token_id = 0
        self.cls_token_id = 1

    def __call__(self, texts: List[str], max_length: int):
        ids, masks = [], []
        for text in texts:
            words = text.lower().split()[: max_length - 1]
            row = [self.cls_token_id] + [
                2 + int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little") % (self.vocab_size - 2)
                for w in words
            ]
            ids.append(row)
            masks.append([1] * len(row))
        return ids, masks


class BGETorchEncoder(BaseEncoder):
    """Host-facing encoder with bucketing and batching on one device."""

    default_instruction = ""

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        params: Optional[Encoder] = None,
        arch: Optional[EncoderArch] = None,
        tokenizer=None,
        max_seq_len: int = 512,
        batch_size: int = 32,
        device: Union[str, torch.device] = "cuda",
        compute_dtype: torch.dtype = torch.float32,
        attention: str = "auto",  # "auto" | "plain" | "kernel"
    ):
        if params is None:
            if model_name_or_path is None:
                raise ValueError("need model_name_or_path or params")
            params, arch = load_hf_checkpoint(model_name_or_path)
        arch = arch or params.arch
        self.arch = arch
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.model = params.to(self.device).cast_matrices_(compute_dtype).eval()
        self.fingerprint_extra = (
            os.path.basename(str(model_name_or_path).rstrip("/\\"))
            if model_name_or_path
            else f"L{arch.num_layers}h{arch.hidden_size}"
        )
        self.max_seq_len = min(max_seq_len, arch.max_position - arch.position_offset)
        self.batch_size = batch_size
        self.dim = arch.hidden_size
        if tokenizer is None and model_name_or_path is not None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
        self.tokenizer = tokenizer or SimpleHashTokenizer(arch.vocab_size)
        # "auto": the Hopper kernels for bf16 compute on a card; fp32
        # compute is the HF-parity contract and stays on the plain path
        if attention == "auto":
            fast = compute_dtype != torch.float32
            attention = "kernel" if (self.device.type == "cuda" and fast) else "plain"
        if attention not in ("plain", "kernel"):
            raise ValueError(f"attention must be 'auto', 'plain' or 'kernel', got {attention!r}")
        self.attention = attention

    # ------------------------------------------------------------- tokenize
    def _tokenize(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        if isinstance(self.tokenizer, SimpleHashTokenizer):
            ids, masks = self.tokenizer(texts, self.max_seq_len)
        else:
            out = self.tokenizer(texts, padding=False, truncation=True, max_length=self.max_seq_len)
            ids, masks = out["input_ids"], out["attention_mask"]
        max_len = max((len(r) for r in ids), default=1)
        s = _seq_bucket(max_len, self.max_seq_len)
        b = len(ids)
        b_pad = ((b + 7) // 8) * 8  # batch buckets of 8 rows, as bge.py:488
        id_arr = np.zeros((b_pad, s), np.int64)
        mask_arr = np.zeros((b_pad, s), np.int32)
        for i, (row, mask) in enumerate(zip(ids, masks)):
            row = row[:s]
            mask = mask[:s]
            id_arr[i, : len(row)] = row
            mask_arr[i, : len(mask)] = mask
        mask_arr[b:, 0] = 1  # padding rows: one valid token to avoid 0/0
        return id_arr, mask_arr

    def _pooled(self, texts: List[str], norm: bool) -> torch.Tensor:
        ids, mask = self._tokenize(texts)
        with torch.no_grad():
            pooled = encode_pooled(
                self.model,
                torch.as_tensor(ids, device=self.device),
                torch.as_tensor(mask, device=self.device),
                self.compute_dtype, normalize=norm, attention=self.attention,
            )
        return pooled[: len(texts)]

    def _prepared(self, texts, instruction: str) -> List[str]:
        texts = self._as_list(texts)
        return [instruction + t for t in texts] if instruction else texts

    # --------------------------------------------------------------- encode
    def encode(self, texts, instruction: str = "", norm=None) -> np.ndarray:
        """[n, dim] float32 host array. Batches are launched ahead of their
        host copies, up to ``window`` in flight, so device compute and
        copies overlap without holding every batch on the device."""
        norm = self.resolve_norm(norm)
        texts = self._prepared(texts, instruction)
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        window = 64
        pending: List[HostCopy] = []
        out: List[np.ndarray] = []
        for i in range(0, len(texts), self.batch_size):
            pending.append(HostCopy(self._pooled(texts[i : i + self.batch_size], norm)))
            if len(pending) >= window:
                out.append(pending.pop(0).numpy())
        out.extend(p.numpy() for p in pending)
        return np.concatenate(out, axis=0)

    def encode_device(self, texts, instruction: str = "", norm=None) -> torch.Tensor:
        """Like :meth:`encode` but the [n, dim] fp32 result stays on the
        device: the retrieval indexes take device queries directly."""
        norm = self.resolve_norm(norm)
        texts = self._prepared(texts, instruction)
        if not texts:
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        parts = [self._pooled(texts[i : i + self.batch_size], norm)
                 for i in range(0, len(texts), self.batch_size)]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
