"""Bidirectional encoder attention in the projection-native [B, S, H] layout.

Port of ``comorag_tpu/ops/pallas_attention.py`` (``flash_encoder_attention``
:73). ``encoder_attention`` launches the hand-written Hopper kernel
(``csrc/encoder_attention.cu``) for CUDA tensors and runs
``encoder_attention_plain`` for CPU tensors; there is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes

import torch

from comorag_torch.ops import build

LAUNCHES = build.LaunchCounter("encoder_attention")
SOURCE = "comorag_torch/csrc/encoder_attention.cu"
REPLACES = "comorag_tpu/ops/pallas_attention.py:73"

_MASKED = -1e30  # pallas_attention.py:55, models/bge.py:187


def encoder_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """The plain PyTorch version (the JAX XLA path, models/bge.py:226-235):
    fp32 scores from exact products, -1e30 on masked keys, fp32 softmax,
    probabilities cast to the compute dtype for the p @ v product."""
    b, s, h = q.shape
    dh = h // num_heads

    def heads(x):
        return x.reshape(b, s, num_heads, dh).transpose(1, 2)

    scores = torch.matmul(heads(q).float(), heads(k).float().transpose(-1, -2))
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, _MASKED).to(torch.float32)
    probs = torch.softmax(scores / dh ** 0.5 + bias, dim=-1).to(q.dtype)
    ctx = torch.matmul(probs, heads(v))
    return ctx.transpose(1, 2).reshape(b, s, h)


def _lib() -> ctypes.CDLL:
    lib = build.load("encoder_attention")
    fn = lib.comorag_encoder_attention_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def encoder_attention(
    q: torch.Tensor,     # [B, S, H] (H = num_heads * head_dim)
    k: torch.Tensor,     # [B, S, H]
    v: torch.Tensor,     # [B, S, H]
    mask: torch.Tensor,  # [B, S] int/bool, 1 = valid key
    num_heads: int,
) -> torch.Tensor:
    """ctx [B, S, H] in q's dtype. CUDA tensors run the bf16 kernel (fp32
    inputs are rejected: the encoder routes fp32 compute to the plain path
    by configuration, as JAX does); CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, mask, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention: unsupported device {q.device}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"encoder_attention: q/k/v must share one [B, S, H] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h = q.shape
    if mask.shape != (b, s):
        raise ValueError(f"encoder_attention: mask must be [{b}, {s}], got {tuple(mask.shape)}")
    if h % num_heads:
        raise ValueError(f"encoder_attention: hidden {h} is not divisible by {num_heads} heads")
    if -(-(h // num_heads) // 16) * 16 > 256:
        raise ValueError(f"encoder_attention: head dim {h // num_heads} > 256 is not supported")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"encoder_attention: {name} must be bfloat16 on CUDA, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"encoder_attention: {name} must be contiguous and 16-byte "
                             f"aligned on {q.device}")
    mask_i = mask.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.comorag_encoder_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i.data_ptr(), out.data_ptr(),
        b, s, h, num_heads, torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, rc, "encoder_attention")
    LAUNCHES.add()
    return out
