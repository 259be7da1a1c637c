"""Fused encoder FFN half-layer: LN -> x@W1+b1 -> GELU -> @W2+b2 -> residual -> LN.

Port of ``comorag_tpu/ops/pallas_ffn.py`` (``fused_encoder_ffn`` :112).
``encoder_ffn`` launches the hand-written Hopper kernel
(``csrc/encoder_ffn.cu``) for CUDA tensors and runs ``encoder_ffn_plain``
for CPU tensors; there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from comorag_torch.ops import build

LAUNCHES = build.LaunchCounter("encoder_ffn")
SOURCE = "comorag_torch/csrc/encoder_ffn.cu"
REPLACES = "comorag_tpu/ops/pallas_ffn.py:112"

_KERNEL_HIDDEN = (128, 256, 384, 512, 640, 768, 896, 1024)


def layer_norm(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 LayerNorm in the JAX package's order (pallas_ffn.py:70,
    models/bge.py:149): ((x - mean) * rsqrt(var + eps)) * scale + bias."""
    mean = x32.mean(dim=-1, keepdim=True)
    c = x32 - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    return c * torch.rsqrt(var + eps) * scale + bias


def fused_ffn_supported(hidden: int, inter: int) -> bool:
    """Shapes the kernel takes: hidden a multiple of 128 up to 1024 (the
    warps split hidden's output columns in 16-wide fragments) and inter a
    multiple of 128 (the chunk width of the mid tile)."""
    return hidden in _KERNEL_HIDDEN and inter % 128 == 0


def encoder_ffn_plain(xres, ln1_scale, ln1_bias, w1, b1, w2, b2, ln2_scale, ln2_bias,
                      eps: float = 1e-12) -> torch.Tensor:
    """The plain PyTorch version, with the TPU kernel's rounding points:
    x1 cast to xres's dtype after LN1, mid cast before the second product,
    residual x1 + f, fp32 LayerNorms and GELU. The products run as the
    framework's own matmul in the compute dtype (for bf16 that rounds each
    product's output to bf16 before the fp32 bias, one rounding the kernel
    does not have)."""
    shape = xres.shape
    dt = xres.dtype
    xr = xres.reshape(-1, shape[-1])
    x1 = layer_norm(xr.float(), ln1_scale.float(), ln1_bias.float(), eps).to(dt)
    mid = torch.matmul(x1, w1.to(dt)).float() + b1.float()
    mid = torch.nn.functional.gelu(mid, approximate="none").to(dt)
    f = torch.matmul(mid, w2.to(dt)).float() + b2.float()
    out = layer_norm(x1.float() + f, ln2_scale.float(), ln2_bias.float(), eps)
    return out.to(dt).reshape(shape)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = build.load("encoder_ffn")
    fn = lib.comorag_encoder_ffn_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        ws = lib.comorag_encoder_ffn_workspace_bytes
        ws.restype = ctypes.c_longlong
        ws.argtypes = [ctypes.c_int] * 4
    return lib


def encoder_ffn(
    xres: torch.Tensor,       # [B, S, H] or [N, H] pre-LN residual input
    ln1_scale: torch.Tensor,  # [H]
    ln1_bias: torch.Tensor,   # [H]
    w1: torch.Tensor,         # [H, I]
    b1: torch.Tensor,         # [I]
    w2: torch.Tensor,         # [I, H]
    b2: torch.Tensor,         # [H]
    ln2_scale: torch.Tensor,  # [H]
    ln2_bias: torch.Tensor,   # [H]
    eps: float = 1e-12,
) -> torch.Tensor:
    """LN(x1 + gelu(x1 @ w1 + b1) @ w2 + b2) with x1 = LN(xres), in xres's
    shape and dtype. CUDA tensors run the bf16 kernel (xres, w1, w2 bf16;
    vectors fp32); CPU tensors run the plain version."""
    if xres.device.type == "cpu":
        return encoder_ffn_plain(xres, ln1_scale, ln1_bias, w1, b1, w2, b2,
                                 ln2_scale, ln2_bias, eps)
    if xres.device.type != "cuda":
        raise ValueError(f"encoder_ffn: unsupported device {xres.device}")
    h = xres.shape[-1]
    if w1.dim() != 2 or w1.shape[0] != h:
        raise ValueError(f"encoder_ffn: w1 must be [{h}, I], got {tuple(w1.shape)}")
    inter = w1.shape[1]
    if w2.shape != (inter, h):
        raise ValueError(f"encoder_ffn: w2 must be [{inter}, {h}], got {tuple(w2.shape)}")
    if not fused_ffn_supported(h, inter):
        raise ValueError(f"encoder_ffn: kernel takes hidden in {_KERNEL_HIDDEN} and "
                         f"inter % 128 == 0, got hidden={h}, inter={inter}")
    vectors = {"ln1_scale": (ln1_scale, h), "ln1_bias": (ln1_bias, h), "b1": (b1, inter),
               "b2": (b2, h), "ln2_scale": (ln2_scale, h), "ln2_bias": (ln2_bias, h)}
    for name, (t, width) in vectors.items():
        if t.dtype != torch.float32 or t.numel() != width:
            raise TypeError(f"encoder_ffn: {name} must be float32 [{width}], "
                            f"got {t.dtype} {tuple(t.shape)}")
    for name, t in (("xres", xres), ("w1", w1), ("w2", w2)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"encoder_ffn: {name} must be bfloat16 on CUDA, got {t.dtype}")
    tensors = {"xres": xres, "w1": w1, "w2": w2, **{n: t for n, (t, _) in vectors.items()}}
    for name, t in tensors.items():
        if t.device != xres.device or not t.is_contiguous():
            raise ValueError(f"encoder_ffn: {name} must be contiguous on {xres.device}")
        if t.data_ptr() % 32:
            raise ValueError(f"encoder_ffn: {name} must be 32-byte aligned for WMMA loads")
    n = xres.numel() // h
    out = torch.empty_like(xres)
    lib = _lib()
    # few row tiles: the kernel splits the intermediate dim over more
    # blocks and sums their partial products through this fp32 workspace
    sm_count = _sm_count(xres.device)
    ws_bytes = lib.comorag_encoder_ffn_workspace_bytes(n, h, inter, sm_count)
    workspace = (torch.empty(ws_bytes, dtype=torch.uint8, device=xres.device)
                 if ws_bytes > 0 else None)
    rc = lib.comorag_encoder_ffn_bf16(
        xres.data_ptr(), ln1_scale.data_ptr(), ln1_bias.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ln2_scale.data_ptr(),
        ln2_bias.data_ptr(), out.data_ptr(), None if workspace is None else workspace.data_ptr(),
        n, h, inter, float(eps), sm_count, torch.cuda.current_stream(xres.device).cuda_stream,
    )
    build.check(lib, rc, "encoder_ffn")
    LAUNCHES.add()
    return out
