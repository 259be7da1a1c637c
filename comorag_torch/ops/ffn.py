"""Encoder FFN half-layer: LN -> x@W1+b1 -> GELU -> @W2+b2 -> residual -> LN.

Port of ``comorag_tpu/ops/pallas_ffn.py`` (``fused_encoder_ffn`` :112).
``encoder_ffn`` launches the hand-written Hopper kernels
(``csrc/encoder_ffn.cu``: two row passes around one wgmma GEMM used for
both products, with the second product's K splits chosen by ``ffn_plan``)
for CUDA tensors and runs ``encoder_ffn_plain`` for CPU tensors; there is
no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from comorag_torch.ops import build
# [k0, k1) of each K split, cut on multiples of a step as every split-K kernel of the port cuts them
from comorag_torch.ops.int4 import split_bounds

LAUNCHES = build.LaunchCounter("encoder_ffn")
SOURCE = "comorag_torch/csrc/encoder_ffn.cu"
REPLACES = "comorag_tpu/ops/pallas_ffn.py:112"

_KERNEL_HIDDEN = (128, 256, 384, 512, 640, 768, 896, 1024)
# the H100 SXM's published dense bf16 rate and memory rate, for ffn_plan's choice of splits
_PEAK_FLOPS = 989e12
_HBM_BYTES_PER_S = 3.35e12


def layer_norm(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 LayerNorm in the JAX package's order (pallas_ffn.py:70,
    models/bge.py:149): ((x - mean) * rsqrt(var + eps)) * scale + bias."""
    mean = x32.mean(dim=-1, keepdim=True)
    c = x32 - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    return c * torch.rsqrt(var + eps) * scale + bias


def fused_ffn_supported(hidden: int, inter: int) -> bool:
    """Shapes the kernel takes: hidden a multiple of 128 up to 1024 (a
    row pass holds a row in one warp, 4 columns a lane per 128) and inter a
    multiple of 128."""
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


def encoder_ffn_split_plain(xres, ln1_scale, ln1_bias, w1, b1, w2, b2, ln2_scale, ln2_bias, bounds,
                            eps: float = 1e-12) -> torch.Tensor:
    """The kernel's order of work in plain PyTorch: both products with fp32
    sums of the operands as rounded to xres's dtype, the second as one fp32
    partial per K range of ``bounds`` (``ffn_plan``'s ``bounds``), summed
    in split order; the rounding points of ``encoder_ffn_plain``."""
    shape = xres.shape
    dt = xres.dtype
    xr = xres.reshape(-1, shape[-1])
    x1 = layer_norm(xr.float(), ln1_scale.float(), ln1_bias.float(), eps).to(dt)
    mid = torch.matmul(x1.float(), w1.to(dt).float()) + b1.float()
    mid = torch.nn.functional.gelu(mid, approximate="none").to(dt).float()
    w2f = w2.to(dt).float()
    f = None
    for k0, k1 in bounds:
        part = torch.matmul(mid[:, k0:k1], w2f[k0:k1])
        f = part if f is None else f + part
    out = layer_norm(x1.float() + (f + b2.float()), ln2_scale.float(), ln2_bias.float(), eps)
    return out.to(dt).reshape(shape)


@functools.lru_cache(maxsize=None)
def ffn_plan(n: int, hidden: int, inter: int, sm_count: int, tile_m: int, tile_n: int, k_step: int) -> dict:
    """The kernel's work on a card of ``sm_count`` SMs, given its GEMM's
    work item of ``tile_m`` x ``tile_n`` outputs and ``k_step`` K a stage
    (as the built library reports them, ``_tiles``): output tiles per
    product, the K splits of the second product and their bounds, the
    workspace bytes.

    The second product's output [n, hidden] is narrow. Where its tiles do
    not fill the card, its K (inter) is split so that more SMs work; each
    split writes an fp32 partial that the finishing row pass reads back.
    The split count is the one with the least time at the card's published
    peaks: waves of (tile, split) items over the SMs, each item its K
    blocks plus one for its fill and epilogue, plus the partials written
    and read once. Ties go to fewer splits; a product whose tiles fill the
    card is not split."""
    row_tiles = -(-n // tile_m)
    tiles1 = row_tiles * -(-inter // tile_n)
    tiles2 = row_tiles * -(-hidden // tile_n)
    blocks = inter // k_step
    block_s = 2.0 * tile_m * tile_n * k_step * sm_count / _PEAK_FLOPS
    splits, best = 1, None
    for s in range(1, blocks + 1 if tiles2 < sm_count else 2):
        cost = -(-tiles2 * s // sm_count) * (-(-blocks // s) + 1) * block_s + 2 * s * n * hidden * 4 / _HBM_BYTES_PER_S
        if best is None or cost < best:
            splits, best = s, cost
    return {
        "n": n, "tile_m": tile_m, "tile_n": tile_n, "k_step": k_step,
        "gemm1_tiles": tiles1, "gemm2_tiles": tiles2, "splits": splits,
        "bounds": split_bounds(inter, k_step, splits),
        "workspace_bytes": {"x1": n * hidden * 2, "mid": n * inter * 2, "partials": splits * n * hidden * 4},
    }


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = build.load("encoder_ffn")
    fn = lib.comorag_encoder_ffn_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.comorag_encoder_ffn_tile.restype = ctypes.c_int
        lib.comorag_encoder_ffn_tile.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def _tiles() -> Tuple[int, int, int]:
    """(tile rows, tile columns, K a stage) of the built kernel's GEMM."""
    lib = _lib()
    return tuple(lib.comorag_encoder_ffn_tile(i) for i in range(3))


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
        if t.data_ptr() % 16:
            raise ValueError(f"encoder_ffn: {name} must be 16-byte aligned for TMA and vector loads")
    n = xres.numel() // h
    lib = _lib()
    sm_count = _sm_count(xres.device)
    plan = ffn_plan(n, h, inter, sm_count, *_tiles())
    dev = xres.device
    out = torch.empty_like(xres)
    x1 = torch.empty(n, h, dtype=torch.bfloat16, device=dev)
    mid = torch.empty(n, inter, dtype=torch.bfloat16, device=dev)
    part = torch.empty(plan["splits"], n, h, dtype=torch.float32, device=dev)
    rc = lib.comorag_encoder_ffn_bf16(
        xres.data_ptr(), ln1_scale.data_ptr(), ln1_bias.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ln2_scale.data_ptr(),
        ln2_bias.data_ptr(), out.data_ptr(), x1.data_ptr(), mid.data_ptr(), part.data_ptr(),
        n, h, inter, plan["splits"], float(eps), sm_count, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, rc, "encoder_ffn")
    LAUNCHES.add()
    return out
