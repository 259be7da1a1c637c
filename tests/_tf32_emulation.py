"""The tf32 scan route's arithmetic (``comorag_torch/csrc/mips_topk.cu``)
emulated in torch on the CPU: operands split into tf32 hi + lo by RNA
rounding on the fp32 words, the kernel's K order, the three products per
k8 step with each mma sum rounded to fp32 (to nearest, or toward zero),
and either sum order. Test code, not the port: ``test_torch_mips.py``
holds it to the fp32 rule and ``scripts/tf32_emulation_error.py`` runs it
at bench shape. No JAX import.
"""

import re
from pathlib import Path

import torch

# features a stage of the tf32 scan, read from the kernel's source so the emulation follows it
_SOURCE = Path(__file__).resolve().parents[1] / "comorag_torch" / "csrc" / "mips_topk.cu"
TBK = int(re.search(r"constexpr int TBK = (\d+);", _SOURCE.read_text())[1])


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (10 stored mantissa bits), to nearest with ties
    away from zero, on the fp32 words (cvt.rna.tf32.f32)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _k_steps(d: int) -> list:
    """The tf32 scan's k8 steps as feature indices: lane t reads piece
    (TBK / 16) t + p of a TBK-feature stage, and step s of a piece takes its
    features 2s and 2s + 1 as k t and t + 4 (features past d are zero)."""
    pieces = TBK // 16
    steps = []
    for c in range(0, -(-d // TBK) * TBK, TBK):
        for p in range(pieces):
            for s in range(2):
                steps.append([c + 4 * (pieces * t + p) + 2 * s + e for e in (0, 1) for t in range(4)])
    return steps


def _round_nearest(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 x to fp32, truncated (rounded toward zero)."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


ROUNDINGS = {"nearest": _round_nearest, "toward_zero": _round_toward_zero}


def tf32_scores(q: torch.Tensor, rows: torch.Tensor, cross_sum: bool, rounding: str = "nearest") -> torch.Tensor:
    """The tf32 route's arithmetic on the CPU: queries and rows split into
    tf32 hi + lo, and per k8 step the products lo.hi and hi.lo, then hi.hi,
    each step's eight exact products summed and rounded once to fp32 (the
    mma's sum; ``rounding``: to nearest, or toward zero) into one fp32
    accumulator, or (``cross_sum``) the two cross terms into a second one,
    added at the end."""
    to_fp32 = ROUNDINGS[rounding]
    d = q.shape[1]
    width = -(-d // TBK) * TBK
    qp, rp = (torch.nn.functional.pad(t, (0, width - d)) for t in (q, rows))
    (qh, ql), (rh, rl) = ((_tf32(t), _tf32(t - _tf32(t))) for t in (qp, rp))
    acc = torch.zeros(q.shape[0], rows.shape[0], dtype=torch.float32)
    cross = torch.zeros_like(acc)
    for step in _k_steps(d):
        def prod(a, b):
            return a[:, step].double() @ b[:, step].double().T  # eight exact products, summed exactly

        for a, b in ((ql, rh), (qh, rl)):
            if cross_sum:
                cross = to_fp32(cross.double() + prod(a, b))
            else:
                acc = to_fp32(acc.double() + prod(a, b))
        acc = to_fp32(acc.double() + prod(qh, rh))
    return acc + cross if cross_sum else acc
