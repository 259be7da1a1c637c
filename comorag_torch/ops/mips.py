"""Streaming exact MIPS top-k over an fp32, bf16 or int8 corpus.

Port of ``comorag_tpu/ops/pallas_topk.py`` (``pallas_mips_topk`` :121 and
``pallas_mips_topk_int8`` :210). ``mips_topk`` and ``mips_topk_int8``
launch the hand-written Hopper kernels (``csrc/mips_topk.cu``) for CUDA
tensors and run ``mips_topk_plain`` / ``mips_topk_int8_plain`` for CPU
tensors; there is no fallback from one to the other. Results are sorted by
(score descending, row id ascending), the TPU kernels' tie rule.

The first pass of a CUDA call (the per-split lists) runs on one of three
scan kernels, chosen here by ``scan_route`` and passed to the C entry,
which refuses a route whose limits the call does not meet. fp32 rows are
scored exactly to fp32 on every route: the ``tf32`` route splits each
operand into tf32 hi + lo (3xTF32), the ``scan`` route multiplies on FFMA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from comorag_torch.ops import build
from comorag_torch.ops.topk import dense_topk, exact_topk, int8_topk

LAUNCHES = build.LaunchCounter("mips_topk")
SOURCE = "comorag_torch/csrc/mips_topk.cu"
REPLACES = "comorag_tpu/ops/pallas_topk.py:121"
INT8_LAUNCHES = build.LaunchCounter("mips_topk_int8")
INT8_REPLACES = "comorag_tpu/ops/pallas_topk.py:210"

MAX_K = 256  # the kernels' per-query list bound
TC_MAX_K = 64  # the k bound of the tensor-core scans (tf32, mma)
SCAN_ROUTES = ("scan", "tf32", "mma")  # the C entries' route codes 0, 1, 2
# launches per scan route, of both wrappers (scan_route)
ROUTE_LAUNCHES = {route: build.LaunchCounter(f"mips_topk.{route}") for route in SCAN_ROUTES}


def mips_topk_plain(queries: torch.Tensor, corpus: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version (the JAX XLA path, ops/topk.dense_topk):
    the full fp32 score matrix, then an exact top-k, ties to the lowest id.
    A bf16 corpus is scored with bf16 queries, exact products, fp32 sums."""
    return dense_topk(queries, corpus, k)


def mips_topk_int8_plain(
    queries: torch.Tensor, corpus_q: torch.Tensor, scales: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the int8 kernel (ops/topk.int8_topk)."""
    return int8_topk(queries, corpus_q, scales, k)


def scan_route(p: int, d: int, k: int, row_dtype: torch.dtype, aligned: bool) -> str:
    """The scan kernel a CUDA call of p queries over [N, d] rows of
    ``row_dtype`` takes (``aligned``: rows and queries 16-byte aligned):
    - ``"mma"``, int8 rows, k <= 64, d % 16 == 0, aligned: [128 rows x 32
      queries] tiles on mma.sync bf16 tensor-core products, int8 rows
      streamed by TMA and converted exactly at fragment load;
    - ``"tf32"``, fp32 rows, k <= 64, d % 4 == 0, aligned, any p: the same
      tile and streaming in 3xTF32 tensor-core products (each operand split
      into tf32 hi + lo; lo.hi + hi.lo + hi.hi with fp32 sums);
    - ``"scan"``, every other call (bf16 rows, k > 64, unaligned rows or
      queries, d % 4 != 0 for fp32, d % 16 != 0 for int8): 8 queries a
      block, rows streamed from L2 into registers (any d, k <= 256)."""
    if row_dtype == torch.int8 and k <= TC_MAX_K and d % 16 == 0 and aligned:
        return "mma"
    if row_dtype == torch.float32 and k <= TC_MAX_K and d % 4 == 0 and aligned:
        return "tf32"
    return "scan"


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = build.load("mips_topk")
    if lib.comorag_mips_topk.argtypes is None:
        for fn in (lib.comorag_mips_topk, lib.comorag_mips_topk_int8):
            fn.restype = ctypes.c_int
        lib.comorag_mips_topk.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4
        lib.comorag_mips_topk_int8.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
        ws = lib.comorag_mips_topk_workspace_bytes
        ws.restype = ctypes.c_longlong
        ws.argtypes = [ctypes.c_int] * 5
    return lib


def _check(what: str, queries: torch.Tensor, corpus: torch.Tensor, k: int) -> Tuple[int, int, int]:
    if queries.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {queries.device}")
    if queries.dim() != 2 or corpus.dim() != 2 or corpus.shape[1] != queries.shape[1]:
        raise ValueError(f"{what}: queries [P, d] and corpus [N, d] expected, got "
                         f"{tuple(queries.shape)}, {tuple(corpus.shape)}")
    p, d = queries.shape
    n = corpus.shape[0]
    if p < 1 or d < 1 or n < 1 or n >= 2 ** 31:
        raise ValueError(f"{what}: empty or oversized input (P={p}, N={n}, d={d})")
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"{what}: k={k} outside 1..min(N={n}, {MAX_K})")
    if queries.dtype != torch.float32:
        raise TypeError(f"{what}: queries must be float32, got {queries.dtype}")
    for name, t in (("queries", queries), ("corpus", corpus)):
        if t.device != queries.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on {queries.device}")
    return p, n, d


def _launch(what: str, fn: str, args_head: tuple, queries: torch.Tensor, corpus: torch.Tensor, k: int):
    p, n, d = _check(what, queries, corpus, k)
    dev = queries.device
    lib = _lib()
    route = scan_route(p, d, k, corpus.dtype, queries.data_ptr() % 16 == 0 and corpus.data_ptr() % 16 == 0)
    # the split of the corpus over blocks, and so the scratch, follow the SM count
    sm_count = _sm_count(dev)
    workspace = torch.empty(lib.comorag_mips_topk_workspace_bytes(p, n, d, k, sm_count),
                            dtype=torch.uint8, device=dev)
    out_s = torch.empty((p, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((p, k), dtype=torch.int64, device=dev)
    rc = getattr(lib, fn)(*args_head, p, n, d, k, SCAN_ROUTES.index(route), sm_count, workspace.data_ptr(),
                          out_s.data_ptr(), out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, f"{what} ({route})")
    ROUTE_LAUNCHES[route].add()
    return out_s, out_i


def check_topk(got_s: torch.Tensor, got_i: torch.Tensor, scores: torch.Tensor, what: str,
               tol: float = 1e-5) -> float:
    """Hold a top-k (got_s, got_i) against the full plain score matrix
    ``scores`` [P, N]; returns the max |got - plain| of the scores. Raises
    unless: scores agree rank by rank to tol + tol*|plain|; each returned id
    is distinct and its plain score matches the score returned with it;
    and ids are equal at every rank whose plain score is more than ``tol``
    from both neighbours (closer ranks may swap: sums run in another order
    than the plain matmul's)."""
    k = got_s.shape[1]
    n = scores.shape[1]
    ref_s, ref_i = exact_topk(scores, min(k + 1, n))
    got_s, got_i = got_s.float(), got_i.long()
    scale = tol + tol * ref_s[:, :k].abs()
    err = (got_s - ref_s[:, :k]).abs()
    if not torch.isfinite(got_s).all() or bool((err > scale).any()):
        raise AssertionError(f"{what}: scores differ from plain beyond {tol} + {tol}*|plain| "
                             f"(max abs {float(err.max()):.3g})")
    if bool(((got_i < 0) | (got_i >= n)).any()):
        raise AssertionError(f"{what}: id out of range")
    if bool((got_i.sort(dim=1).values.diff(dim=1) == 0).any()):
        raise AssertionError(f"{what}: an id is returned twice")
    own = scores.gather(1, got_i)
    if bool(((own - got_s).abs() > tol + tol * own.abs()).any()):
        raise AssertionError(f"{what}: an id's plain score differs from the score returned with it")
    inf = torch.full_like(ref_s[:, :1], float("inf"))
    # gaps[:, r]: plain score of rank r - 1 minus rank r (inf past either end)
    gaps = torch.cat([inf, ref_s[:, :-1] - ref_s[:, 1:], inf], dim=1)[:, : k + 1]
    determined = (gaps[:, :k] > tol) & (gaps[:, 1 : k + 1] > tol)
    if bool(((got_i != ref_i[:, :k]) & determined).any()):
        raise AssertionError(f"{what}: ids differ from plain at a rank separated by more than {tol}")
    return float(err.max())


def mips_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [P, k] fp32, ids [P, k] int64), best first. CUDA tensors run
    the kernel (queries fp32, corpus fp32 or bf16, k <= 256); CPU tensors
    run the plain version."""
    if queries.device.type == "cpu":
        return mips_topk_plain(queries, corpus, k)
    if corpus.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mips_topk: corpus must be float32 or bfloat16, got {corpus.dtype}")
    out = _launch("mips_topk", "comorag_mips_topk",
                  (queries.data_ptr(), corpus.data_ptr(), int(corpus.dtype == torch.bfloat16)),
                  queries, corpus, k)
    LAUNCHES.add()
    return out


def mips_topk_int8(
    queries: torch.Tensor, corpus_q: torch.Tensor, scales: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [P, k] fp32, ids [P, k] int64) over a per-row int8 corpus,
    best first. CUDA tensors run the kernel; CPU tensors run the plain
    version."""
    if queries.device.type == "cpu":
        return mips_topk_int8_plain(queries, corpus_q, scales, k)
    if corpus_q.dtype != torch.int8:
        raise TypeError(f"mips_topk_int8: corpus must be int8, got {corpus_q.dtype}")
    if (scales.dtype != torch.float32 or scales.shape != (corpus_q.shape[0],)
            or scales.device != queries.device or not scales.is_contiguous()):
        raise ValueError(f"mips_topk_int8: scales must be contiguous float32 [{corpus_q.shape[0]}] "
                         f"on {queries.device}")
    out = _launch("mips_topk_int8", "comorag_mips_topk_int8",
                  (queries.data_ptr(), corpus_q.data_ptr(), scales.data_ptr()),
                  queries, corpus_q, k)
    INT8_LAUNCHES.add()
    return out
