"""Exact MIPS (maximum inner-product search) top-k on one device.

Port of the single-device parts of ``comorag_tpu/ops/topk.py``. Tensors
have their true sizes here (PyTorch needs no static shapes), so nothing is
padded and no row mask exists. Every selection is exact and breaks ties
toward the LOWEST id, the order ``lax.top_k`` gives; ``torch.topk`` makes
no promise about tie order, so ``exact_topk`` fixes it explicitly.

The certified two-pass (topk.py:172-280, :361-505) is here as plain
torch: the build-time scan copies and their error bounds are numpy host
functions, the scan, rescore and exactness flag are torch programs. The
packed int32 result buffer (``_pack``) is TPU-only; results come back as
separate tensors.

The corpus-sharded programs (topk.py:514-775, ``make_sharded_*``) run the
single-device code once per shard on that shard's device
(``parallel/mesh.py``) and merge on the mesh's first device. A shard holds
only real rows (the JAX layout's padding rows are not stored), so a shard
may be short or empty; an empty shard adds no candidates, no flag and no
launch. Local ids get the shard's offset after local selection: its
position in the even split times the shard rows (JAX's ``axis_index *
shard_rows``, ``parallel/mesh.shard_bounds``), and the merge concatenates
in shard order and selects with ``exact_topk``, so ties go to the lowest
global id as with ``lax.top_k`` over JAX's gather. The shards are already
on the devices of the mesh axis they were placed along
(``retrieval/index.py``), so the programs take no axis name; the mesh
gives the merge device.

Over a mesh that spans processes (``parallel/distributed.py``) a shard
list holds None at the positions other processes own, and every process
calls the program with the same queries: it runs its local shards,
concatenates their candidates in position order and gathers the blocks
of every process in process order (``all_gather_cols``), which is the
one-process concatenation, so the merged ranking is the same bit for bit.
The two-pass flag is each process's certificate of its own shards against
the merged k-th value, reduced by MAX; the row minimum is reduced by MIN;
full scores are gathered. Every process returns the same tensors.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from comorag_torch.parallel import distributed
from comorag_torch.parallel.mesh import Mesh, on_device


def dense_scores(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Full [P, N] fp32 inner-product matrix (topk.py:508, ``_score_dot``
    :38). A bf16 corpus is scored as JAX scores it: bf16 queries, exact
    products, fp32 sums."""
    if corpus.dtype == torch.bfloat16:
        return torch.matmul(queries.to(torch.bfloat16).float(), corpus.float().T)
    return torch.matmul(queries.float(), corpus.T)


def int8_scores(queries: torch.Tensor, corpus_q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[P, N] scores over a per-row int8 corpus (topk.py:136 ``_int8_scan_dot``):
    bf16 queries, int8 rows exact in bf16, fp32 sums, per-row scale."""
    s = torch.matmul(queries.to(torch.bfloat16).float(), corpus_q.float().T)
    return s * scales[None, :]


def quantize_int8(corpus: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization (topk.py:160): (q [N, d] int8,
    scales [N] f32) with row ~= q * scale."""
    c = np.asarray(corpus, np.float32)
    scales = np.abs(c).max(axis=1) / 127.0 if c.size else np.zeros(c.shape[0], np.float32)
    scales = np.where(scales == 0, 1.0, scales)
    q = np.clip(np.rint(c / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales.astype(np.float32)


def exact_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k per row, sorted descending, ties toward the lowest column id
    (``lax.top_k``'s order, topk.py:56 ``_exact_topk``): a stable
    descending sort keeps equal scores in column order. It never waits on
    the device, so the index's handles stay asynchronous."""
    k = max(0, min(int(k), scores.shape[1]))
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def dense_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner products of each query against the corpus (topk.py:112):
    (scores [P, k], indices [P, k]) sorted descending."""
    return exact_topk(dense_scores(queries, corpus), k)


def topk_min_from_scores(scores: torch.Tensor, k: int):
    """Top-k plus the row minimum (topk.py:290 ``make_packed_topk_min``):
    the fact-linking fetch needs only the candidates and the min-max span."""
    vals, idx = exact_topk(scores, k)
    return vals, idx, scores.amin(dim=1)


def stats_from_scores(scores: torch.Tensor, k: int):
    """Top-k, row min and row sum of a dense score matrix (topk.py:322
    ``make_packed_stats_from_scores``): what the probe fan-out reads on the
    host while the dense matrix stays on the device for the PPR prior."""
    vals, idx = exact_topk(scores, k)
    return vals, idx, scores.amin(dim=1), scores.sum(dim=1, dtype=torch.float32)


def int8_topk(queries: torch.Tensor, corpus_q: torch.Tensor, scales: torch.Tensor, k: int):
    """Top-k over a per-row int8 corpus (topk.py:264): the int8 scan
    numerics of ``int8_scores``, then an exact top-k."""
    return exact_topk(int8_scores(queries, corpus_q, scales), k)


# ------------------------------------------------------- certified two-pass
def _scan_eps(dim: int) -> float:
    """Arithmetic-error allowance per unit ``qnorm * row_norm`` (topk.py:172):
    the query hi/lo bf16 split leaves a relative 2^-18 residual and each
    fp32-summed dot adds at most d*2^-24; 4x covers all of them."""
    return 2.0 ** -18 + 4.0 * dim * 2.0 ** -24


RESIDUAL_FOLD = 256.0  # topk.py:181: channel 2 sits at s1/256, a power of two


def quantize_int8_residual(corpus: np.ndarray, block: int = 32768) -> Tuple[np.ndarray, np.ndarray, float]:
    """Dual-int8 residual quantization for the certified scan (topk.py:185):
    row ~= s1 * (q1 + q2/256). Returns ``(cat [N, 2d] int8 = [q1 | q2],
    s1 [N] f32, bound)`` with |true - scan| <= ||q|| * bound for every
    query and row (Cauchy-Schwarz on the exact float64 residual plus the
    arithmetic terms of ``_scan_eps``)."""
    c32 = np.asarray(corpus, np.float32)
    n, d = c32.shape if c32.ndim == 2 else (c32.shape[0], 1)
    c32 = c32.reshape(n, d)
    cat = np.empty((n, 2 * d), np.int8)
    s1 = np.empty(n, np.float32)
    beta_max = 0.0  # max_j ||e2_j||_2 (f64)
    chi_max = 0.0   # max_j ||s1*(q1 + q2/256)||_2
    for i in range(0, n, block):
        x = c32[i : i + block].astype(np.float64)
        a1 = np.abs(x).max(axis=1) / 127.0
        a1 = np.where(a1 == 0, 1.0, a1)
        a1 = a1.astype(np.float32).astype(np.float64)  # the device folds f32
        b1 = np.clip(np.rint(x / a1[:, None]), -127, 127)
        b2 = np.clip(np.rint((x / a1[:, None] - b1) * RESIDUAL_FOLD), -127, 127)
        hat = a1[:, None] * (b1 + b2 / RESIDUAL_FOLD)
        e2 = x - hat
        beta_max = max(beta_max, float(np.sqrt((e2 * e2).sum(axis=1)).max(initial=0.0)))
        chi_max = max(chi_max, float(np.sqrt((hat * hat).sum(axis=1)).max(initial=0.0)))
        cat[i : i + block, :d] = b1.astype(np.int8)
        cat[i : i + block, d:] = b2.astype(np.int8)
        s1[i : i + block] = a1.astype(np.float32)
    bound = beta_max + _scan_eps(d) * max(chi_max, 1e-30)
    return cat, s1, float(bound)


def bf16_scan_corpus(corpus: np.ndarray, block: int = 32768) -> Tuple[torch.Tensor, float]:
    """bf16 scan copy (round to nearest even, torch's cast) and its sound
    certificate bound (topk.py:245), computed in float64 from the cast
    values. Returns ``(hat [N, d] bf16 on the CPU, bound)``."""
    c32 = np.asarray(corpus, np.float32)
    c32 = c32.reshape(c32.shape[0], -1)
    hat16 = torch.empty(c32.shape, dtype=torch.bfloat16)
    beta_max = chi_max = 0.0
    for i in range(0, c32.shape[0], block):
        x = torch.tensor(c32[i : i + block])
        hat16[i : i + block] = x.to(torch.bfloat16)
        hat = hat16[i : i + block].double()
        e = x.double() - hat
        if len(hat):
            beta_max = max(beta_max, float(e.square().sum(dim=1).sqrt().max()))
            chi_max = max(chi_max, float(hat.square().sum(dim=1).sqrt().max()))
    return hat16, beta_max + _scan_eps(c32.shape[1]) * max(chi_max, 1e-30)


def _bf16_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, D] bf16 . b [N, D] (bf16, or int8: exact in bf16) -> fp32 [M, N]:
    exact products, fp32 sums (JAX's ``preferred_element_type=f32``). On
    CUDA one bf16 matmul with an fp32 output; on the CPU an fp32 matmul of
    the same (exactly representable) values."""
    if a.device.type == "cuda":
        return torch.mm(a, b.to(torch.bfloat16).T, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float().T)


def certified_scan(queries: torch.Tensor, scan_mat: torch.Tensor, scales: Optional[torch.Tensor]) -> torch.Tensor:
    """The certified compressed scan (topk.py:361), [P, N] fp32: queries
    split hi/lo into bf16 and stacked to [2P, d] so the scan copy is read
    once; with ``scales`` the scan copy is the [N, 2d] int8 residual layout
    and the query copies are feature-concatenated with the exact 1/256
    fold ([q, q/256]), then scaled per row; without, a [N, d] bf16 cast."""
    p = queries.shape[0]
    q32 = queries.float()
    q_hi = q32.to(torch.bfloat16)
    q_lo = (q32 - q_hi.float()).to(torch.bfloat16)
    qs = torch.cat([q_hi, q_lo], dim=0)
    if scales is not None:
        qs = torch.cat([qs, qs * (1.0 / RESIDUAL_FOLD)], dim=1)
    dd = _bf16_dot(qs, scan_mat)
    s = dd[:p] + dd[p:]
    if scales is not None:
        s = s * scales[None, :]
    return s


def two_pass_core(queries: torch.Tensor, scan_mat: torch.Tensor, scales: Optional[torch.Tensor],
                  corpus_f32: torch.Tensor, k: int, candidates: int, offset: int = 0):
    """Scan -> pool of ``candidates`` rows -> exact fp32 rescore (topk.py:389).
    Returns (rescored [P, k'], ids + ``offset`` [P, k'], pool boundary scan
    value [P], qnorm [P], immune [P] bool: rows that can never flag,
    because the pool covered every row or the query is all zero). On a
    shard, ``corpus_f32`` holds the shard's rows alone, so "every row" is
    the shard's (JAX's ``local_valid``) and ``offset`` is its first id."""
    n = corpus_f32.shape[0]
    c = min(candidates, n)
    q32 = queries.float()
    s = certified_scan(q32, scan_mat, scales)
    cand = exact_topk(s, c)[1]
    boundary = s.gather(1, cand).amin(dim=1)
    pool = corpus_f32[cand]  # [P, C, d] fp32
    exact = torch.bmm(pool, q32[:, :, None])[:, :, 0]
    rv, pos = exact_topk(exact, min(k, c))
    idx = cand.gather(1, pos) + offset
    qnorm = q32.square().sum(dim=1).sqrt()
    immune = (qnorm == 0) | (c >= n)
    return rv, idx, boundary, qnorm, immune


def exactness_flag(boundary: torch.Tensor, kth_value: torch.Tensor, qnorm: torch.Tensor,
                   bound: torch.Tensor, immune: torch.Tensor) -> torch.Tensor:
    """[P] int32: 1 where the two-pass result is not certifiably exact
    (topk.py:471). Every row outside the pool scans at or below
    ``boundary`` and |true - scan| <= qnorm * bound, so a k-th rescored
    value that clears the boundary by more than that cannot be beaten."""
    ambiguous = kth_value - boundary <= qnorm * bound
    return (ambiguous & ~immune).to(torch.int32)


def two_pass_topk(queries: torch.Tensor, scan_mat: torch.Tensor, scales: Optional[torch.Tensor],
                  corpus_f32: torch.Tensor, bound: torch.Tensor, k: int, candidates: int):
    """The single-device certified two-pass (topk.py:434
    ``make_packed_two_pass_topk``): (scores [P, k'], ids [P, k'], flag [P])."""
    rv, idx, boundary, qnorm, immune = two_pass_core(queries, scan_mat, scales, corpus_f32, k, candidates)
    return rv, idx, exactness_flag(boundary, rv[:, -1], qnorm, bound, immune)


# ---------------------------------------------------------- corpus-sharded
def _shard_calls(queries: torch.Tensor, shards: Sequence[Sequence[Optional[torch.Tensor]]], local: Callable,
                 shard_rows: Optional[int]) -> List[tuple]:
    """``local(q, offset, *tensors)`` on each local non-empty shard, on its
    device, with the queries copied there (shard_map's body). ``shards``
    holds per-shard lists (rows first) in shard order, None where another
    process owns the shard; shard s starts at id ``s * shard_rows`` (when
    None, the first shard's length: every shard but the trailing ones is
    full). Returns the local results in shard order, still on the shard
    devices."""
    first = shards[0][0]
    if shard_rows is None:
        if first is None:
            raise ValueError("a shard list whose first shard another process owns needs shard_rows")
        shard_rows = int(first.shape[0])
    out = []
    for s, tensors in enumerate(zip(*shards)):
        rows = tensors[0]
        if rows is not None and rows.shape[0]:
            with on_device(rows.device):
                out.append(local(queries.to(rows.device), s * shard_rows, *tensors))
    return out


def _gather(mesh: Mesh, block: torch.Tensor) -> torch.Tensor:
    """This process's columns, then every process's in process order."""
    return distributed.all_gather_cols(block) if mesh.process_count > 1 else block


def _reduce(mesh: Mesh, t: torch.Tensor, op: str) -> torch.Tensor:
    return distributed.all_reduce(t, op) if mesh.process_count > 1 else t


def _merge_topk(mesh: Mesh, parts: List[tuple], k: int, p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The all_gather merge: shard candidates (scores, global ids)
    concatenated in shard order on the merge device, then the exact top-k."""
    dev = mesh.device
    scores = torch.cat([s.to(dev) for s, i, *_ in parts], dim=1) if parts else torch.zeros((p, 0), device=dev)
    ids = (torch.cat([i.to(dev) for s, i, *_ in parts], dim=1) if parts
           else torch.zeros((p, 0), dtype=torch.int64, device=dev))
    scores, ids = _gather(mesh, scores), _gather(mesh, ids)
    if not scores.shape[1]:
        return scores, ids
    vals, pos = exact_topk(scores, k)
    return vals, ids.gather(1, pos)


def _none_shards(shards, like) -> list:
    return list(shards) if shards is not None else [None] * len(like)


def make_sharded_topk(mesh: Mesh, k: int, method: str = "xla", int8: bool = False,
                      shard_rows: Optional[int] = None) -> Callable:
    """Sharded exact top-k (topk.py:514): fn(queries [P, d] on the merge
    device, corpus shards, scales shards or None) -> (scores [P, k'], ids
    [P, k']) on the merge device. Each shard selects its local top
    min(k, shard rows): with ``method="pallas"`` through the streaming
    kernels (``ops/mips``: the kernel on a CUDA shard, its plain version on
    a CPU one; k above the kernels' bound raises there as on one device),
    else from the full score block. ``shard_rows``: the even split's rows
    a shard (see ``_shard_calls``)."""
    from comorag_torch.ops import mips

    def local(q, offset, rows, scales):
        local_k = min(k, int(rows.shape[0]))
        if method == "pallas":
            s, i = mips.mips_topk_int8(q, rows, scales, local_k) if int8 else mips.mips_topk(q, rows, local_k)
        else:
            s, i = exact_topk(int8_scores(q, rows, scales) if int8 else dense_scores(q, rows), local_k)
        return s, i + offset

    def fn(queries, corpus_shards, scales_shards=None):
        parts = _shard_calls(queries, (corpus_shards, _none_shards(scales_shards, corpus_shards)), local, shard_rows)
        return _merge_topk(mesh, parts, k, queries.shape[0])

    return fn


def make_sharded_two_pass_topk(mesh: Mesh, k: int, candidates: int, shard_rows: Optional[int] = None) -> Callable:
    """Sharded certified two-pass (topk.py:611): fn(queries, scan shards,
    scan-scales shards or None (bf16 scan), fp32 shards, bound) ->
    (scores, ids, flag [P] int32) on the merge device. Each shard scans
    its rows, rescores its own pool and selects locally; the flag of a row
    is the OR over shards of each shard's certificate against the MERGED
    k-th value (topk.py:656-664), so a shard whose pool boundary sits below
    the merged k-th by more than the bound flags nothing."""

    def local(q, offset, scan_rows, scan_scales, f32_rows):
        return two_pass_core(q, scan_rows, scan_scales, f32_rows, k, candidates, offset)

    def fn(queries, scan_shards, scales_shards, f32_shards, bound):
        shards = (scan_shards, _none_shards(scales_shards, scan_shards), f32_shards)
        parts = _shard_calls(queries, shards, local, shard_rows)
        vals, ids = _merge_topk(mesh, parts, k, queries.shape[0])
        dev = mesh.device
        flag = torch.zeros(queries.shape[0], dtype=torch.int32, device=dev)
        if vals.shape[1]:
            kth = vals[:, -1]
            for _, _, boundary, qnorm, immune in parts:
                flag = torch.maximum(flag, exactness_flag(boundary.to(dev), kth, qnorm.to(dev), bound,
                                                          immune.to(dev)))
        return vals, ids, _reduce(mesh, flag, "max")

    return fn


def make_sharded_topk_min(mesh: Mesh, k: int, int8: bool = False, shard_rows: Optional[int] = None) -> Callable:
    """Sharded top-k plus row minimum (topk.py:690): fn(queries, corpus
    shards, scales shards or None) -> (scores, ids, row_min [P]) on the
    merge device. The row minimum is the min over shards; an empty shard
    contributes +inf (topk.py:708-718), i.e. nothing."""

    def local(q, offset, rows, scales):
        s = int8_scores(q, rows, scales) if int8 else dense_scores(q, rows)
        vals, idx = exact_topk(s, min(k, int(rows.shape[0])))
        return vals, idx + offset, s.amin(dim=1)

    def fn(queries, corpus_shards, scales_shards=None):
        parts = _shard_calls(queries, (corpus_shards, _none_shards(scales_shards, corpus_shards)), local, shard_rows)
        vals, ids = _merge_topk(mesh, parts, k, queries.shape[0])
        row_min = torch.full((queries.shape[0],), float("inf"), device=mesh.device)
        for _, _, m in parts:
            row_min = torch.minimum(row_min, m.to(mesh.device))
        return vals, ids, _reduce(mesh, row_min, "min")

    return fn


def make_sharded_scores(mesh: Mesh, int8: bool = False) -> Callable:
    """Full [P, N] scores with the corpus sharded (topk.py:748): fn(queries,
    corpus shards, scales shards or None) -> the shard blocks gathered in
    shard order on the merge device."""

    def local(q, offset, rows, scales):
        return (int8_scores(q, rows, scales) if int8 else dense_scores(q, rows),)

    def fn(queries, corpus_shards, scales_shards=None):
        shards = (corpus_shards, _none_shards(scales_shards, corpus_shards))
        parts = _shard_calls(queries, shards, local, 0)  # full blocks: no id offset
        block = (torch.cat([s.to(mesh.device) for s, in parts], dim=1) if parts
                 else torch.zeros((queries.shape[0], 0), device=mesh.device))
        return _gather(mesh, block)

    return fn
