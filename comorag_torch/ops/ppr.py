"""Personalized PageRank: batched power iteration in torch, or the native
float64 host solver.

Port of ``comorag_tpu/ops/ppr.py`` ``PPRGraph`` (:289):

  x_{t+1} = (1 - alpha) * r + alpha * (P^T x_t + dangling_mass * r)

with ``P`` the weight-row-normalized transition matrix of the arc list and
``r`` the normalized reset. The device route keeps the state as [N, B]
(one column per reset vector) and computes ``P^T x`` as an ``index_add_``
of per-arc contributions over dst-sorted arcs, in fp32; it stops when the
worst column's L1 step is at most the tolerance, checked every step like
the JAX while_loop. The host route is the port's copy of the native
solver (``comorag_torch.native``). The TPU-only layout devices of the JAX solver (planar uint16
state, VMEM-budget batch chunking, lane-width batch padding) are not
carried: none changes a result.

Edge sharding (ppr.py:235-285): under a mesh the dst-sorted arc list is
split into contiguous pieces, one per device of the mesh's ``corpus``
axis, so each piece stays sorted. Each step runs one ``index_add_`` per
piece on its device and sums the partial flows on the merge device (the
mesh's first device; JAX's ``psum``), which also holds the state. The
one-device graph is the one-piece case of the same code, so ``PPRGraph``
runs one path; ``make_sharded_ppr`` and ``make_sharded_ppr_seed_topk``
are the JAX-shaped programs over arc pieces placed by the caller.

Over a mesh that spans processes (``parallel/distributed.py``) each
process holds the pieces of its own positions (None at the others) and
the whole state, sums its pieces' flows and adds every process's with one
``all_reduce`` SUM a step (JAX's ``psum``); the stop test reduces the
step's error by MAX first, so every process leaves the loop at the same
step. Only the torch iteration runs there: the native host solver is not
used over such a mesh.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from comorag_torch.ops.topk import exact_topk
from comorag_torch.parallel import distributed
from comorag_torch.parallel.mesh import Mesh, is_local_device, mesh_device

# batch x arcs at which the device solve beats the native host solver, as
# measured for the JAX package (ops/device_profile.py); the rule is kept
# unchanged until the crossover is re-derived on the H100 (ROADMAP)
CROSSOVER_BATCH_ARCS = 16_000_000

Arcs = Sequence[Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]]  # (src, dst, rate) per piece; None: another process's


def split_arcs(src: np.ndarray, dst: np.ndarray, rate: np.ndarray,
               devices: Sequence[torch.device]) -> List[Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]]:
    """Dst-sorted arcs cut into ``len(devices)`` contiguous pieces of
    ceil(E / n) arcs (the last ones may be short or empty), each on its
    device as (src int64, dst int64, rate fp32); None where another process
    owns the device."""
    per = -(-len(src) // len(devices))
    out = []
    for i, dev in enumerate(devices):
        sl = slice(i * per, (i + 1) * per)
        out.append((torch.as_tensor(src[sl], dtype=torch.int64, device=dev),
                    torch.as_tensor(dst[sl], dtype=torch.int64, device=dev),
                    torch.as_tensor(rate[sl], dtype=torch.float32, device=dev)) if is_local_device(dev) else None)
    return out


def _flow(arcs: Arcs, x: torch.Tensor, across_processes: bool = False) -> torch.Tensor:
    """P^T x: each local piece's index_add_ on its device, partial flows
    summed on x's device in piece order, then over the processes."""
    flowed = None
    for piece in arcs:
        if piece is None:
            continue
        src, dst, rate = piece
        xs = x.to(src.device)
        part = torch.zeros_like(xs).index_add_(0, dst, xs[src] * rate[:, None]).to(x.device)
        flowed = part if flowed is None else flowed + part
    flowed = flowed if flowed is not None else torch.zeros_like(x)
    return distributed.all_reduce(flowed, "sum") if across_processes else flowed


def ppr_iterate(arcs: Arcs, is_dangling: torch.Tensor, resets_nb: torch.Tensor, alpha: float,
                tol: float, max_iters: int, across_processes: bool = False) -> torch.Tensor:
    """Power iteration over an [N, B] state (ppr.py:106 ``_ppr_iterate_nb``).
    Columns that converge early keep iterating until the worst one does.
    ``across_processes``: the pieces are one process's of a process mesh."""
    x = resets_nb
    for _ in range(max_iters):
        flowed = _flow(arcs, x, across_processes)
        dangling_mass = (x * is_dangling[:, None]).sum(dim=0)
        new_x = (1.0 - alpha) * resets_nb + alpha * (flowed + dangling_mass[None, :] * resets_nb)
        err = (new_x - x).abs().sum(dim=0).max()
        if across_processes:
            err = distributed.all_reduce(err, "max")  # one stop decision for every process
        x = new_x
        if not bool(err > tol):
            break
    return x


def _normalize_columns(rt: torch.Tensor) -> torch.Tensor:
    rt = torch.where(torch.isnan(rt) | (rt < 0), torch.zeros_like(rt), rt)
    sums = rt.sum(dim=0, keepdim=True)
    return rt / torch.where(sums == 0, torch.ones_like(sums), sums)


def seed_ppr_topk(arcs: Arcs, is_dangling: torch.Tensor, seed_idx: torch.Tensor, seed_w: torch.Tensor,
                  prior_idx: torch.Tensor, prior_w: torch.Tensor, alpha: float, tol: float,
                  max_iters: int, k: int, across_processes: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeds -> PPR -> top-k of the prior nodes (ppr.py:394
    ``_seed_ppr_doc_ranks``): the [N, B] resets are built on the state's
    device from sparse seeds plus the dense prior; (scores [B, k],
    positions into ``prior_idx``), ties to the lowest position."""
    dev = is_dangling.device
    b = seed_w.shape[0]
    cols = torch.arange(b, device=dev)[None, :].expand(seed_idx.shape[1], b)
    rt = torch.zeros((is_dangling.shape[0], b), dtype=torch.float32, device=dev)
    rt.index_put_((seed_idx.T, cols), seed_w.T, accumulate=True)
    rt.index_add_(0, prior_idx, prior_w.T)
    ranks = ppr_iterate(arcs, is_dangling, _normalize_columns(rt), alpha, tol, max_iters, across_processes)
    doc = ranks.index_select(0, prior_idx).T  # [B, n_sel]
    return exact_topk(doc, min(k, doc.shape[1]))


def make_sharded_ppr(mesh: Mesh, max_iters: int) -> Callable:
    """Edge-sharded batched PPR (ppr.py:262): fn(arc pieces, is_dangling
    [N], resets [B, N], alpha, tol) -> ranks [B, N] on the merge device."""

    def fn(arcs, is_dangling, resets, alpha, tol):
        dev = mesh.device
        r = resets.to(dev, torch.float32).T.contiguous()
        return ppr_iterate(arcs, is_dangling.to(dev), r, float(alpha), float(tol), max_iters,
                           mesh.process_count > 1).T

    return fn


def make_sharded_ppr_seed_topk(mesh: Mesh, max_iters: int, k: int) -> Callable:
    """Edge-sharded seeds -> PPR -> top-k (ppr.py:235): fn(arc pieces,
    is_dangling, seed_idx [B, S], seed_w [B, S], prior_idx [n_sel], prior_w
    [B, n_sel], alpha, tol) -> (scores [B, k], positions [B, k]) on the
    merge device."""

    def fn(arcs, is_dangling, seed_idx, seed_w, prior_idx, prior_w, alpha, tol):
        dev = mesh.device
        return seed_ppr_topk(arcs, is_dangling.to(dev), seed_idx.to(dev), seed_w.to(dev), prior_idx.to(dev),
                             prior_w.to(dev), float(alpha), float(tol), max_iters, k, mesh.process_count > 1)

    return fn


class PPRGraph:
    """Graph for batched PPR queries, arcs resident on one device or, with
    a mesh that has ``axis``, split over that axis's devices (this
    process's pieces alone over a mesh that spans processes)."""

    def __init__(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        weights: np.ndarray,
        n_nodes: int,
        max_iters: int = 128,
        tol: float = 1e-10,
        backend: str = "auto",
        device: Union[str, torch.device, None] = None,
        mesh: Optional[Mesh] = None,
        axis: str = "corpus",
    ):
        """backend: 'device' (torch), 'native' (C++ float64 host solver), or
        'auto' — native for batches under the crossover, device above it.
        ``device``: "cuda" when None, or the mesh's first device under a
        mesh (the merge device, which holds the state)."""
        self.n_nodes = n_nodes
        self.backend = backend
        self.mesh = mesh if (mesh is not None and axis in mesh.shape) else None
        self.device = mesh_device(self.mesh, device)
        self._across = self.mesh is not None and self.mesh.process_count > 1
        self.max_iters = max_iters
        self.tol = tol
        self._native = None
        if backend in ("auto", "native"):
            from comorag_torch import native as _native

            self._native = _native if _native.available() else None
        self._src_host = np.asarray(src, np.int32)
        self._dst_host = np.asarray(dst, np.int32)
        self._w_host = np.asarray(weights, np.float32)

        strength = np.zeros(n_nodes, np.float64)
        np.add.at(strength, self._src_host, self._w_host)
        rate = np.zeros(len(self._src_host), np.float32)
        nz = strength[self._src_host] > 0
        rate[nz] = (self._w_host[nz] / strength[self._src_host[nz]]).astype(np.float32)
        order = np.argsort(self._dst_host, kind="stable")  # contiguous index_add_ targets
        devices = self.mesh.axis_devices(axis) if self.mesh is not None else [self.device]
        self._arcs = split_arcs(self._src_host[order], self._dst_host[order], rate[order], devices)
        self._dangling = torch.as_tensor((strength == 0).astype(np.float32), device=self.device)

    def routes_device(self, b: int) -> bool:
        """Whether a b-reset batch solves on the device (vs the native host
        solver) — the JAX package's rule (ppr.py:376), unchanged: under a
        mesh it compares the arcs of one shard with the crossover, and a
        small batch still takes the float64 host solver. Over a mesh that
        spans processes every batch solves on the devices."""
        if self._native is None or self.backend == "device" or self._across:
            return True
        if self.backend == "native":
            return False
        arcs_per_shard = max(len(self._src_host) // len(self._arcs), 1)
        return b * arcs_per_shard >= CROSSOVER_BATCH_ARCS

    def _tol(self) -> float:
        # fp32 L1 error floors near ~1e-7: a tighter tol would spin to
        # max_iters without improving the ranking (as ppr.py:521)
        return max(self.tol, 1e-7)

    def query_topk(
        self,
        seed_idx: np.ndarray,       # [B, S] node ids (padding: weight 0)
        seed_w: np.ndarray,         # [B, S] sparse seed weights
        prior_idx: np.ndarray,      # [n_sel] nodes that get the dense prior and are ranked
        prior_w,                    # [B, n_sel] dense prior, a device tensor or host array
        k: int,
        damping: float = 0.5,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Seeds -> PPR -> top-k over ``prior_idx`` nodes in one device pass
        (ppr.py:394; under a mesh over the arc pieces, ppr.py:462-467):
        resets are built on the device from sparse seeds plus the
        device-resident prior, and only [B, k] comes back. Returns (scores
        [B, k], positions [B, k]) as host numpy, positions indexing into
        ``prior_idx``; ties go to the lowest position."""
        dev = self.device
        vals, pos = seed_ppr_topk(
            self._arcs, self._dangling, torch.as_tensor(np.asarray(seed_idx, np.int64), device=dev),
            torch.as_tensor(np.asarray(seed_w, np.float32), device=dev),
            torch.as_tensor(np.asarray(prior_idx, np.int64), device=dev),
            torch.as_tensor(prior_w, dtype=torch.float32, device=dev), float(damping), self._tol(),
            self.max_iters, k, self._across)
        return vals.cpu().numpy(), pos.cpu().numpy()

    def query(self, resets: np.ndarray, damping: float = 0.5) -> np.ndarray:
        """resets: [B, n_nodes] or [n_nodes] nonnegative; returns PPR scores
        [B, n_nodes] (host numpy)."""
        resets = np.atleast_2d(np.asarray(resets, np.float32))
        b, n = resets.shape
        if n != self.n_nodes:
            raise ValueError(f"resets width {n} != n_nodes {self.n_nodes}")
        resets = np.where(np.isnan(resets) | (resets < 0), 0.0, resets).astype(np.float32)
        sums = resets.sum(axis=1, keepdims=True)
        if (sums == 0).any():
            raise ValueError(
                f"PPR reset rows {np.nonzero(sums[:, 0] == 0)[0].tolist()} are "
                "all-zero after sanitization (no seeds, no prior) — a zero "
                "reset has no stationary distribution to rank by"
            )
        resets = resets / sums
        if not self.routes_device(b):
            out: Optional[np.ndarray] = self._native.ppr(
                self._src_host, self._dst_host, self._w_host, self.n_nodes, resets,
                damping=float(damping), tol=self.tol, max_iters=self.max_iters,
            )
            if out is not None:
                return out
        r = torch.as_tensor(resets.T.copy(), device=self.device)
        return ppr_iterate(self._arcs, self._dangling, r, float(damping), self._tol(), self.max_iters,
                           self._across).T.cpu().numpy()


def ppr_dense_reference(
    src: np.ndarray,
    dst: np.ndarray,
    weights: np.ndarray,
    n_nodes: int,
    reset: np.ndarray,
    damping: float = 0.5,
    iters: int = 500,
) -> np.ndarray:
    """Slow dense numpy fixed-point solver, for tests only (ppr.py:550)."""
    P = np.zeros((n_nodes, n_nodes), np.float64)
    for s, d, w in zip(src, dst, weights):
        P[s, d] += w
    strength = P.sum(axis=1)
    r = np.asarray(reset, np.float64)
    r = r / r.sum()
    x = r.copy()
    for _ in range(iters):
        nz = strength > 0
        flowed = (x[nz, None] * P[nz] / strength[nz, None]).sum(axis=0)
        dangling = x[~nz].sum()
        x = (1 - damping) * r + damping * (flowed + dangling * r)
    return x
