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
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from comorag_torch.device import resolve_device
from comorag_torch.ops.topk import exact_topk

# batch x arcs at which the device solve beats the native host solver, as
# measured for the JAX package (ops/device_profile.py); the rule is kept
# unchanged until the crossover is re-derived on the H100 (ROADMAP)
CROSSOVER_BATCH_ARCS = 16_000_000


def ppr_iterate(src: torch.Tensor, dst: torch.Tensor, rate: torch.Tensor,
                is_dangling: torch.Tensor, resets_nb: torch.Tensor, alpha: float,
                tol: float, max_iters: int) -> torch.Tensor:
    """Power iteration over an [N, B] state (ppr.py:106 ``_ppr_iterate_nb``).
    Columns that converge early keep iterating until the worst one does."""
    x = resets_nb
    for _ in range(max_iters):
        flowed = torch.zeros_like(x).index_add_(0, dst, x[src] * rate[:, None])
        dangling_mass = (x * is_dangling[:, None]).sum(dim=0)
        new_x = (1.0 - alpha) * resets_nb + alpha * (flowed + dangling_mass[None, :] * resets_nb)
        err = (new_x - x).abs().sum(dim=0).max()
        x = new_x
        if not bool(err > tol):
            break
    return x


def _normalize_columns(rt: torch.Tensor) -> torch.Tensor:
    rt = torch.where(torch.isnan(rt) | (rt < 0), torch.zeros_like(rt), rt)
    sums = rt.sum(dim=0, keepdim=True)
    return rt / torch.where(sums == 0, torch.ones_like(sums), sums)


class PPRGraph:
    """Graph for batched PPR queries, arcs resident on one device."""

    def __init__(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        weights: np.ndarray,
        n_nodes: int,
        max_iters: int = 128,
        tol: float = 1e-10,
        backend: str = "auto",
        device: Union[str, torch.device] = "cuda",
    ):
        """backend: 'device' (torch), 'native' (C++ float64 host solver), or
        'auto' — native for batches under the crossover, device above it."""
        self.n_nodes = n_nodes
        self.backend = backend
        self.device = resolve_device(device)
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
        to_dev = lambda a, dt: torch.as_tensor(a, dtype=dt, device=self.device)  # noqa: E731
        self._src = to_dev(self._src_host[order], torch.int64)
        self._dst = to_dev(self._dst_host[order], torch.int64)
        self._rate = to_dev(rate[order], torch.float32)
        self._dangling = to_dev((strength == 0).astype(np.float32), torch.float32)

    def routes_device(self, b: int) -> bool:
        """Whether a b-reset batch solves on the device (vs the native host
        solver) — the JAX package's rule (ppr.py:376), unchanged."""
        if self._native is None or self.backend == "device":
            return True
        if self.backend == "native":
            return False
        return b * max(len(self._src_host), 1) >= CROSSOVER_BATCH_ARCS

    def _iterate(self, resets_nb: torch.Tensor, damping: float) -> torch.Tensor:
        # fp32 L1 error floors near ~1e-7: a tighter tol would spin to
        # max_iters without improving the ranking (as ppr.py:521)
        return ppr_iterate(self._src, self._dst, self._rate, self._dangling, resets_nb,
                           float(damping), max(self.tol, 1e-7), self.max_iters)

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
        (ppr.py:394): resets are built on the device from sparse seeds plus
        the device-resident prior, and only [B, k] comes back. Returns
        (scores [B, k], positions [B, k]) as host numpy, positions indexing
        into ``prior_idx``; ties go to the lowest position."""
        dev = self.device
        seed_idx = torch.as_tensor(np.asarray(seed_idx, np.int64), device=dev)
        seed_w = torch.as_tensor(np.asarray(seed_w, np.float32), device=dev)
        prior_idx_t = torch.as_tensor(np.asarray(prior_idx, np.int64), device=dev)
        prior_w = torch.as_tensor(prior_w, dtype=torch.float32, device=dev)
        b = seed_w.shape[0]
        cols = torch.arange(b, device=dev)[None, :].expand(seed_idx.shape[1], b)
        rt = torch.zeros((self.n_nodes, b), dtype=torch.float32, device=dev)
        rt.index_put_((seed_idx.T, cols), seed_w.T, accumulate=True)
        rt.index_add_(0, prior_idx_t, prior_w.T)
        ranks = self._iterate(_normalize_columns(rt), damping)
        doc = ranks.index_select(0, prior_idx_t).T  # [B, n_sel]
        vals, pos = exact_topk(doc, min(k, doc.shape[1]))
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
        return self._iterate(r, damping).T.cpu().numpy()


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
