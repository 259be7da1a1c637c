"""Host-facing MIPS index over one embedding matrix, on one device.

Port of ``comorag_tpu/retrieval/index.py`` ``MipsIndex`` (:237). One index
per memory layer (veridical chunks, facts, entities, semantic summaries,
episodic timeline). It owns the device copy of the matrix (fp32, bf16
storage scored with fp32 sums, or per-row int8) and an asynchronous host
protocol: every query launches on the current CUDA stream and returns a
handle whose results are already being copied into pinned host memory
(``non_blocking=True`` plus a CUDA event, where JAX uses
``copy_to_host_async``); ``result()`` waits on that handle's copy alone.

Routes (``resolve_route``, the JAX resolution of index.py:255-346 with
"on the TPU" read as "on CUDA"): ``method="pallas"`` on a CUDA device with
at least 512 rows runs the streaming top-k kernels (``ops/mips.py``) over
fp32, bf16 or int8 rows; ``scan_dtype`` "int8" / "bfloat16" (or "auto",
which picks "int8" for fp32 XLA-route indexes of 1,024 rows or more) runs
the certified two-pass: a compressed scan, an exact fp32 rescore of a
candidate pool, and a per-row exactness flag whose rows are rescued by an
fp32 single pass (``TwoPassHandle``); everything else is the plain exact
single pass. ``exact=False`` is served exact (JAX's approximate selection
exists only on the TPU), and ``tile_n`` is accepted for the TPU kernel's
tile size; the CUDA kernels size their own tiles (it still sets the
shard boundaries of the kernel route under a mesh, as in JAX).

Corpus sharding (index.py:266-289): with a mesh whose ``axis`` has
n_shards > 1 devices and at least ``n_shards * min_rows_per_shard`` rows,
the rows are split over that axis's devices in JAX's boundaries (shards
of ``n_pad // n_shards`` rows; the last shards hold what is left, which
may be nothing) and every query runs the sharded programs of
``ops/topk.py``: one local call per shard (on the kernel route, one
kernel launch per non-empty shard), merged on the mesh's first device,
where the handles start their host copies. Under a mesh the index's
device arrays (``corpus``, ``scales``, ``scan_corpus``, ``scan_scales``)
are lists of per-shard tensors in shard order. An index that does not
shard lives on the mesh's first device.

Over a mesh that spans processes (``parallel/distributed.py``) every
process builds the index from the same host matrix and places only the
shards of its own positions (None at the others), as
``jax.device_put(host, NamedSharding(...))`` keeps each process's
addressable shards; every process must then make the same calls in the
same order, and gets the same results (the programs' collectives meet
inside each call). A two-pass flag is reduced over the processes, so a
rescue and the adaptive pool margin are decided alike everywhere.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from comorag_torch.device import HostCopy
from comorag_torch.ops import mips
from comorag_torch.ops.topk import (
    bf16_scan_corpus,
    dense_scores,
    exact_topk,
    int8_scores,
    make_sharded_scores,
    make_sharded_topk,
    make_sharded_topk_min,
    make_sharded_two_pass_topk,
    quantize_int8,
    quantize_int8_residual,
    stats_from_scores,
    topk_min_from_scores,
    two_pass_topk,
)
from comorag_torch.parallel.mesh import Mesh, is_local_device, mesh_device, shard_bounds
from comorag_torch.utils import trace
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Adaptive two-pass margin (index.py:58-65): grow the candidate pool when a
# batch rescues more than _TIE_RATE_GROW of its rows; once the margin is at
# its max and more than _TIE_RATE_OFF still rescue, serve this index fp32.
_TIE_MARGIN_MAX = 192
_TIE_RATE_GROW = 0.02
_TIE_RATE_OFF = 0.20
PALLAS_MIN_ROWS = 512  # index.py:280
_SCAN_AUTO_MIN_ROWS = 1024  # index.py:341


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_route(n: int, dtype: str, method: str, scan_dtype: Optional[str],
                  device_type: str) -> Tuple[str, Optional[str]]:
    """(method, scan_dtype) an index of ``n`` rows serves with, as the JAX
    index resolves them (index.py:279-346; its on-TPU test is
    ``device_type == "cuda"`` here). ``"pallas"`` needs CUDA and 512 rows;
    the two-pass needs fp32 storage on the XLA route; ``"auto"`` asks for
    the int8 two-pass from 1,024 rows on."""
    method = method if (method == "pallas" and n >= PALLAS_MIN_ROWS and device_type == "cuda") else "xla"
    if scan_dtype == "auto":
        scan_dtype = "int8" if (dtype == "float32" and method != "pallas" and n >= _SCAN_AUTO_MIN_ROWS) else None
    if not scan_dtype or dtype != "float32" or method == "pallas":
        return method, None
    if scan_dtype in ("bfloat16", "bf16"):
        return method, "bfloat16"
    if scan_dtype != "int8":
        raise ValueError(f"scan_dtype must be 'auto', 'int8', 'bfloat16' or None, got {scan_dtype!r}")
    return method, "int8"


class TopkHandle:
    """An in-flight top-k query: device work queued, host copy started."""

    def __init__(self, vals: torch.Tensor, idx: torch.Tensor):
        self._copies = (HostCopy(vals), HostCopy(idx))

    def prepare(self) -> None:
        """Pipelined-drain hook (no rescue pass to launch here)."""

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [P, k] float32 descending, ids [P, k] int64)."""
        return self._copies[0].numpy(), self._copies[1].numpy()


class TwoPassHandle:
    """In-flight certified two-pass top-k (index.py:110): scores, ids and
    a per-row exactness flag, each copying to pinned host memory. A flagged
    row (its k-th rescored value did not clear the scan pool boundary by
    the sound error bound: real ties at the boundary) is rescued by one fp32
    single pass over just the flagged rows, launched by ``prepare()``
    without waiting on it; ``topk_many`` calls ``prepare()`` on every
    handle before it resolves any, so rescues overlap the drain."""

    def __init__(self, vals: torch.Tensor, idx: torch.Tensor, flag: torch.Tensor, k: int,
                 rescue, on_rate):
        self._copies = (HostCopy(vals), HostCopy(idx))
        self._flag = HostCopy(flag)
        self._p = int(flag.shape[0])
        self._k = k
        self._rescue = rescue  # rows -> TopkHandle (fp32 exact, async)
        self._on_rate = on_rate  # index feedback: fraction of rows rescued
        self._rescue_state: Optional[Tuple[np.ndarray, Optional[TopkHandle]]] = None

    def prepare(self) -> None:
        """Wait for this handle's flag column alone and launch the fp32
        rescue of the flagged rows, if any."""
        if self._rescue_state is not None:
            return
        rows = np.nonzero(self._flag.numpy())[0]
        trace.count("two_pass.batches")
        self._on_rate(rows.size / max(self._p, 1))
        if rows.size:
            trace.count("two_pass.rescued_batches")
            trace.count("two_pass.rescued_rows", int(rows.size))
            logger.debug("two-pass: exactness certificate flagged %d/%d rows — "
                         "per-row fp32 rescue dispatched", int(rows.size), self._p)
            self._rescue_state = (rows, self._rescue(rows))
        else:
            self._rescue_state = (rows, None)

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        self.prepare()
        scores = self._copies[0].numpy()[:, : self._k]
        idx = self._copies[1].numpy()[:, : self._k]
        rows, handle = self._rescue_state
        if handle is not None:
            r_scores, r_idx = handle.result()
            scores, idx = scores.copy(), idx.copy()
            scores[rows] = r_scores
            idx[rows] = r_idx
        return scores, idx


class _SharedHandle:
    """One coalesced dispatch shared by several fan-out batches
    (``topk_many`` group coalescing, index.py:175): resolves its inner
    handle once."""

    def __init__(self, inner):
        self._inner = inner
        self._out: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def prepare(self) -> None:
        self._inner.prepare()

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._out is None:
            self._out = self._inner.result()
        return self._out


class _SliceHandle:
    """Rows [lo, hi) of a coalesced group's result: what the batch would
    have got from its own dispatch (scan, rescore and certificate are all
    row-independent); copies, so callers cannot alias sibling batches."""

    def __init__(self, shared: _SharedHandle, lo: int, hi: int):
        self._shared = shared
        self._lo = lo
        self._hi = hi

    def prepare(self) -> None:
        self._shared.prepare()

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        scores, idx = self._shared.result()
        return scores[self._lo : self._hi].copy(), idx[self._lo : self._hi].copy()


class TopkMinHandle:
    """In-flight top-k + row-min query: the fact-linking fetch."""

    def __init__(self, vals: torch.Tensor, idx: torch.Tensor, row_min: torch.Tensor):
        self._copies = (HostCopy(vals), HostCopy(idx), HostCopy(row_min))

    def result(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(scores [P, k] desc, idx [P, k], row_min [P])."""
        return tuple(c.numpy() for c in self._copies)


class ScoresHandle:
    """In-flight full-score query [P, N]."""

    def __init__(self, dev: Optional[torch.Tensor], p: int, n: int, eager_copy: bool = True):
        self._dev = dev
        self._p = p
        self._n = n
        self._copy = HostCopy(dev) if dev is not None and eager_copy else None

    def result(self) -> np.ndarray:
        if self._dev is None:
            return np.zeros((self._p, 0), np.float32)
        if self._copy is None:
            self._copy = HostCopy(self._dev)
        return self._copy.numpy()

    def device_scores(self) -> Tuple[Optional[torch.Tensor], int, int]:
        """(device scores [P, N], p, n) without forcing the host copy: the
        fused PPR prior reads the scores where they are."""
        return self._dev, self._p, self._n


class ScoresStatsHandle(ScoresHandle):
    """Dense scoring whose host transfer is only (top-k, row min, row
    sum); the dense matrix stays on the device and downloads on demand."""

    def __init__(self, dev: Optional[torch.Tensor], p: int, n: int, k: int):
        super().__init__(dev, p, n, eager_copy=False)
        self._stats = None
        if dev is not None:
            self._stats = tuple(HostCopy(t) for t in stats_from_scores(dev, k))

    def stats(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(top-k vals [P, k] desc, idx [P, k] int64, row_min [P], row_sum [P])."""
        if self._stats is None:
            z = np.zeros((self._p, 0), np.float32)
            return z, z.astype(np.int64), np.zeros(self._p, np.float32), np.zeros(self._p, np.float32)
        return tuple(c.numpy() for c in self._stats)

    def result_rows(self, rows: np.ndarray) -> np.ndarray:
        """Dense scores for a row subset, [len(rows), N] (host-PPR branch)."""
        if self._dev is None:
            return np.zeros((len(rows), 0), np.float32)
        sel = torch.as_tensor(np.asarray(rows, np.int64), device=self._dev.device)
        return HostCopy(self._dev.index_select(0, sel)).numpy()


def _no_hits(p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [p, 0], ids [p, 0]): the top-k of an empty index."""
    return torch.zeros((p, 0)), torch.zeros((p, 0), dtype=torch.int64)


QueryLike = Union[np.ndarray, torch.Tensor, Sequence[float]]


class MipsIndex:
    def __init__(
        self,
        matrix: np.ndarray,  # [N, d] float32 (host)
        device: Union[str, torch.device, None] = None,  # "cuda" when None; the mesh's first device under a mesh
        dtype: str = "float32",  # "float32" | "bfloat16" | "int8" storage/scoring
        method: str = "xla",  # "xla" | "pallas" (the streaming top-k kernels)
        scan_dtype: Optional[str] = "auto",  # "auto" | "int8" | "bfloat16" | None: certified two-pass
        scan_candidates: Optional[int] = None,  # floor of the two-pass candidate pool per query
        tile_n: int = 512,  # the TPU kernel's corpus tile (ComoConfig.topk_block_rows)
        mesh: Optional[Mesh] = None,
        axis: str = "corpus",
        min_rows_per_shard: int = 256,
    ):
        self.device = mesh_device(mesh, device)
        matrix = np.asarray(matrix, np.float32)
        self.n = int(matrix.shape[0])
        self.dim = int(matrix.shape[1]) if matrix.ndim == 2 and matrix.shape[1] else 1
        self.method, self.scan_dtype = resolve_route(self.n, dtype, method, scan_dtype, self.device.type)
        if scan_dtype not in (None, "auto") and self.scan_dtype is None:
            logger.warning("scan_dtype=%s needs fp32 storage on the XLA route; disabled", scan_dtype)
        self._scan_auto = scan_dtype == "auto"
        self.scan_candidates = scan_candidates
        self.tile_n = max(32, _round_up(int(tile_n), 32))
        # a mesh without this index's axis, or a layer too small to be worth
        # sharding, keeps the index on one device (index.py:266-275)
        n_shards = mesh.shape.get(axis, 1) if mesh is not None else 1
        self.mesh = mesh if (n_shards > 1 and self.n >= n_shards * min_rows_per_shard) else None
        self.n_shards = n_shards if self.mesh is not None else 1
        self.axis = axis
        # JAX's shard rows (index.py:282-289): each shard's two-pass pool,
        # and so its flag, depends on these boundaries
        pad_to = self.tile_n * self.n_shards if self.method == "pallas" else max(8, 8 * self.n_shards)
        n_pad = max(_round_up(max(self.n, 1), pad_to), self.n_shards * 8)
        self.shard_rows = n_pad // self.n_shards
        # adaptive pool margin (index.py:297-309): a rescue-heavy batch
        # widens the pool of later dispatches; exhausted, the index serves
        # fp32 single-pass (benign races between query threads: int writes)
        self._tie_margin = 0
        self._scan_off = False
        self.int8 = dtype == "int8"
        self.dtype = torch.bfloat16 if dtype in ("bfloat16", "bf16") else torch.float32
        host = matrix.reshape(self.n, self.dim)
        if self.int8:
            q, scales = quantize_int8(host)
            self.corpus, self.scales = self._place(q), self._place(scales)
        else:
            self.corpus = self._place(torch.tensor(host).to(self.dtype))
            self.scales = None
        # the two-pass scan copy (2 bytes/element) sits next to the fp32
        # matrix, with the sound bound of its certificate (index.py:328-368)
        self.scan_corpus = self.scan_scales = self.scan_bound = None
        if self.scan_dtype and self.n:
            if self.scan_dtype == "int8":
                cat, s1, bound = quantize_int8_residual(host)
                self.scan_corpus, self.scan_scales = self._place(cat), self._place(s1)
            else:
                hat16, bound = bf16_scan_corpus(host)
                self.scan_corpus = self._place(hat16)
            self.scan_bound = torch.tensor(bound, dtype=torch.float32, device=self.device)

    def _place(self, rows) -> Union[torch.Tensor, List[torch.Tensor]]:
        """A host array on this index's device, or under a mesh its row
        shards, each on its device of the mesh axis (contiguous copies;
        None at a position another process owns)."""
        rows = torch.as_tensor(rows)
        if self.mesh is None:
            return rows.to(self.device)
        bounds = shard_bounds(self.n, self.n_shards, self.shard_rows)
        return [rows[r.start : r.stop].to(dev).contiguous() if is_local_device(dev) else None
                for r, dev in zip(bounds, self.mesh.axis_devices(self.axis))]

    # ------------------------------------------------------------ scoring
    def _prep_queries(self, queries: QueryLike) -> Tuple[torch.Tensor, int]:
        """[P, d] fp32 queries on this index's device. Device-resident
        queries (straight off the encoder) skip the host upload."""
        if isinstance(queries, torch.Tensor):
            q = torch.atleast_2d(queries).to(device=self.device, dtype=torch.float32)
        else:
            q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)), device=self.device)
        return q, int(q.shape[0])

    def _scores(self, q: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None:
            return make_sharded_scores(self.mesh, int8=self.int8)(q, self.corpus, self.scales)
        if self.int8:
            return int8_scores(q, self.corpus, self.scales)
        return dense_scores(q, self.corpus)

    # ------------------------------------------------------------------ topk
    def topk_async(self, queries: QueryLike, k: int, exact: bool = True,
                   _force_fp32: bool = False) -> Union[TopkHandle, TwoPassHandle]:
        """Launch top-k and start the host copy. ``queries`` may be [d] or
        [P, d]; k is clipped to N. Always exact, ties to the lowest id
        (``exact=False`` is accepted and served exact)."""
        q, p = self._prep_queries(queries)
        if self.n == 0:
            return TopkHandle(*_no_hits(p))
        k_eff = min(k, self.n)
        k_pad = _round_up(k_eff, 8)
        # the pool rule of index.py:422-432: the large-k route checks the
        # BASE pool; a margin grown against rescue storms may pass it
        base_c = max(self.scan_candidates or 0, _round_up(k_pad + 8, 8), 64)
        # under a mesh the pool is per shard (index.py:422)
        c_cap = self.shard_rows if self.mesh is not None else self.n
        c = min(base_c + (self._tie_margin if self._scan_auto else 0), c_cap)
        use_scan = (bool(self.scan_dtype) and not _force_fp32
                    and not (self._scan_auto and (base_c > 256 or self._scan_off)))
        if use_scan:
            def rescue(rows, _q=q):
                sel = torch.as_tensor(rows, dtype=torch.int64, device=_q.device)
                return self.topk_async(_q.index_select(0, sel), k, exact, _force_fp32=True)

            # feedback bound to THIS dispatch's margin, so a stale handle
            # resolved after growth does not grow it twice
            def on_rate(frac, _margin=self._tie_margin):
                self._note_rescue_rate(frac, _margin)

            if self.mesh is not None:
                vals, idx, flag = make_sharded_two_pass_topk(self.mesh, k_pad, c, self.shard_rows)(
                    q, self.scan_corpus, self.scan_scales, self.corpus, self.scan_bound)
            else:
                vals, idx, flag = two_pass_topk(q, self.scan_corpus, self.scan_scales, self.corpus,
                                                self.scan_bound, k_pad, c)
            return TwoPassHandle(vals, idx, flag, k_eff, rescue, on_rate)
        if self.mesh is not None:
            fn = make_sharded_topk(self.mesh, k_eff, method=self.method, int8=self.int8, shard_rows=self.shard_rows)
            return TopkHandle(*fn(q, self.corpus, self.scales))
        if self.method == "pallas":
            if self.int8:
                return TopkHandle(*mips.mips_topk_int8(q, self.corpus, self.scales, k_eff))
            return TopkHandle(*mips.mips_topk(q, self.corpus, k_eff))
        return TopkHandle(*exact_topk(self._scores(q), k_eff))

    def _note_rescue_rate(self, frac: float, dispatch_margin: int) -> None:
        """Adaptive-margin feedback from a resolved two-pass batch
        (index.py:537): a rescue-heavy batch means the pool boundary sits
        in a near-tie cluster, so widen the pool of later dispatches.
        Exactness is never at stake (rescued rows are fp32-exact)."""
        if not self._scan_auto or frac <= _TIE_RATE_GROW:
            return
        if dispatch_margin < self._tie_margin:
            return  # stale handle: growth already happened
        if self._tie_margin >= _TIE_MARGIN_MAX:
            if frac > _TIE_RATE_OFF and not self._scan_off:
                self._scan_off = True
                trace.count("two_pass.margin_exhausted")
                logger.info("two-pass: %.0f%% of rows still rescue at max pool margin %d — "
                            "falling back to single-pass fp32 for this index",
                            frac * 100, self._tie_margin)
            return
        self._tie_margin = min(max(self._tie_margin * 2, 48), _TIE_MARGIN_MAX)
        trace.count("two_pass.margin_grown")
        logger.debug("two-pass: %.0f%% of rows rescued — pool margin grown to +%d",
                     frac * 100, self._tie_margin)

    def topk(self, queries: QueryLike, k: int, exact: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [P, k], indices [P, k]) as host numpy, descending."""
        return self.topk_async(queries, k, exact).result()

    def topk_many(self, query_batches: Sequence[QueryLike], k: int, exact: bool = True,
                  window: int = 64, group_rows: int = 256) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Top-k for many query batches (index.py:569): consecutive batches
        are coalesced into dispatches of up to ``group_rows`` query rows
        (host and device batches separately) and the results split back per
        batch. At most ``window`` dispatches are in flight; ``prepare()``
        (which launches any two-pass rescue) runs on every handle before
        any is resolved."""
        query_batches = list(query_batches)
        ready: list = []
        handles: list = []

        def _rows(q) -> int:
            return 1 if np.ndim(q) == 1 else int(np.shape(q)[0])

        def _flush(buf: list) -> None:
            if not buf:
                return
            if len(buf) == 1:
                handles.append(self.topk_async(buf[0], k, exact))
                return
            if isinstance(buf[0], torch.Tensor):
                qcat = torch.cat([torch.atleast_2d(q) for q in buf], dim=0)
            else:
                qcat = np.concatenate([np.atleast_2d(np.asarray(q, np.float32)) for q in buf], axis=0)
            shared = _SharedHandle(self.topk_async(qcat, k, exact))
            lo = 0
            for q in buf:
                handles.append(_SliceHandle(shared, lo, lo + _rows(q)))
                lo += _rows(q)

        pend: list = []
        pend_rows = 0
        for q in query_batches:
            p = _rows(q)
            same_kind = not pend or isinstance(q, torch.Tensor) == isinstance(pend[0], torch.Tensor)
            if pend and (pend_rows + p > group_rows or not same_kind):
                _flush(pend)
                pend, pend_rows = [], 0
            pend.append(q)
            pend_rows += p
            if pend_rows >= group_rows:
                _flush(pend)
                pend, pend_rows = [], 0
            while len(handles) >= window:
                h = handles.pop(0)
                h.prepare()
                ready.append(h)
        _flush(pend)
        for h in handles:
            h.prepare()
        ready.extend(handles)
        return [h.result() for h in ready]

    def topk_min_async(self, queries: QueryLike, k: int) -> TopkMinHandle:
        """Top-k + per-row min in one fetch (the fact-linking path)."""
        q, p = self._prep_queries(queries)
        if self.n == 0:
            return TopkMinHandle(*_no_hits(p), torch.zeros(p))
        if self.mesh is not None:
            fn = make_sharded_topk_min(self.mesh, min(k, self.n), int8=self.int8, shard_rows=self.shard_rows)
            return TopkMinHandle(*fn(q, self.corpus, self.scales))
        return TopkMinHandle(*topk_min_from_scores(self._scores(q), min(k, self.n)))

    # ----------------------------------------------------------- full scores
    def scores_async(self, queries: QueryLike) -> ScoresHandle:
        """Launch full [P, N] scoring and start the host copy."""
        q, p = self._prep_queries(queries)
        if self.n == 0:
            return ScoresHandle(None, p, 0)
        return ScoresHandle(self._scores(q), p, self.n)

    def scores(self, queries: QueryLike) -> np.ndarray:
        """Full raw inner-product scores [P, N] (host numpy)."""
        return self.scores_async(queries).result()

    def scores_stats_async(self, queries: QueryLike, k: int) -> ScoresStatsHandle:
        """Dense scoring whose host transfer is only (top-k, row min, row
        sum); the dense buffer stays on the device (``device_scores()``)."""
        q, p = self._prep_queries(queries)
        if self.n == 0:
            return ScoresStatsHandle(None, p, 0, 0)
        return ScoresStatsHandle(self._scores(q), p, self.n, min(k, self.n))
