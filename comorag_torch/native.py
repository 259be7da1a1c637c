"""ctypes loader for the native host runtime (csrc/comorag_native.cpp).

Compiles the C++ source on first use (g++ -O3, cached by source hash under
``build/comorag_torch/`` at the repository root) and exposes:

  - ``build_csr(src, dst, weights, n_nodes)`` — CSR adjacency (igraph-core
    replacement for graph materialization, reference ComoRAG.py:768-834)
  - ``ppr(src, dst, weights, n_nodes, resets, ...)`` — batched weighted
    personalized PageRank (PRPACK replacement, reference ComoRAG.py:1086-1105)
  - ``mips_topk(queries, corpus, k)`` — exact host top-k (no-accelerator
    fallback / oracle)

Everything degrades gracefully: ``available()`` is False when no compiler
is present, and callers fall back to numpy/JAX paths.

Copy of ``comorag_tpu/native.py`` for the port, which imports nothing of the JAX package;
the source is the port's own copy of ``native/comorag_native.cpp``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "comorag_native.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _cache_dir() -> str:
    # beside the CUDA kernels' libraries (ops/build.py), inside the checkout
    return os.path.join(os.path.dirname(_PKG), "build", "comorag_torch")


def _build() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_SRC):
        logger.warning("native source missing: %s", _SRC)
        return None
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = _cache_dir()
    os.makedirs(out_dir, exist_ok=True)
    so_path = os.path.join(out_dir, f"comorag_native_{digest}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except (subprocess.SubprocessError, OSError) as exc:
            logger.warning("native build failed (%s); using numpy/JAX fallbacks", exc)
            return None
    lib = ctypes.CDLL(so_path)
    lib.build_csr.argtypes = [
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.ppr_csr.restype = ctypes.c_int32
    lib.ppr_csr.argtypes = [
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.mips_topk.argtypes = [
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            _LIB = _build()
    return _LIB


def available() -> bool:
    return _get() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_csr(
    src: np.ndarray, dst: np.ndarray, weights: np.ndarray, n_nodes: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Arc list -> (indptr [n+1], indices [E], data [E])."""
    lib = _get()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    w = np.ascontiguousarray(weights, np.float32)
    e = len(src)
    # validate BEFORE crossing the ctypes boundary: an out-of-range node
    # id corrupts the C++ heap silently (the numpy fallback would raise),
    # and the int32 CSR offsets wrap past 2^31 arcs
    if e > np.iinfo(np.int32).max:
        raise ValueError(f"CSR offsets are int32: {e} arcs > 2^31-1")
    if e and (
        int(src.min()) < 0 or int(src.max()) >= n_nodes
        or int(dst.min()) < 0 or int(dst.max()) >= n_nodes
    ):
        raise ValueError(f"arc endpoints out of range [0, {n_nodes})")
    if lib is None:
        order = np.argsort(src, kind="stable")
        indptr = np.zeros(n_nodes + 1, np.int32)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr, dtype=np.int32)
        return indptr, dst[order].copy(), w[order].copy()
    indptr = np.zeros(n_nodes + 1, np.int32)
    indices = np.zeros(e, np.int32)
    data = np.zeros(e, np.float32)
    lib.build_csr(n_nodes, e, _i32p(src), _i32p(dst), _f32p(w), _i32p(indptr), _i32p(indices), _f32p(data))
    return indptr, indices, data


def ppr(
    src: np.ndarray,
    dst: np.ndarray,
    weights: np.ndarray,
    n_nodes: int,
    resets: np.ndarray,
    damping: float = 0.5,
    tol: float = 1e-10,
    max_iters: int = 128,
) -> Optional[np.ndarray]:
    """Batched personalized PageRank on host. Returns [B, n] scores, or
    None when the native library is unavailable."""
    lib = _get()
    if lib is None:
        return None
    indptr, indices, data = build_csr(src, dst, weights, n_nodes)
    resets = np.ascontiguousarray(np.atleast_2d(resets), np.float32)
    if resets.shape[1] != n_nodes:
        # the C++ kernel reads n_nodes floats per row with no width check:
        # a mismatched row stride reads out of bounds / misaligned and
        # returns silently wrong scores
        raise ValueError(f"resets width {resets.shape[1]} != n_nodes {n_nodes}")
    b = resets.shape[0]
    out = np.zeros((b, n_nodes), np.float32)
    lib.ppr_csr(
        n_nodes,
        _i32p(indptr),
        _i32p(indices),
        _f32p(data),
        b,
        _f32p(resets),
        ctypes.c_float(damping),
        ctypes.c_float(tol),
        max_iters,
        _f32p(out),
    )
    return out


def mips_topk(queries: np.ndarray, corpus: np.ndarray, k: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Exact host top-k. Returns (scores [P,k], ids [P,k]) or None."""
    lib = _get()
    if lib is None:
        return None
    queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
    corpus = np.ascontiguousarray(corpus, np.float32)
    p, d = queries.shape
    n = corpus.shape[0]
    k = min(k, n)
    scores = np.zeros((p, k), np.float32)
    ids = np.zeros((p, k), np.int32)
    lib.mips_topk(p, n, d, k, _f32p(queries), _f32p(corpus), _f32p(scores), _i32p(ids))
    return scores, ids.astype(np.int64)
