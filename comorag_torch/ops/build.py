"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers, so
a build takes seconds, not minutes) and compiles at first use into
``build/comorag_torch/lib<name>_<hash>.so`` at the repository root. The
hash covers the source, the shared ``csrc/*.cuh`` headers and the flags,
so an edit rebuilds and a stale library is never loaded. Only sources in
the repository are compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "build", "comorag_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> str:
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    h = hashlib.sha256()
    for src in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (compiled on first call)."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        so_path = library_path(name)
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so_path}.tmp{os.getpid()}"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr[-4000:]}")
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        lib.comorag_error_string.restype = ctypes.c_char_p
        lib.comorag_error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
        return lib


def load_all(names) -> list:
    """``load`` for several sources at once: one nvcc per source, all
    started together."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(load, names))


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if rc != 0:
        msg = lib.comorag_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


class LaunchCounter:
    """Counts a wrapper's kernel launches (bumped only where the kernel is
    launched, never on the plain path), so a run can show that the main
    path went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n
