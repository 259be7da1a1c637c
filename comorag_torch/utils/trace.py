"""Lightweight tracing / metrics for the pipeline.

The reference has no tracing at all (SURVEY.md §5 — tqdm bars and ad-hoc
dumps are the closest thing). This module provides the framework's own
observability layer:

  - ``span(name)``: context manager recording wall-time into a process-wide
    registry (thread-safe; spans aggregate by name: count/total/max),
  - ``count(name, n)``: monotonic counters (LLM calls, cache hits,
    device dispatches, ...),
  - ``gauge(name, value)``: last-write-wins point-in-time values
    (graph census at finalize, pool sizes, ...),
  - ``summary()`` / ``dump(path)``: snapshot for logs or a JSON artifact
    (written next to the QA results by the orchestrator).

Zero overhead when disabled (COMORAG_TRACE=0 turns spans into no-ops).

Copy of ``comorag_tpu/utils/trace.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator

_LOCK = threading.Lock()
_SPANS: Dict[str, Dict[str, float]] = {}
_COUNTERS: Dict[str, float] = {}
_GAUGES: Dict[str, float] = {}
_ENABLED = os.environ.get("COMORAG_TRACE", "1") not in ("0", "false", "off")


def enabled() -> bool:
    return _ENABLED


@contextmanager
def span(name: str) -> Iterator[None]:
    if not _ENABLED:
        yield
        return
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        with _LOCK:
            s = _SPANS.setdefault(name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            s["count"] += 1
            s["total_s"] += elapsed
            s["max_s"] = max(s["max_s"], elapsed)


def count(name: str, n: float = 1) -> None:
    if not _ENABLED:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def gauge(name: str, value: float) -> None:
    if not _ENABLED:
        return
    with _LOCK:
        _GAUGES[name] = value


def summary() -> Dict[str, Dict]:
    with _LOCK:
        spans = {
            k: {
                "count": v["count"],
                "total_s": round(v["total_s"], 4),
                "mean_s": round(v["total_s"] / max(v["count"], 1), 4),
                "max_s": round(v["max_s"], 4),
            }
            for k, v in sorted(_SPANS.items())
        }
        counters = dict(sorted(_COUNTERS.items()))
        gauges = dict(sorted(_GAUGES.items()))
    return {"spans": spans, "counters": counters, "gauges": gauges}


def dump(path: str) -> None:
    if not _ENABLED:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(summary(), f, indent=2)


def reset() -> None:
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()
        _GAUGES.clear()
