"""SQLite response cache for LLM calls.

Capability parity with the reference's sqlite cache decorator
(llm/openai_gpt.py:26-102): key = sha256 of (messages, model, seed,
temperature); value = (text, metadata JSON). Thread-safe via per-THREAD
long-lived connections — WAL gives concurrent readers and serializes
writers itself, so a process-global lock would only re-serialize the
16-thread batch_infer fan-out (and per-call connections re-paid the
connect + PRAGMA round-trip on every get). Multi-process safety comes
from sqlite's own locking via the busy timeout.

Copy of ``comorag_tpu/llm/cache.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import sqlite3
import threading
from typing import Any, Dict, Optional, Tuple


class ResponseCache:
    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()
        self._init_db()

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30.0)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA busy_timeout=30000")
            self._local.conn = conn
        return conn

    def _init_db(self) -> None:
        conn = self._conn()
        with conn:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS cache ("
                "key TEXT PRIMARY KEY, message TEXT, metadata TEXT)"
            )

    @staticmethod
    def make_key(messages, model=None, seed=None, temperature=None, extra=None) -> str:
        """``extra``: any additional generation parameters that change the
        response (response_format, n, ...) — a guided-JSON call must never
        be served a cached free-text response or vice versa."""
        body = {"messages": messages, "model": model, "seed": seed, "temperature": temperature}
        if extra:
            # only when present, so plain-call keys (the overwhelmingly
            # common case) stay compatible with existing cache files
            body["extra"] = extra
        payload = json.dumps(body, sort_keys=True, default=str)
        return hashlib.sha256(payload.encode()).hexdigest()

    def get(self, key: str) -> Optional[Tuple[str, Dict[str, Any]]]:
        row = self._conn().execute(
            "SELECT message, metadata FROM cache WHERE key = ?", (key,)
        ).fetchone()
        if row is None:
            return None
        return row[0], json.loads(row[1])

    def put(self, key: str, message: str, metadata: Dict[str, Any]) -> None:
        conn = self._conn()
        with conn:  # commit; WAL + busy_timeout serialize cross-thread writers
            conn.execute(
                "INSERT OR REPLACE INTO cache (key, message, metadata) VALUES (?, ?, ?)",
                (key, message, json.dumps(metadata)),
            )
