"""JSONL helpers used by the CLI entry points and dataset loaders.

Capability parity with the reference's inline load/save_jsonl pairs
(script/chunk_doc_corpus.py:13-24 and main.py's dataset loading).

Copy of ``comorag_tpu/utils/jsonio.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    rows: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def save_jsonl(rows: Iterable[Dict[str, Any]], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")


def save_json(obj: Any, path: str, indent: int = 2) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False, indent=indent)


def load_json(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)
