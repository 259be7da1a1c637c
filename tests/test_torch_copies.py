"""The port's copies of the JAX package's host modules stay equal to their
counterparts in code, so the formats the two packages share (parquet
stores, graph files, prompts, the native solver) cannot drift apart.

A Python copy is compared as a syntax tree after the rename ``comorag_tpu``
-> ``comorag_torch``, with docstrings dropped (comments are not in the
tree); the C++ copy is compared with its comments dropped. Top-level names
that differ on purpose are listed in ``DELIBERATE``."""

from __future__ import annotations

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = [
    "config.py", "types.py", "rerank.py", "native.py",
    "prompts/__init__.py", "prompts/manager.py", "prompts/linking.py",
    "prompts/templates/__init__.py", "prompts/templates/catalog.py",
    "utils/__init__.py", "utils/hashing.py", "utils/logging.py", "utils/trace.py", "utils/text.py",
    "utils/jsonio.py", "utils/json_repair.py", "utils/reqwindow.py",
    "llm/base.py", "llm/fake.py", "llm/openai_client.py", "llm/summarize.py", "llm/cache.py",
    "llm/guided.py",
    "ie/__init__.py", "ie/openie.py", "store/__init__.py", "store/embedding_store.py",
    "timeline/__init__.py", "timeline/summarizer.py",
    "agents/__init__.py", "agents/probe_agent.py", "agents/pool_agent.py",
    "models/base.py", "models/hash_encoder.py", "models/remote.py",
    "cli/chunk.py", "eval/__init__.py", "eval/qa_eval.py",
]

# the port builds its native library from its own source into the checkout's
# build/comorag_torch/, not from native/ into ~/.cache/comorag_native
DELIBERATE = {"native.py": {"_PKG", "_SRC", "_cache_dir"}}


def _defined(node: ast.stmt) -> set:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return {node.name}
    if isinstance(node, (ast.Assign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        return {t.id for t in targets if isinstance(t, ast.Name)}
    return set()


def _code(path: str, skip: set) -> list:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read().replace("comorag_tpu", "comorag_torch"))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or ([] if isinstance(node, ast.Module) else [ast.Pass()])
    return [ast.dump(n) for n in tree.body if not _defined(n) & skip]


@pytest.mark.parametrize("rel", COPIES)
def test_host_module_copy_matches_its_counterpart(rel):
    skip = DELIBERATE.get(rel, set())
    ours = _code(os.path.join(REPO, "comorag_torch", rel), skip)
    theirs = _code(os.path.join(REPO, "comorag_tpu", rel), skip)
    assert ours == theirs, f"comorag_torch/{rel} has drifted from comorag_tpu/{rel}"
    for name in skip:  # a listed difference still names something in both files
        assert any(name in _defined(n) for n in ast.parse(open(os.path.join(REPO, "comorag_torch", rel)).read()).body)


def _cpp_code(path: str) -> list:
    with open(path, encoding="utf-8") as f:
        text = re.sub(r"/\*.*?\*/", "", f.read(), flags=re.S)
    return [ln for ln in (re.sub(r"//.*", "", ln).strip() for ln in text.splitlines()) if ln]


def test_native_source_copy_matches_its_counterpart():
    assert _cpp_code(os.path.join(REPO, "comorag_torch", "csrc", "comorag_native.cpp")) == _cpp_code(
        os.path.join(REPO, "native", "comorag_native.cpp"))
