"""Defensive JSON parsing for LLM output.

The framework treats LLM responses as untrusted text. This module provides:
  - ``repair_json``: close unbalanced braces/brackets after truncation
    (capability parity with llm_utils.py:146-215; own implementation).
  - ``extract_json_object`` / ``extract_json_array``: pull the first JSON
    value out of surrounding prose, *without* ``eval`` (the reference uses
    ``eval`` on model output — openie_openai.py:37,46; we never do).
  - ``filter_valid_triples``: keep unique, exactly-3-element triples
    (llm_utils.py:218-250 semantics).

Copy of ``comorag_tpu/utils/json_repair.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from typing import Any, List, Optional


def _scan_state(text: str):
    """(open-bracket stack, in_string, last comma index OUTSIDE strings)."""
    stack: List[str] = []
    in_string = False
    escaped = False
    last_comma = -1
    for i, ch in enumerate(text):
        if in_string:
            if escaped:
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == '"':
                in_string = False
            continue
        if ch == '"':
            in_string = True
        elif ch in "{[":
            stack.append(ch)
        elif ch in "}]":
            if stack and ((ch == "}" and stack[-1] == "{") or (ch == "]" and stack[-1] == "[")):
                stack.pop()
        elif ch == ",":
            last_comma = i
    return stack, in_string, last_comma


def _close(text: str, stack: List[str], in_string: bool) -> str:
    if in_string:
        text += '"'
    closers = {"{": "}", "[": "]"}
    for opener in reversed(stack):
        text += closers[opener]
    return text


def repair_json(text: str) -> str:
    """Best-effort fix of truncated JSON: close an unterminated string
    (keeping the partial value), else drop the trailing partial element
    after the last comma OUTSIDE strings, then close unbalanced brackets.

    Both scans are string-aware: a naive ``rfind(',')`` cut amputates at a
    comma INSIDE a truncated string value ('\"Paris, France and the ' ->
    '\"Paris\"'), fabricating a confident shorter value with no truncation
    signal — valid but WRONG beats broken only when it is also honest."""
    try:
        json.loads(text)
        return text
    except json.JSONDecodeError:
        pass

    stack, in_string, last_comma = _scan_state(text)
    if in_string:
        # truncation mid-string: keep the partial value
        candidate = _close(text, stack, True)
        try:
            json.loads(candidate)
            return candidate
        except json.JSONDecodeError:
            # e.g. a dangling KEY ('{"answ') — closing it isn't valid
            # JSON; fall through to the element drop
            pass
    if last_comma != -1:
        cut = text[:last_comma]
        stack, in_string, _ = _scan_state(cut)
        return _close(cut, stack, in_string)
    return _close(text, stack, in_string)


def _scan_balanced(text: str, start: int) -> Optional[str]:
    """Return the balanced JSON substring starting at ``start`` or None."""
    opener = text[start]
    closer = {"{": "}", "[": "]"}[opener]
    depth = 0
    in_string = False
    escaped = False
    for i in range(start, len(text)):
        ch = text[i]
        if in_string:
            if escaped:
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == '"':
                in_string = False
            continue
        if ch == '"':
            in_string = True
        elif ch == opener:
            depth += 1
        elif ch == closer:
            depth -= 1
            if depth == 0:
                return text[start : i + 1]
    return None


def _extract_first(text: str, opener: str) -> Optional[Any]:
    idx = 0
    first_unbalanced = None
    while True:
        idx = text.find(opener, idx)
        if idx == -1:
            break
        candidate = _scan_balanced(text, idx)
        if candidate is not None:
            for attempt in (candidate, repair_json(candidate)):
                try:
                    return json.loads(attempt)
                except json.JSONDecodeError:
                    continue
        elif first_unbalanced is None:
            first_unbalanced = idx
        idx += 1
    if first_unbalanced is not None:
        # TRUNCATED payload (token cap mid-object): no balanced candidate
        # exists, which is exactly the case repair_json is for — without
        # this arm the docstring's "repairing if needed" never ran on
        # truncation and a capped probe/extraction response parsed to None
        try:
            return json.loads(repair_json(text[first_unbalanced:]))
        except json.JSONDecodeError:
            return None
    return None


def extract_json_object(text: str) -> Optional[dict]:
    """First parseable JSON object embedded in ``text`` (repairing if needed)."""
    obj = _extract_first(text, "{")
    return obj if isinstance(obj, dict) else None


def extract_json_array(text: str) -> Optional[list]:
    """First parseable JSON array embedded in ``text`` (repairing if needed)."""
    arr = _extract_first(text, "[")
    return arr if isinstance(arr, list) else None


def filter_valid_triples(triples: List[List[Any]]) -> List[List[str]]:
    """Keep unique triples with exactly three elements, order-preserving."""
    seen = set()
    out: List[List[str]] = []
    for t in triples:
        if not isinstance(t, (list, tuple)) or len(t) != 3:
            continue
        st = [str(x) for x in t]
        key = tuple(st)
        if key not in seen:
            seen.add(key)
            out.append(st)
    return out
