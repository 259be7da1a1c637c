"""Content-addressed identifiers.

Same scheme as the reference (misc_utils.py:152-163): MD5 hex digest of the
text, namespaced by a prefix, so indexes are resumable and dedup-on-insert is
a set lookup.

Copy of ``comorag_tpu/utils/hashing.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import functools
import hashlib


@functools.lru_cache(maxsize=1 << 20)
def _cached_hash(content: str, prefix: str) -> str:
    return prefix + hashlib.md5(content.encode()).hexdigest()


def content_hash(content: str, prefix: str = "") -> str:
    """Return ``prefix + md5(content)`` for content-addressed storage.

    Short strings (entity names — hashed millions of times during graph
    construction) are memoized; long chunk texts are hashed directly so
    the cache never pins whole corpora in RAM."""
    if len(content) <= 256:
        return _cached_hash(content, prefix)
    return prefix + hashlib.md5(content.encode()).hexdigest()
