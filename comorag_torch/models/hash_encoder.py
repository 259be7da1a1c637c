"""Hermetic deterministic encoder for tests and offline development.

Maps text -> unit vector via a seeded hash, with a *soft bag-of-words* mixing
so that lexically similar texts have higher cosine similarity than unrelated
ones — enough structure for retrieval ranking tests without any model
weights. This is the framework's answer to the reference having no test
story at all (SURVEY.md §4): every pipeline stage can run hermetically.

v3 rebuilt the implementation fully vectorized: word vectors are dense
Rademacher (+-1) rows expanded from splitmix64 bit streams (same zero-mean
iid geometry as the old per-word gaussian draws, 1/sqrt(dim) cross-word
noise) and a batch encodes as ONE sparse count-matrix x word-matrix
product. The old path paid sha256 + a fresh numpy Generator +
standard_normal(dim) per word occurrence — measured 99 s for 150k short
texts, which made the hermetic encoder the single largest untracked cost
of a 200k-corpus index build. v3: ~5 s for the same batch.

Copy of ``comorag_tpu/models/hash_encoder.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
from typing import List, Union

import numpy as np

from comorag_torch.models.base import BaseEncoder

# Downweighted function words: a linear bag-of-words lets "the"-counts
# dominate cosine similarity on long chunks (15 x "the" vs 1 x the
# discriminative token), which no trained encoder does. Sublinear counts
# + a stopword damp keep the hermetic instrument's rankings
# content-driven, like the real encoders it stands in for.
_STOPWORDS = frozenset(
    "the a an and or but of in on at to was were is are be been by with for as "
    "while after before that this it its from into over under not no so than "
    "then there here when where who whom which what".split()
)

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 in/out, wraps mod 2^64)."""
    z = x + _GOLDEN
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _rademacher_rows(keys: np.ndarray, dim: int) -> np.ndarray:
    """[n, dim] float32 of +-1, deterministic per (key, dim): each row's
    bits come from splitmix64(key + j) counters, unpacked to sign bits."""
    n_u64 = (dim + 63) // 64
    ctr = np.arange(1, n_u64 + 1, dtype=np.uint64)[None, :] * _GOLDEN
    h = _splitmix64(keys[:, None] + ctr)  # [n, n_u64]
    bits = np.unpackbits(h.view(np.uint8), axis=1)[:, :dim]
    return (bits.astype(np.float32) * 2.0 - 1.0)


class HashEncoder(BaseEncoder):
    # v2: sublinear counts + stopword damping changed every vector
    # v3: vectorized Rademacher word vectors (splitmix64 bit expansion)
    encoder_version = 3

    def __init__(self, dim: int = 512, seed: int = 0):
        self.dim = dim
        self.seed = seed
        # a different seed is a different projection space — store
        # validation must not accept cross-seed vectors
        self.fingerprint_extra = f"s{seed}"

    def _word_key(self, word: str) -> int:
        digest = hashlib.sha256(f"{self.seed}:{word}".encode()).digest()
        return int.from_bytes(digest[:8], "little")

    def _word_vec(self, word: str) -> np.ndarray:
        """Single word vector (kept for tests/debugging; encode() uses the
        batched path below)."""
        keys = np.asarray([self._word_key(word)], dtype=np.uint64)
        return _rademacher_rows(keys, self.dim)[0]

    def encode(
        self,
        texts: Union[str, List[str]],
        instruction: str = "",
        norm=None,
    ) -> np.ndarray:
        norm = self.resolve_norm(norm)
        texts = self._as_list(texts)

        # batch vocabulary + per-(text, word) weights
        vocab: dict = {}
        rows: List[int] = []
        cols: List[int] = []
        vals: List[float] = []
        for i, text in enumerate(texts):
            words = text.lower().split() or ["<empty>"]
            counts: dict = {}
            for w in words:
                counts[w] = counts.get(w, 0) + 1
            for w, c in counts.items():
                j = vocab.setdefault(w, len(vocab))
                rows.append(i)
                cols.append(j)
                vals.append((0.1 if w in _STOPWORDS else 1.0) * float(np.sqrt(c)))
        if instruction:
            # tiny instruction-dependent rotation so query/passage differ
            j = vocab.setdefault(f"<instr>{instruction}", len(vocab))
            for i in range(len(texts)):
                rows.append(i)
                cols.append(j)
                vals.append(0.01)

        keys = np.fromiter(
            (self._word_key(w) for w in vocab), dtype=np.uint64, count=len(vocab)
        )
        word_mat = _rademacher_rows(keys, self.dim)  # [V, dim]

        try:
            from scipy.sparse import csr_matrix

            sp = csr_matrix(
                (np.asarray(vals, np.float32), (rows, cols)),
                shape=(len(texts), len(vocab)),
            )
            out = np.asarray(sp @ word_mat, dtype=np.float32)
        except ImportError:  # scipy-less fallback, same result
            out = np.zeros((len(texts), self.dim), dtype=np.float32)
            if rows:  # empty int lists asarray to float64 and break indexing
                np.add.at(
                    out,
                    np.asarray(rows, np.intp),
                    np.asarray(vals, np.float32)[:, None] * word_mat[np.asarray(cols, np.intp)],
                )
        if norm:
            out = self._l2_normalize(out)
        return out
