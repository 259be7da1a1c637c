"""Content-addressed vector store.

Capability parity with the reference's ``EmbeddingStore``
(embedding_store.py:13-167): dedup-on-insert keyed by MD5 content hash,
parquet persistence, insertion-order preserved. The TPU-first difference:
embeddings live in ONE contiguous ``np.ndarray [N, dim]`` (not a Python list
of row arrays), so the retrieval engine can ship the whole matrix to device
memory / shard it over the mesh with zero repacking.

On-disk layout (both parquet): ``vdb_{ns}.parquet`` holds hash_id+content;
``vdb_{ns}_vec.parquet`` holds the matrix as ONE flat float32 column with
``dim`` in the schema metadata. The reference embeds list<float> rows in
the row table (embedding_store.py:60-66) — measured here, that layout's
per-row Python materialization plus parquet list-level decode cost ~800 s
of a 200k-corpus index wall (539k facts x 1024 dims); the flat column
round-trips the same data in seconds. Legacy single-file stores (an
``embedding`` list column) still load.

Copy of ``comorag_tpu/store/embedding_store.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from comorag_torch.utils.hashing import content_hash
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _column_to_matrix(col) -> np.ndarray:
    """An arrow column of ``fixed_size_list<float>`` (what `_save` writes)
    or legacy ``list<float>`` rows -> contiguous [N, dim] float32, without
    materializing N*dim Python objects (`to_pylist` measured minutes at
    539k x 1024). Ragged legacy layouts fall back to the slow path."""
    import pyarrow as pa

    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    n = len(arr)
    if pa.types.is_fixed_size_list(arr.type):
        dim = arr.type.list_size
        values = arr.flatten().to_numpy(zero_copy_only=False)
        return np.ascontiguousarray(values, np.float32).reshape(n, dim)
    if pa.types.is_list(arr.type):
        offsets = np.diff(arr.offsets.to_numpy(zero_copy_only=False))
        if offsets.size and (offsets == offsets[0]).all() and offsets[0] > 0:
            values = arr.flatten().to_numpy(zero_copy_only=False)
            return np.ascontiguousarray(values, np.float32).reshape(n, int(offsets[0]))
    return np.asarray(arr.to_pylist(), dtype=np.float32)


class EmbeddingStore:
    def __init__(self, encoder, directory: str, batch_size: int, namespace: str):
        self.encoder = encoder
        self.batch_size = batch_size
        self.namespace = namespace
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"vdb_{namespace}.parquet")
        self.vec_path = os.path.join(directory, f"vdb_{namespace}_vec.parquet")

        self.hash_ids: List[str] = []
        self.texts: List[str] = []
        self._matrix: Optional[np.ndarray] = None  # [N, dim] float32
        self._index: Dict[str, int] = {}
        self._load()

    # ------------------------------------------------------------ persistence
    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        import pyarrow.parquet as pq

        table = pq.read_table(self.path)
        self.hash_ids = table.column("hash_id").to_pylist()
        self.texts = table.column("content").to_pylist()
        stored_fp = (table.schema.metadata or {}).get(b"encoder_fingerprint", b"").decode()
        want_fp = getattr(self.encoder, "fingerprint", "")
        # fingerprint first: on a mismatch the vectors are discarded anyway,
        # so don't pay the sidecar read (~GBs at fact-store scale)
        fp_ok = not (want_fp and stored_fp != want_fp)
        vectors = self._load_vectors(table) if fp_ok else None
        if self.texts and (not fp_ok or vectors is None):
            # vectors were produced by a different (or older) embedding
            # function — or the vector artifact is missing entirely;
            # scoring new queries against them silently degrades every
            # ranking. The TEXTS may be expensive LLM artifacts
            # (summaries, timeline windows) — keep them, re-encode only.
            logger.warning(
                "%s: stored vectors have encoder fingerprint %r but the "
                "active encoder is %r — re-encoding %d texts",
                self.path, stored_fp or "<none>", want_fp, len(self.texts),
            )
            embs = []
            for i in range(0, len(self.texts), self.batch_size):
                embs.append(self.encoder.encode(self.texts[i : i + self.batch_size]))
            self._matrix = np.concatenate(embs, axis=0).astype(np.float32)
            self._index = {h: i for i, h in enumerate(self.hash_ids)}
            self._save()
            return
        self._matrix = vectors
        self._index = {h: i for i, h in enumerate(self.hash_ids)}
        logger.info("Loaded %d records from %s", len(self.hash_ids), self.path)

    def _load_vectors(self, table) -> Optional[np.ndarray]:
        """[N, dim] from the flat sidecar (fast path) or a legacy embedded
        ``embedding`` column; None when texts exist but vectors don't."""
        import pyarrow.parquet as pq

        if os.path.exists(self.vec_path):
            try:
                vt = pq.read_table(self.vec_path)
            except Exception as exc:  # torn/corrupt sidecar -> re-encode
                logger.warning("%s: unreadable vector sidecar (%s) — re-encoding",
                               self.vec_path, exc)
                return None
            meta = vt.schema.metadata or {}
            dim = int(meta.get(b"dim", b"0") or 0)
            # the sidecar carries its OWN fingerprint: the two files are
            # written sequentially, so a crash between them can leave a
            # same-shape sidecar of a previous encoder's vectors behind a
            # fresh main table — shape alone must not validate it
            side_fp = meta.get(b"encoder_fingerprint", b"").decode()
            want_fp = getattr(self.encoder, "fingerprint", "")
            if want_fp and side_fp and side_fp != want_fp:
                logger.warning(
                    "%s: sidecar fingerprint %r != active encoder %r — re-encoding",
                    self.vec_path, side_fp, want_fp,
                )
                return None
            # row-set binding (when present — legacy sidecars lack it):
            # same encoder + same row COUNT can still be a different row
            # SET when concurrent writers raced; texts would then score
            # against vectors of other texts.
            side_sig = meta.get(b"content_sig", b"").decode()
            if side_sig and side_sig != self._content_sig():
                logger.warning(
                    "%s: sidecar row-set signature does not match the main "
                    "table — re-encoding", self.vec_path,
                )
                return None
            vals = vt.column("values").combine_chunks().to_numpy(zero_copy_only=False)
            if dim and vals.size == len(self.texts) * dim:
                return np.ascontiguousarray(vals, np.float32).reshape(-1, dim)
            logger.warning(
                "%s: vector sidecar is inconsistent (dim=%d, %d values for "
                "%d rows) — re-encoding", self.vec_path, dim, vals.size, len(self.texts),
            )
            return None
        if "embedding" in table.column_names and len(self.texts):
            col = table.column("embedding")
            return _column_to_matrix(col)
        return None

    def _save(self) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        fp = getattr(self.encoder, "fingerprint", "")
        table = pa.table({"hash_id": self.hash_ids, "content": self.texts})
        if fp:
            table = table.replace_schema_metadata({b"encoder_fingerprint": fp.encode()})

        emb = self._matrix if self._matrix is not None else np.zeros((0, 0), np.float32)
        flat = np.ascontiguousarray(emb, np.float32).reshape(-1)
        vec_tab = pa.table({"values": pa.array(flat)}).replace_schema_metadata(
            {b"dim": str(emb.shape[1] if emb.size else 0).encode(),
             b"encoder_fingerprint": fp.encode(),
             # binds the sidecar to the EXACT row set of the main table:
             # the encoder fingerprint + row count alone can't distinguish
             # two same-size saves by concurrent writers with different
             # final rows (main_A + sidecar_B would otherwise pair).
             b"content_sig": self._content_sig().encode()}
        )
        # atomic writes (tmp + rename, pid-unique so concurrent writers
        # never publish each other's half-written tmp), sidecar FIRST: a
        # crash mid-save must never leave a fresh main table beside
        # stale/torn vectors. Dictionary encoding is useless on float
        # vectors and slows both directions; light zstd wins back the
        # wire/disk bytes.
        vtmp = f"{self.vec_path}.tmp.{os.getpid()}"
        mtmp = f"{self.path}.tmp.{os.getpid()}"
        pq.write_table(
            vec_tab, vtmp,
            use_dictionary=False, compression="zstd", compression_level=1,
        )
        os.replace(vtmp, self.vec_path)
        pq.write_table(table, mtmp)
        os.replace(mtmp, self.path)

    def _content_sig(self) -> str:
        """Digest of the ordered hash_id rows (cheap: ids are md5 hex)."""
        import hashlib

        h = hashlib.sha256()
        for hid in self.hash_ids:
            h.update(hid.encode())
            h.update(b"\x00")
        return h.hexdigest()

    def clear(self) -> None:
        """Drop all rows and the on-disk artifact (used when a derived
        layer — e.g. the timeline — is stale and must be rebuilt)."""
        self.hash_ids = []
        self.texts = []
        self._matrix = None
        self._index = {}
        for p in (self.path, self.vec_path):
            if os.path.exists(p):
                os.remove(p)

    # ------------------------------------------------------------ insertion
    def key_for(self, text: str) -> str:
        return content_hash(text, prefix=self.namespace + "-")

    def missing(self, texts: Sequence[str]) -> Dict[str, str]:
        """hash_id -> text for texts not yet stored (order-preserving,
        reference get_missing_string_hash_ids semantics)."""
        out: Dict[str, str] = {}
        for t in texts:
            h = self.key_for(t)
            if h not in self._index and h not in out:
                out[h] = t
        return out

    def insert_strings(self, texts: Sequence[str]) -> List[str]:
        """Encode + store any new texts; returns hash ids of ALL inputs."""
        missing = self.missing(texts)
        if missing:
            new_texts = list(missing.values())
            embs = []
            for i in range(0, len(new_texts), self.batch_size):
                embs.append(
                    np.asarray(
                        self.encoder.encode(new_texts[i : i + self.batch_size]),
                        dtype=np.float32,
                    )
                )
            new_matrix = np.concatenate(embs, axis=0)
            start = len(self.hash_ids)
            for j, (h, t) in enumerate(missing.items()):
                self._index[h] = start + j
                self.hash_ids.append(h)
                self.texts.append(t)
            if self._matrix is None:
                self._matrix = new_matrix
            else:
                self._matrix = np.concatenate([self._matrix, new_matrix], axis=0)
            self._save()
            logger.info(
                "Inserted %d new records into %s (%d total)",
                len(missing), self.namespace, len(self.hash_ids),
            )
        return [self.key_for(t) for t in texts]

    # ------------------------------------------------------------ accessors
    def __len__(self) -> int:
        return len(self.hash_ids)

    def __contains__(self, hash_id: str) -> bool:
        return hash_id in self._index

    def get_all_ids(self) -> List[str]:
        return list(self.hash_ids)

    def get_all_texts(self) -> List[str]:
        return list(self.texts)

    def get_text(self, hash_id: str) -> str:
        return self.texts[self._index[hash_id]]

    def get_texts(self, hash_ids: Sequence[str]) -> List[str]:
        return [self.get_text(h) for h in hash_ids]

    def hash_to_text(self) -> Dict[str, str]:
        return {h: self.texts[i] for h, i in self._index.items()}

    def text_to_hash(self) -> Dict[str, str]:
        return {self.texts[i]: h for h, i in self._index.items()}

    def order_of(self, hash_id: str) -> int:
        """Insertion-order index (reference get_hash_id_to_order semantics)."""
        return self._index[hash_id]

    @property
    def matrix(self) -> np.ndarray:
        """The full [N, dim] embedding matrix (contiguous, float32)."""
        if self._matrix is None:
            return np.zeros((0, getattr(self.encoder, "dim", 0)), dtype=np.float32)
        return self._matrix

    def get_embedding(self, hash_id: str) -> np.ndarray:
        return self.matrix[self._index[hash_id]]

    def get_embeddings(self, hash_ids: Sequence[str]) -> np.ndarray:
        if not hash_ids:
            return np.zeros((0, self.matrix.shape[1] if self.matrix.size else 0), np.float32)
        idx = np.asarray([self._index[h] for h in hash_ids], dtype=np.intp)
        return self.matrix[idx]
