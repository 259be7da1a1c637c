"""Corpus chunking CLI.

Capability parity with the reference's script/chunk_doc_corpus.py (chonkie
token/word/sentence chunkers over corpus.jsonl). Chunkers here are
first-party: token chunking uses a HF tokenizer when given, word/sentence
chunking is regex-based; overlap is supported.

Copy of ``comorag_tpu/cli/chunk.py`` for the port, which imports nothing of the JAX package.
Run it as ``python -m comorag_torch.cli.chunk``.
"""

from __future__ import annotations

import argparse
import re
from typing import Callable, List, Optional

from comorag_torch.utils.jsonio import load_jsonl, save_jsonl


def chunk_by_words(text: str, chunk_size: int, overlap: int = 0) -> List[str]:
    words = text.split()
    step = max(1, chunk_size - overlap)
    out = []
    for i in range(0, len(words), step):
        piece = words[i : i + chunk_size]
        if piece:
            out.append(" ".join(piece))
        if i + chunk_size >= len(words):
            break  # a further window would be a strict subset of this one
    return out


def chunk_by_sentences(text: str, chunk_size: int) -> List[str]:
    """Greedy sentence packing up to ~chunk_size words per chunk."""
    sentences = [s.strip() for s in re.split(r"(?<=[.!?])\s+", text) if s.strip()]
    chunks, current, count = [], [], 0
    for s in sentences:
        n = len(s.split())
        if current and count + n > chunk_size:
            chunks.append(" ".join(current))
            current, count = [], 0
        current.append(s)
        count += n
    if current:
        chunks.append(" ".join(current))
    return chunks


def chunk_by_tokens(text: str, chunk_size: int, tokenizer, overlap: int = 0) -> List[str]:
    ids = tokenizer.encode(text, add_special_tokens=False)
    step = max(1, chunk_size - overlap)
    out = []
    for i in range(0, len(ids), step):
        piece = ids[i : i + chunk_size]
        if piece:
            out.append(tokenizer.decode(piece))
        if i + chunk_size >= len(ids):
            break  # a further window would be a strict subset of this one
    return out


def chunk_recursive(text: str, chunk_size: int) -> List[str]:
    """Hierarchical splitting (reference's chonkie RecursiveChunker
    semantics): paragraphs -> sentences -> words, splitting a level only
    when a piece exceeds ~chunk_size words, then greedily re-packing."""

    def split_level(piece: str, level: int) -> List[str]:
        if len(piece.split()) <= chunk_size:
            return [piece]
        if level == 0:
            parts = [p.strip() for p in re.split(r"\n\s*\n", piece) if p.strip()]
        elif level == 1:
            parts = [s.strip() for s in re.split(r"(?<=[.!?])\s+", piece) if s.strip()]
        else:
            return chunk_by_words(piece, chunk_size)
        if len(parts) <= 1:
            return split_level(piece, level + 1)
        out: List[str] = []
        for p in parts:
            out.extend(split_level(p, level + 1))
        return out

    pieces = split_level(text, 0)
    # greedy re-pack to ~chunk_size words
    chunks, current, count = [], [], 0
    for p in pieces:
        n = len(p.split())
        if current and count + n > chunk_size:
            chunks.append(" ".join(current))
            current, count = [], 0
        current.append(p)
        count += n
    if current:
        chunks.append(" ".join(current))
    return chunks


def make_chunker(method: str, chunk_size: int, tokenizer_path: Optional[str], overlap: int) -> Callable[[str], List[str]]:
    if method == "token" and tokenizer_path:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(tokenizer_path)
        return lambda text: chunk_by_tokens(text, chunk_size, tok, overlap)
    if method == "sentence":
        return lambda text: chunk_by_sentences(text, chunk_size)
    if method == "recursive":
        return lambda text: chunk_recursive(text, chunk_size)
    if method == "token":
        # loud, not silent: 512 WORDS is ~30-40% more tokens per chunk
        # than the reference's 512-token chunks — boundaries, index size,
        # and retrieval results all differ from the protocol
        print(
            "WARNING: --chunk_by token without --tokenizer_name_or_path "
            "falls back to WORD chunking; pass a tokenizer to reproduce "
            "the reference's token-boundary chunks."
        )
    return lambda text: chunk_by_words(text, chunk_size, overlap)


def main() -> None:
    parser = argparse.ArgumentParser(description="Chunk documents from a corpus JSONL file")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--chunk_by", default="token", choices=["token", "word", "sentence", "recursive"])
    parser.add_argument("--chunk_size", default=512, type=int)
    parser.add_argument("--overlap", default=0, type=int)
    parser.add_argument("--tokenizer_name_or_path", default=None)
    args = parser.parse_args()

    documents = load_jsonl(args.input_path)
    chunker = make_chunker(args.chunk_by, args.chunk_size, args.tokenizer_name_or_path, args.overlap)

    chunked = []
    chunk_id = 0
    for doc in documents:
        contents = doc["contents"]
        # the reference strips the 'Title,' prefix before chunking
        # (chunk_doc_corpus.py:62 `title, text = contents.split(',', 1)`)
        # — chunking it in would shift every boundary by the title length
        # and embed the title into the first chunk. Unlike the reference
        # (which crashes), comma-less contents chunk whole.
        _, _, body = contents.partition(",")
        if not body:
            body = contents
        for piece in chunker(body):
            chunked.append(
                {"id": chunk_id, "doc_id": doc.get("id"), "title": piece[:30], "contents": piece}
            )
            chunk_id += 1
    save_jsonl(chunked, args.output_path)
    print(f"Processed {len(documents)} documents into {len(chunked)} chunks.")


if __name__ == "__main__":
    main()
