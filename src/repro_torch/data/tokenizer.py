"""Minimal tokenizer built in-repo, no external vocab files (port of
`repro/data/tokenizer.py`; numpy only).

HashWordTokenizer: whitespace-split words hashed into a fixed vocab — the
standard trick for dedup pipelines, where token *identity* matters but
embeddings don't. Word hashes come from Python's `hash`, as in the
reference, so the two packages agree within one process.
"""
from __future__ import annotations

import numpy as np

__all__ = ["HashWordTokenizer"]


class HashWordTokenizer:
    def __init__(self, vocab_size: int = 50_000, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.lowercase = lowercase

    def encode(self, text: str) -> np.ndarray:
        if self.lowercase:
            text = text.lower()
        words = text.split()
        if not words:
            return np.zeros(0, np.uint32)
        h = np.frombuffer(
            b"".join(int.to_bytes(abs(hash(w)) & 0xFFFFFFFF, 4, "little")
                     for w in words), dtype=np.uint32).copy()
        return (h % np.uint32(self.vocab_size)).astype(np.uint32)

    def encode_batch(self, texts: list[str]):
        docs = [self.encode(t) for t in texts]
        max_len = max((len(d) for d in docs), default=1) or 1
        tokens = np.zeros((len(docs), max_len), np.uint32)
        lengths = np.zeros(len(docs), np.int32)
        for i, d in enumerate(docs):
            tokens[i, :len(d)] = d
            lengths[i] = len(d)
        return tokens, lengths
