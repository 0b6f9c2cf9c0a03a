"""Exact-duplicate short-circuit front end (port of `repro/index/exact.py`;
LSHBloom-style, arXiv 2411.04257).

A compact content-hash set consulted *before* signature generation: the
common case at crawl scale is the verbatim re-fetch, and it should never
pay shingling, MinHash or an HNSW search. Identical token streams produce
identical signatures, so the fuzzy pipeline reaches the same verdict
without it; losing filter state is therefore SAFE, and the snapshot
sidecar is written independently of the backend's array checkpoint.
Callers that evict docs drop the matching entries via `discard_refs`.

Hashes are 64-bit blake2b digests of the raw uint32 token bytes (truncated
to the declared length), equal to the reference's, so one sidecar
(`exact_%08d.npz`) serves both packages. Host-side (numpy + hashlib) by
design.
"""
from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np

__all__ = ["doc_hash", "batch_hashes", "ExactDupFilter"]

_SIDECAR_FMT = "exact_%08d.npz"


def _host_u32(tokens) -> np.ndarray:
    """Tokens as a host uint32 array (a torch tensor of int32 bits or any
    array-like of uint32 ids)."""
    if hasattr(tokens, "detach"):
        tokens = tokens.detach().cpu().numpy()
    a = np.asarray(tokens)
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return a.astype(np.uint32, copy=False)


def doc_hash(tokens, length: int | None = None) -> int:
    """64-bit content hash of one token sequence (uint32 little-endian)."""
    t = np.ascontiguousarray(_host_u32(tokens).ravel())
    if length is not None:
        t = t[: int(length)]
    d = hashlib.blake2b(t.astype("<u4", copy=False).tobytes(),
                        digest_size=8).digest()
    return int.from_bytes(d, "little")


def batch_hashes(tokens, lengths=None) -> list[int]:
    """Per-row content hashes for a (B, L) token batch."""
    toks = _host_u32(tokens)
    if lengths is None:
        return [doc_hash(row) for row in toks]
    if hasattr(lengths, "detach"):
        lengths = lengths.detach().cpu().numpy()
    lens = np.asarray(lengths, np.int64).ravel()
    return [doc_hash(row, int(n)) for row, n in zip(toks, lens)]


class ExactDupFilter:
    """Content-hash set with first-wins reference ids and a snapshot sidecar.

    hash -> ref maps a content hash to the doc id that first admitted it
    (ref = -1 when the admitter's id is unknown, as on the pipeline path).
    The reverse map makes `discard_refs` O(evicted)."""

    def __init__(self):
        self._by_hash: dict[int, int] = {}
        self._refs: dict[int, int] = {}   # ref doc id -> hash (refs >= 0)
        self.hits = 0                     # counted by callers via record_hit

    def __len__(self) -> int:
        return len(self._by_hash)

    def __contains__(self, h: int) -> bool:
        return h in self._by_hash

    def lookup(self, h: int) -> int | None:
        """ref doc id for a known hash (may be -1), None if unknown."""
        return self._by_hash.get(h)

    def record_hit(self, n: int = 1) -> None:
        self.hits += n

    def add(self, h: int, ref: int = -1) -> bool:
        """Register a hash (first admitter wins). Returns True if new."""
        if h in self._by_hash:
            return False
        self._by_hash[h] = ref
        if ref >= 0:
            self._refs[ref] = h
        return True

    def discard_refs(self, doc_ids) -> int:
        """Drop entries whose admitting doc was evicted/deleted, so a
        resubmitted copy is re-admitted instead of vetoed by a ghost."""
        n = 0
        for ref in np.asarray(doc_ids, np.int64).ravel():
            h = self._refs.pop(int(ref), None)
            if h is not None and self._by_hash.get(h) == int(ref):
                del self._by_hash[h]
                n += 1
        return n

    # -- snapshot sidecar ---------------------------------------------------
    def save(self, ckpt_dir: str, step: int) -> None:
        """Write the sidecar atomically next to the backend's step dirs."""
        os.makedirs(ckpt_dir, exist_ok=True)
        hashes = np.fromiter(self._by_hash.keys(), np.uint64,
                             len(self._by_hash))
        refs = np.fromiter(self._by_hash.values(), np.int64,
                           len(self._by_hash))
        fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, hashes=hashes, refs=refs)
            os.replace(tmp, os.path.join(ckpt_dir, _SIDECAR_FMT % step))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def load(self, ckpt_dir: str, step: int) -> bool:
        """Restore from the step's sidecar; a missing sidecar leaves the
        filter EMPTY (safe) and returns False."""
        path = os.path.join(ckpt_dir, _SIDECAR_FMT % step)
        self._by_hash = {}
        self._refs = {}
        if not os.path.exists(path):
            return False
        with np.load(path) as z:
            hashes, refs = z["hashes"], z["refs"]
        self._by_hash = {int(h): int(r) for h, r in zip(hashes, refs)}
        self._refs = {r: h for h, r in self._by_hash.items() if r >= 0}
        return True

    def prune_sidecars(self, ckpt_dir: str, keep_steps) -> None:
        """Drop sidecars for rotated-away snapshot steps."""
        keep = {_SIDECAR_FMT % s for s in keep_steps}
        try:
            names = os.listdir(ckpt_dir)
        except FileNotFoundError:
            return
        for name in names:
            if (name.startswith("exact_") and name.endswith(".npz")
                    and name not in keep):
                try:
                    os.unlink(os.path.join(ckpt_dir, name))
                except FileNotFoundError:
                    pass
