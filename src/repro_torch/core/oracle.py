"""Brute-force ground truth for dedup (port of `repro/core/oracle.py`, the
paper's 5-day reference, Table 1).

Given MinHash signatures, computes all-pairs MinHash-Jaccard and applies the
online admission rule sequentially: a document is a duplicate iff some
*earlier admitted* document has J >= tau. An offline host labeler by
design, so it stays numpy, as in the reference: signatures held as int32
bits compare equal exactly when their uint32 values do.
"""
# foldlint: module-sync-ok(offline oracle: the exact reference labeler is host-bound by definition)
from __future__ import annotations

import numpy as np

__all__ = ["exact_jaccard_matrix", "true_set_jaccard", "online_admission"]


def exact_jaccard_matrix(sigs: np.ndarray) -> np.ndarray:
    """(N, H) uint32 -> (N, N) float32 MinHash-Jaccard estimates."""
    sigs = np.asarray(sigs)
    eq = sigs[:, None, :] == sigs[None, :, :]
    return eq.mean(axis=-1, dtype=np.float32)


def true_set_jaccard(a: set, b: set) -> float:
    """Exact Jaccard between shingle sets (used in unit tests)."""
    if not a and not b:
        return 1.0
    return len(a & b) / len(a | b)


def online_admission(sim: np.ndarray, tau: float, seed_admitted: int = 0):
    """Sequential online dedup over a similarity matrix.

    sim: (N, N) pairwise similarity (symmetric); docs processed in order.
    Returns (admitted_mask, duplicate_of) where duplicate_of[i] is the index
    of the admitted near-duplicate that evicted i (or -1 if admitted).
    """
    n = sim.shape[0]
    admitted: list[int] = []
    mask = np.zeros(n, dtype=bool)
    dup_of = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        hit = -1
        for j in admitted:
            if sim[i, j] >= tau:
                hit = j
                break
        if hit < 0:
            admitted.append(i)
            mask[i] = True
        else:
            dup_of[i] = hit
    return mask, dup_of
