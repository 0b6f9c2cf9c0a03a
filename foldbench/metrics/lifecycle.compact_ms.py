"""lifecycle.compact_ms: a compaction's pause, the span `lifecycle.compact`
(`compact()` whole: the adjacency repair around the tombstones, their
unlinking and the free list's re-derivation), mean over the compactions
that ran in the window. None where none ran."""

from foldbench.metrics import _spans


def read(rec):
    spans = _spans._records(rec)
    if spans is None:
        return None
    runs = [s["lifecycle.compact"]["s"] for s in spans
            if "lifecycle.compact" in s]
    return sum(runs) / len(runs) * 1e3 if runs else None
