"""lifecycle.compact_rows: the adjacency rows a compaction rebuilt (the
rows that referenced a tombstone, summed over the levels: the span
`lifecycle.compact`'s count `rows`), mean over the compactions that ran in
the window. None where none ran."""

from foldbench.metrics import _spans


def read(rec):
    spans = _spans._records(rec)
    if spans is None:
        return None
    rows = [s["lifecycle.compact"]["rows"] for s in spans
            if "rows" in s.get("lifecycle.compact", {})]
    return sum(rows) / len(rows) if rows else None
