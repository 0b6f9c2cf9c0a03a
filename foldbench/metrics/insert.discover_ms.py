"""insert.discover_ms: the insert's phase A, candidate discovery against
the pre-batch graph (`hnsw_insert_batch`'s span `insert.discover`), mean
over the window's batches."""

from foldbench.metrics import _spans


def read(rec):
    return _spans.span_ms(rec, "insert.discover")
