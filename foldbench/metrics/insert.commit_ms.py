"""insert.commit_ms: the insert's sequential commit, the forward rows and
one back-link per admitted row and level (`hnsw_insert_batch`'s span
`insert.commit`), mean over the window's batches."""

from foldbench.metrics import _spans


def read(rec):
    return _spans.span_ms(rec, "insert.commit")
