"""insert.commit_ms: the insert's commit, `_commit_batch` (the plan made on
the host from one copy of the batch's arrays, the forward rows, and every
back-link in one launch of the `link_back` kernel), `hnsw_insert_batch`'s
span `insert.commit`, mean over the window's batches."""

from foldbench.metrics import _spans


def read(rec):
    return _spans.span_ms(rec, "insert.commit")
