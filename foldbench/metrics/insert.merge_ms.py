"""insert.merge_ms: the insert's slot writes and batched merge of the
candidates (`hnsw_insert_batch`'s span `insert.merge`), mean over the
window's batches."""

from foldbench.metrics import _spans


def read(rec):
    return _spans.span_ms(rec, "insert.merge")
