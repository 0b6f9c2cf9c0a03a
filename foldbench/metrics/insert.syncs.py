"""insert.syncs: the card syncs a batch makes in the insert (the span
`insert` and its three phases), mean over the window's first batches
(`_spans.py`)."""

from foldbench.metrics import _spans


def read(rec):
    return _spans.syncs(rec, lambda name: name == "insert"
                        or name.startswith("insert."))
