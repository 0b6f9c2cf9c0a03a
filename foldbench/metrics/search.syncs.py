"""search.syncs: the card syncs a batch makes in the index search (the
span `search`), mean over the window's first batches (`_spans.py`)."""

from foldbench.metrics import _spans


def read(rec):
    return _spans.syncs(rec, lambda name: name == "search")
