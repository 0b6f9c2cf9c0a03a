"""lifecycle.syncs: the card syncs a batch's expiry makes (the span
`lifecycle.expire`: the slots' upload, the delete's reads of its mask and
count), mean over the window's first batches (`_spans.py`). None where the
program records no such span."""

from foldbench.metrics import _spans


def read(rec):
    spans = _spans._records(rec)
    if spans is None or not any("lifecycle.expire" in s
                                for s in spans[:_spans.SYNC_BATCHES]):
        return None
    return _spans.syncs(rec, lambda name: name == "lifecycle.expire")
