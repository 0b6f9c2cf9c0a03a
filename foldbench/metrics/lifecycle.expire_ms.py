"""lifecycle.expire_ms: the retention window's expiry after each batch,
`LifecycleManager.after_batch`'s span `lifecycle.expire` (the slot log
drained, the ledger's expired batch taken, the backend's `delete` of its
slots), mean over the window's batches. None where the program records no
such span."""

from foldbench.metrics import _spans


def read(rec):
    spans = _spans._records(rec)
    if spans is None or not any("lifecycle.expire" in s for s in spans):
        return None
    return _spans.span_ms(rec, "lifecycle.expire")
