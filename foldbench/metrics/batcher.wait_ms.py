"""batcher.wait_ms: each document's wait in the batcher, from its `add` to
its micro-batch's emit, as the batcher measures it, mean over the
window's documents."""

from foldbench.metrics import _spans


def read(rec):
    recs = _spans.micro(rec)
    if recs is None or any("wait_s" not in r for r in recs):
        return None
    docs = sum(r["docs"] for r in recs)
    return sum(r["wait_s"] * r["docs"] for r in recs) / docs * 1e3
