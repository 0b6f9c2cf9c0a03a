"""insert.reused: the admitted rows a batch's insert placed in slots that
a compaction reclaimed (the span `insert`'s count `reused`), mean over the
window's batches. None where the program counts none."""

from foldbench.metrics import _spans


def read(rec):
    spans = _spans._records(rec)
    if spans is None:
        return None
    got = [s.get("insert", {}).get("reused") for s in spans]
    if all(n is None for n in got):
        return None
    return sum(n or 0 for n in got) / len(got)
