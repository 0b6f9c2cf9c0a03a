"""Shared by the readers of the program's spans and sync counts
(`repro_torch.spans`).

The closed-loop cells read each batch's record, `process_batch`'s
stats["spans"]: {span name: {"s": seconds, "syncs": card syncs counted
while it was the innermost open span}}. The open-loop cell reads the
program's ring of recent micro-batches (`repro_torch.spans.recent()`),
matched to the window's micro-batches by their first document id. Each
returns None where the program keeps no such record."""
import sys

# the syncs a batch makes depend on its documents and the index it meets,
# so a count is fixed by the seed only over the same batches: the window's
# first ones, which every run of a seed sends
SYNC_BATCHES = 16


def _records(rec):
    stages = rec.get("stages")
    if not stages or any("spans" not in s for s in stages):
        return None
    return [s["spans"] for s in stages]


def span_ms(rec, name):
    """The mean seconds of span `name` over the window's batches, in ms."""
    spans = _records(rec)
    if spans is None:
        return None
    return sum(s.get(name, {}).get("s", 0.0) for s in spans) / len(spans) * 1e3


def syncs(rec, under):
    """The mean card syncs a batch makes under the spans `under(name)`
    picks, over the window's first SYNC_BATCHES batches."""
    spans = _records(rec)
    if spans is None:
        return None
    spans = spans[:SYNC_BATCHES]
    return sum(e["syncs"] for s in spans for name, e in s.items()
               if under(name)) / len(spans)


def micro(rec):
    """The program's record of each of the window's micro-batches, or None
    where any of them has none."""
    window = rec.get("micro")
    prog = sys.modules.get("repro_torch.spans")
    if not window or prog is None or not hasattr(prog, "recent"):
        return None
    by_first = {r["first_id"]: r for r in prog.recent() if "first_id" in r}
    out = [by_first.get(int(m["ids"][0])) for m in window]
    return None if any(r is None for r in out) else out


def micro_mean_ms(rec, key):
    """The mean of `key` (seconds) over the window's micro-batches, in ms."""
    recs = micro(rec)
    if recs is None or any(key not in r for r in recs):
        return None
    return sum(r[key] for r in recs) / len(recs) * 1e3
