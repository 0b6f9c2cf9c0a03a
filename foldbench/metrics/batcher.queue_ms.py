"""batcher.queue_ms: the mean over the window's documents of dispatch
minus scheduled arrival; dispatch is the verdict's time less the
micro-batch's `wall_s` (submit to materialize)."""


def read(rec):
    q = [x for m in rec.get("micro", []) for x in m["queue_s"]]
    return sum(q) / len(q) * 1e3 if q else None
