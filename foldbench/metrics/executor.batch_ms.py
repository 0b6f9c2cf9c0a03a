"""executor.batch_ms: the mean `wall_s` (submit to materialize) of the
window's micro-batches."""


def read(rec):
    micro = rec.get("micro")
    if not micro:
        return None
    return sum(m["wall_s"] for m in micro) / len(micro) * 1e3
