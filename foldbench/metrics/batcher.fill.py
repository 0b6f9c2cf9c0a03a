"""batcher.fill: valid rows over bucket rows, over the window's
micro-batches."""


def read(rec):
    micro = rec.get("micro")
    if not micro:
        return None
    return sum(m["n_valid"] for m in micro) / sum(m["rows"] for m in micro)
