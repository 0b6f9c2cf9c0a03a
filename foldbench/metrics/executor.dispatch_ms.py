"""executor.dispatch_ms: `submit`'s own time, from its entry until
`dedup_step` returns, mean over the window's micro-batches."""

from foldbench.metrics import _spans


def read(rec):
    return _spans.micro_mean_ms(rec, "dispatch_s")
