"""executor.held_ms: from the return of a micro-batch's `dedup_step` until
its verdicts have left the device in the executor's collect, mean over
the window's micro-batches (with `executor.dispatch_ms`, its `wall_s`)."""

from foldbench.metrics import _spans


def read(rec):
    return _spans.micro_mean_ms(rec, "held_s")
