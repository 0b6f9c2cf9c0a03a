"""The `pipeline` driver: `FoldPipeline(FoldConfig(**fold))` through
`DedupPipeline.process_batch`, closed loop: one caller, the next batch
sent when the last completes (`drive.closed_loop`)."""
from __future__ import annotations

from foldbench.drive import closed_loop


def drive(ctx: dict) -> dict:
    return closed_loop(ctx)
