"""Depth-bounded execution of dedup micro-batches (port of
`repro/service/executor.py`).

The executor dispatches each micro-batch's whole graph through the generic
`DedupPipeline` surface — `signatures(tokens, lengths) -> SigBatch` then
`dedup_step(sig, valid)` — and materializes results a fixed `depth`
batches behind the dispatch front, at ONE point (`_collect_one`), in
submission order. Every batch runs on the current CUDA stream: batch i+1's
search reads batch i's insert, so stream order is what keeps the index
consistent.

What overlaps in the port. The reference rests its overlap on JAX async
dispatch: `dedup_step` returns before the device has run it. The port's
`dedup_step` does not: the greedy in-batch sweep copies the (B, B)
threshold mask to the host, and the HNSW search and the insert's
discovery read a "still running" flag once per beam step. So `submit`
returns only after batch i's search and most of its insert have run on
the card; what is left in flight is the device tail after the insert's
last host read, and only that tail overlaps the next batch's host work
(padding, upload, shingle prep, the K1 launch). `depth=0` (each submit
materializes its own result) against `depth=2` is the measurement of that
overlap (`chip_smoke.py` phase 8); nothing more is claimed here.

Sequential-mode equivalence: the executor runs the exact same stage
functions against the same evolving index state in the same order, so its
keep-verdicts are bit-identical to a `process_batch` loop over the same
micro-batches (tests/test_torch_service.py).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import numpy as np

from repro_torch.index.pipeline import DedupPipeline
from repro_torch.index.protocol import StepResult
from repro_torch.service.batcher import MicroBatch

__all__ = ["BatchOutcome", "PipelinedExecutor"]


@dataclasses.dataclass
class BatchOutcome:
    """Materialized (host-side) result of one micro-batch."""
    batch: MicroBatch
    keep: np.ndarray           # (B,) bool
    keep_in_batch: np.ndarray  # (B,) bool
    ids: np.ndarray            # (B, k) int32
    sims: np.ndarray           # (B, k) f32
    wall_s: float              # submit -> materialize (pipelined latency)
    stage_times: dict | None = None   # Fig. 7 per-stage seconds (sampled)


class PipelinedExecutor:
    """Depth-bounded pipeline over a DedupPipeline.

    on_outcome: optional callback invoked for every materialized batch in
    submission order (the service wires metrics + verdict recording here).
    depth=0 degenerates to fully synchronous execution (each submit
    materializes its own result) — the comparison arm.

    timers_every=N (0 = never) runs every Nth submitted batch in blocking
    timer mode — the Fig. 7 per-stage breakdown (t_in_batch / t_search /
    t_insert) lands in that batch's BatchOutcome.stage_times. The very
    first batch is never sampled (it pays one-time set-up: the kernels'
    build and load on the card).
    """

    def __init__(self, pipe: DedupPipeline, depth: int = 2,
                 on_outcome: Callable[[BatchOutcome], Any] | None = None,
                 timers_every: int = 0):
        self.pipe = pipe
        self.depth = max(int(depth), 0)
        self.on_outcome = on_outcome
        self.timers_every = max(int(timers_every), 0)
        self._submitted = 0
        self._inflight: collections.deque[tuple[MicroBatch, StepResult,
                                                float, dict | None]] = \
            collections.deque()

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    @property
    def inflight_docs(self) -> int:
        """Valid docs dispatched but not yet materialized (backlog
        accounting for the bounded-admission check)."""
        return sum(mb.n_docs for mb, _, _, _ in self._inflight)

    def submit(self, mb: MicroBatch) -> None:
        """Dispatch one micro-batch; may materialize older ones to keep the
        pipeline no more than `depth` deep."""
        t0 = time.perf_counter()
        timers = ({} if self.timers_every and self._submitted > 0
                  and self._submitted % self.timers_every == 0 else None)
        self._submitted += 1
        sig = self.pipe.signatures(mb.tokens, mb.lengths)
        res = self.pipe.dedup_step(sig, valid=mb.valid, timers=timers)
        self._inflight.append((mb, res, t0, timers))
        while len(self._inflight) > self.depth:
            self._collect_one()

    def drain(self) -> None:
        """Materialize everything still in flight."""
        while self._inflight:
            self._collect_one()

    def _collect_one(self) -> BatchOutcome:
        mb, res, t0, timers = self._inflight.popleft()
        # THE materialization point: the verdicts leave the device here,
        # and nowhere else on the path
        out = BatchOutcome(
            batch=mb,
            keep=res.keep.cpu().numpy(),
            keep_in_batch=res.keep_in_batch.cpu().numpy(),
            ids=res.ids.cpu().numpy(),
            sims=res.sims.cpu().numpy(),
            wall_s=time.perf_counter() - t0,
            stage_times=timers,
        )
        if self.on_outcome is not None:
            self.on_outcome(out)
        return out
