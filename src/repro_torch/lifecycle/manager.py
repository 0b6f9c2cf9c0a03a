"""LifecycleManager: the document-retention policy loop (port of
`repro/lifecycle/manager.py`).

Per-document TTL (`ttl_steps`: a doc expires a fixed number of
materialized batches after insertion) and a live-set ceiling
(`max_live_docs`: eviction in insertion order), with compaction run when
the backend's tombstone fraction crosses a watermark.

The backend owns the mechanism (the protocol's DELETION CONTRACT); this
manager owns the policy and the doc -> slot ledger, built from the
backend's slot log (`track_slots` / `pop_slot_log`): each materialized
batch appends one (step, slots) record, so insertion order is ledger
order and both TTL and eviction pop from the head. Everything here is
host bookkeeping; the only device work is the backend's `delete` and the
watermark-triggered `compact`.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np

__all__ = ["LifecycleManager"]


class LifecycleManager:
    def __init__(self, pipe, *, ttl_steps: int = 0,
                 max_live_docs: int | None = None,
                 compact_watermark: float = 0.25):
        """pipe: a DedupPipeline over a supports_deletion backend.

        ttl_steps: expire a doc once `ttl_steps` further batches have
        materialized (0 = no TTL). max_live_docs: evict the oldest-inserted
        docs beyond this many live (None = unbounded). compact_watermark:
        run compact() when dead_fraction reaches it (>= 1.0 disables)."""
        be = pipe.backend
        if not getattr(be, "supports_deletion", False):
            raise ValueError(
                f"lifecycle policies (ttl_steps/max_live_docs) need a "
                f"deletion-capable index, but backend {be.name!r} has "
                f"supports_deletion=False")
        if ttl_steps < 0:
            raise ValueError(f"ttl_steps must be >= 0, got {ttl_steps}")
        if max_live_docs is not None and max_live_docs <= 0:
            raise ValueError(f"max_live_docs must be > 0, got {max_live_docs}")
        self.pipe = pipe
        self.ttl_steps = ttl_steps
        self.max_live_docs = max_live_docs
        self.compact_watermark = compact_watermark
        be.track_slots = True      # opt into the slot log (insertion order)
        self._ledger: deque[tuple[int, np.ndarray]] = deque()
        self._step = 0             # materialized batches seen
        self._n_live = 0           # docs in the ledger
        self.n_expired = 0
        self.n_evicted = 0
        self.n_compactions = 0
        self.t_compact_last = 0.0
        self.t_compact_total = 0.0

    def after_batch(self) -> int:
        """Per-materialized-batch hook: drains exactly ONE slot-log record
        (record i belongs to the i-th materialized batch), expires and
        evicts, and compacts at the watermark. Returns the number of docs
        deleted."""
        self._step += 1
        for slots in self.pipe.backend.pop_slot_log(1):
            if len(slots):
                self._ledger.append((self._step, slots))
                self._n_live += len(slots)
        doomed: list[np.ndarray] = []
        if self.ttl_steps:
            horizon = self._step - self.ttl_steps
            while self._ledger and self._ledger[0][0] <= horizon:
                _, slots = self._ledger.popleft()
                doomed.append(slots)
                self._n_live -= len(slots)
                self.n_expired += len(slots)
        if self.max_live_docs is not None:
            while self._n_live > self.max_live_docs and self._ledger:
                _, slots = self._ledger.popleft()
                doomed.append(slots)
                self._n_live -= len(slots)
                self.n_evicted += len(slots)
        n = 0
        if doomed:
            n = self.pipe.delete(np.concatenate(doomed))
        if self.pipe.dead_fraction >= self.compact_watermark:
            self.compact()
        return n

    def compact(self) -> dict:
        """Reclaim tombstoned slots now (also called by the watermark)."""
        t0 = time.perf_counter()
        info = self.pipe.compact()
        self.t_compact_last = time.perf_counter() - t0
        self.t_compact_total += self.t_compact_last
        self.n_compactions += 1
        return info

    def stats(self) -> dict:
        return {
            "ttl_steps": self.ttl_steps,
            "max_live_docs": self.max_live_docs,
            "tracked_live": self._n_live,
            "n_expired": self.n_expired,
            "n_evicted": self.n_evicted,
            "n_compactions": self.n_compactions,
            "t_compact_last": self.t_compact_last,
            "t_compact_total": self.t_compact_total,
        }
