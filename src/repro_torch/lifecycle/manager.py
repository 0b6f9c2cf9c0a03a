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

The ledger lives on the host, so it is saved beside each index snapshot
(`save`, `load`): a restored manager expires the documents admitted
before the snapshot at the same batch an unbroken run would.

Under an open record of `repro_torch.spans`, or given the stats of the
batch after which it runs (`after_batch(record=stats)`), the expiry is
the span `lifecycle.expire` (it counts `expired` and `evicted`) and a
compaction the span `lifecycle.compact` (it counts the `rows` rebuilt and
the slots `reclaimed`). With neither, they record nothing.
"""
from __future__ import annotations

import os
import tempfile
import time
from collections import deque

import numpy as np

from repro_torch import spans

__all__ = ["LifecycleManager"]

# the ledger's file beside the index snapshot of a step
_LEDGER_FMT = "lifecycle_%08d.npz"


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

    def after_batch(self, record: dict | None = None) -> int:
        """Per-materialized-batch hook: drains exactly ONE slot-log record
        (record i belongs to the i-th materialized batch), expires and
        evicts, and compacts at the watermark. Returns the number of docs
        deleted. `record`: the stats of that batch, where its spans go."""
        return self._advance(self.pipe.backend.pop_slot_log(1), record)

    def _advance(self, logs: list, record: dict | None) -> int:
        with spans.span("lifecycle.expire", record=record):
            self._step += 1
            for slots in logs:
                if len(slots):
                    self._ledger.append((self._step, slots))
                    self._n_live += len(slots)
            doomed: list[np.ndarray] = []
            expired0, evicted0 = self.n_expired, self.n_evicted
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
            spans.add(expired=self.n_expired - expired0,
                      evicted=self.n_evicted - evicted0)
            n = 0
            if doomed:
                n = self.pipe.delete(np.concatenate(doomed))
        if self.pipe.dead_fraction >= self.compact_watermark:
            self.compact(record)
        return n

    def compact(self, record: dict | None = None) -> dict:
        """Reclaim tombstoned slots now (also called by the watermark)."""
        with spans.span("lifecycle.compact", record=record):
            t0 = time.perf_counter()
            info = self.pipe.compact()
            self.t_compact_last = time.perf_counter() - t0
            spans.add(reclaimed=int(info.get("reclaimed", 0)))
        self.t_compact_total += self.t_compact_last
        self.n_compactions += 1
        return info

    # -- the ledger beside an index snapshot -----------------------------------
    def save(self, directory: str, step: int) -> str:
        """Write the ledger, the step count and the counters beside the
        index snapshot `step` in `directory`, atomically. Slot logs of
        batches dispatched but not yet handed to `after_batch` (a pipelined
        service's) go with them: the snapshot holds those batches' rows.
        Returns the file's path."""
        os.makedirs(directory, exist_ok=True)
        pending = self.pipe.backend.pending_slot_log()
        body = {
            "step": np.int64(self._step),
            "steps": np.asarray([s for s, _ in self._ledger], np.int64),
            "sizes": np.asarray([len(x) for _, x in self._ledger], np.int64),
            "slots": _flat([x for _, x in self._ledger]),
            "pending_sizes": np.asarray([len(x) for x in pending], np.int64),
            "pending_slots": _flat(pending),
            "counters": np.asarray([self.n_expired, self.n_evicted,
                                    self.n_compactions], np.int64),
        }
        path = os.path.join(directory, _LEDGER_FMT % step)
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **body)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    def load(self, directory: str, step: int) -> bool:
        """Take the ledger saved beside snapshot `step`, after the index
        was restored from it. The pending slot logs then go through
        `after_batch`'s expiry and compaction, one batch each, as in an
        unbroken run. A missing file leaves the manager empty and returns
        False."""
        path = os.path.join(directory, _LEDGER_FMT % step)
        self._ledger.clear()
        self._step = self._n_live = 0
        if not os.path.exists(path):
            return False
        with np.load(path) as z:
            got = {k: z[k] for k in z.files}
        self._ledger.extend(zip(got["steps"].tolist(),
                                _split(got["slots"], got["sizes"])))
        self._step = int(got["step"])
        self._n_live = int(got["sizes"].sum())
        self.n_expired, self.n_evicted, self.n_compactions = (
            int(c) for c in got["counters"])
        for slots in _split(got["pending_slots"], got["pending_sizes"]):
            self._advance([slots], None)
        return True

    @staticmethod
    def prune(directory: str, keep_steps) -> None:
        """Drop the ledgers of snapshot steps not in `keep_steps`."""
        keep = {_LEDGER_FMT % s for s in keep_steps}
        try:
            names = os.listdir(directory)
        except FileNotFoundError:
            return
        for name in names:
            if (name.startswith("lifecycle_") and name.endswith(".npz")
                    and name not in keep):
                os.unlink(os.path.join(directory, name))

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


def _flat(parts: list) -> np.ndarray:
    return (np.concatenate(parts).astype(np.int32) if parts
            else np.zeros(0, np.int32))


def _split(flat: np.ndarray, sizes: np.ndarray) -> list:
    """`flat` cut into consecutive parts of `sizes`."""
    return np.split(flat, np.cumsum(sizes)[:-1]) if len(sizes) else []
