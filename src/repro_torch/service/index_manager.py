"""Index lifecycle: capacity growth and snapshot rotation for any backend
(port of `repro/service/index_manager.py`).

Growth. Index capacity is dense pre-allocated storage, and every
registered backend implements the protocol's `grow()`. The manager
decides WHEN: occupancy is a device count and reading it would stall the
executor every batch, so the manager tracks a sync-free upper bound (last
known count + docs dispatched since) and only pays a host sync when that
bound crosses the high-water mark. Growth is geometric (default 2x), so
the re-allocations amortize to O(log corpus).

Snapshots. Rolling rotation on top of train/checkpoint's atomic-commit
layout: every `snapshot_every` batches the pipeline state is saved and only
the newest `max_snapshots` committed steps are kept — restart cost is
bounded and disk does not grow with corpus lifetime. An asynchronous
snapshot's own step is left out of the listing the rotation works on,
whether or not its background write has committed yet, so the rotation
always lands on `max_snapshots` committed steps.

Where a `LifecycleManager` is attached (`lifecycle`, which
`DedupService` sets when its lifecycle is on), each snapshot carries its
ledger beside the step (`LifecycleManager.save`), rotated with the step,
and `restore_latest` loads it back, so that the documents admitted before
the snapshot expire when they would have.

The sharded backend is re-exported here, as in the reference.
"""
from __future__ import annotations

import os
import shutil

from repro_torch.index.backends.sharded import ShardedDedupBackend
from repro_torch.index.pipeline import DedupPipeline
from repro_torch.train import checkpoint as ckpt

__all__ = ["IndexManager", "ShardedDedupBackend"]


class IndexManager:
    def __init__(self, pipe: DedupPipeline, *, grow_watermark: float = 0.85,
                 growth_factor: float = 2.0, max_capacity: int | None = None,
                 snapshot_dir: str | None = None, snapshot_every: int = 0,
                 max_snapshots: int = 3):
        assert 0.0 < grow_watermark <= 1.0
        assert growth_factor > 1.0
        self.pipe = pipe
        self.grow_watermark = grow_watermark
        self.growth_factor = growth_factor
        self.max_capacity = max_capacity
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        self.max_snapshots = max_snapshots
        self.grow_events = 0
        self.snapshots_taken = 0
        self._known_count = 0      # occupancy at the last host sync
        self._dispatched = 0       # docs submitted since that sync
        self._batches = 0
        # resume the step counter past any snapshots already on disk so a
        # restarted service never clobbers committed history
        self._snap_step = (ckpt.latest_step(snapshot_dir) or 0
                           if snapshot_dir else 0)
        # last step this manager wrote (0 = none yet this process); the
        # cluster writer publishes manifests only for steps it took itself
        self.last_step = 0
        # the document lifecycle whose ledger goes with each snapshot
        self.lifecycle = None

    # ------------------------------------------------------------- growth
    def note_dispatched(self, n_docs: int):
        """Record docs entering the pipeline (admitted count <= dispatched)."""
        self._dispatched += n_docs

    def maybe_grow(self, incoming: int = 0) -> bool:
        """Grow if occupancy may cross the high-water mark once `incoming`
        further docs are dispatched. Call BEFORE note_dispatched(incoming).

        The upper bound (known + dispatched + incoming) is sync-free; only
        when it crosses the mark do we read the true device count (one
        pipeline bubble per growth decision, not per batch). Because the
        bound covers the incoming batch and growth is sized until the bound
        clears the mark, the index can never silently hit capacity — unless
        max_capacity clamps the growth, which is the caller's explicit
        ceiling."""
        def mark() -> int:
            return int(self.grow_watermark * self.pipe.capacity)

        if self._known_count + self._dispatched + incoming < mark():
            return False
        # host sync: waits for every dispatched insert, so the true count
        # covers everything except the incoming batch
        self._known_count = self.pipe.inserted
        self._dispatched = 0
        if self._known_count + incoming < mark():
            return False
        new_cap = self.pipe.capacity
        while self._known_count + incoming >= int(self.grow_watermark
                                                  * new_cap):
            # max() guards factors close to 1, where int(cap*f) == cap
            new_cap = max(new_cap + 1, int(new_cap * self.growth_factor))
        if self.max_capacity is not None:
            new_cap = min(new_cap, self.max_capacity)
        grew = new_cap > self.pipe.capacity
        if grew:
            self.pipe.grow(new_cap)
            self.grow_events += 1
        # max_capacity may have clamped growth below what the batch needs
        # (or forbidden it entirely). Refuse rather than let the insert
        # silently drop rows whose verdicts would still claim 'admitted'.
        if self._known_count + incoming > self.pipe.capacity:
            raise RuntimeError(
                f"index full: {self._known_count} of {self.pipe.capacity} "
                f"slots used, incoming batch of {incoming} may not fit and "
                f"max_capacity={self.max_capacity} forbids further growth")
        return grew

    # ----------------------------------------------------------- snapshots
    def after_batch(self):
        """Per-materialized-batch hook: periodic snapshot rotation.

        Periodic snapshots write asynchronously (device->host copy now,
        disk in a background thread) so the dispatch pipeline never stalls
        on I/O; at most one write is in flight at a time."""
        self._batches += 1
        if (self.snapshot_dir and self.snapshot_every
                and self._batches % self.snapshot_every == 0):
            self.snapshot(sync=False)

    def snapshot(self, sync: bool = True) -> int:
        assert self.snapshot_dir, "no snapshot_dir configured"
        ckpt.wait_pending()     # order writes; rotation then sees the truth
        self._snap_step += 1
        self.pipe.save(self.snapshot_dir, self._snap_step,
                       async_write=not sync)
        if self.lifecycle is not None:
            self.lifecycle.save(self.snapshot_dir, self._snap_step)
        self.snapshots_taken += 1
        # rotate the OTHER committed steps down to max_snapshots - 1: this
        # step is left out of the listing whether or not an async write of
        # it has committed already (a write that commits before the listing
        # would otherwise be counted twice, once listed and once in flight)
        keep = self.max_snapshots - 1
        steps = [s for s in ckpt.list_steps(self.snapshot_dir)
                 if s != self._snap_step]
        for old in (steps[:-keep] if keep > 0 else steps):
            shutil.rmtree(os.path.join(self.snapshot_dir,
                                       f"step_{old:08d}"))
        # drop the sidecars of rotated-away steps (the current step's
        # exists even while its array write is still in flight, so keep it
        # explicitly)
        kept = set(steps[-keep:] if keep > 0 else [])
        kept.add(self._snap_step)
        if getattr(self.pipe, "exact", None) is not None:
            self.pipe.exact.prune_sidecars(self.snapshot_dir, kept)
        if self.lifecycle is not None:
            self.lifecycle.prune(self.snapshot_dir, kept)
        self.last_step = self._snap_step
        return self._snap_step

    def committed_steps(self) -> tuple[int, ...]:
        """Snapshot steps currently committed on disk, ascending."""
        if not self.snapshot_dir:
            return ()
        return tuple(ckpt.list_steps(self.snapshot_dir))

    def wait_snapshots(self):
        """Block until any in-flight async snapshot write has committed."""
        ckpt.wait_pending()

    def restore_latest(self) -> int | None:
        if not self.snapshot_dir:
            return None
        ckpt.wait_pending()
        step = ckpt.latest_step(self.snapshot_dir)
        if step is None:
            return None
        self.pipe.restore(self.snapshot_dir, step)
        if self.lifecycle is not None:
            self.lifecycle.load(self.snapshot_dir, step)
        self._snap_step = step
        self._known_count = self.pipe.inserted
        self._dispatched = 0
        return step
