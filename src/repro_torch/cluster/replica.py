"""ReadReplica: a search-only serving process fed by snapshot rotation
(port of `repro/cluster/replica.py`).

A replica owns a private pipeline built from the SAME ServiceConfig shape
as the writer (resolve_backend guarantees identical backend/opts), but
never inserts: it serves `query()` — "is this a dup?" — against the last
snapshot it restored. `refresh()` polls the shared manifest; on a new
epoch it restores the published step into a FRESH pipeline and swaps it
in with one reference assignment, so queries racing a refresh always see
a complete index (the old one until the very last instant).

Degradation is graceful by construction:
  * manifest missing/corrupt        → keep serving the current index
  * published step already rotated  → refresh_failures += 1, keep serving
  * writer published k>1 epochs between polls → epochs_skipped += k-1
    (the replica jumps straight to the newest epoch; skipping is lag
    accounting, not an error)

Staleness metrics (`epochs_behind`, seconds since refresh) feed the
router's max_staleness_epochs policy and the load harness report.

The replica's index lives on its service config's device (cuda unless
"cpu" is asked for), which need not be the writer's. Snapshots are in
the reference's byte layout, so a replica restores an epoch published by
either package's writer.
"""
from __future__ import annotations

import time
from typing import Any

from repro_torch.cluster.manifest import read_manifest
from repro_torch.index import make_pipeline
from repro_torch.index.pipeline import DedupPipeline, QueryResult
from repro_torch.service.metrics import MetricsRegistry
from repro_torch.service.service import ServiceConfig, resolve_backend

__all__ = ["ReadReplica"]


class ReadReplica:
    def __init__(self, service_cfg: ServiceConfig, snapshot_dir: str | None
                 = None, replica_id: int = 0):
        self.snapshot_dir = snapshot_dir or service_cfg.snapshot_dir
        if not self.snapshot_dir:
            raise ValueError("ReadReplica needs a snapshot_dir to poll")
        self._key, self._opts = resolve_backend(service_cfg)
        self._fold = service_cfg.fold
        self.replica_id = replica_id
        self.pipeline = self._build()
        self.epoch = 0              # manifest epochs start at 1
        self.step = 0
        self.writer_epoch = 0       # last epoch seen in the manifest
        self.refreshes = 0
        self.refresh_failures = 0
        self.epochs_skipped = 0
        self._last_refresh_t: float | None = None
        self.metrics = MetricsRegistry()

    def _build(self) -> DedupPipeline:
        return make_pipeline(self._key, cfg=self._fold, **self._opts)

    # ------------------------------------------------------------ refresh
    def refresh(self) -> bool:
        """Poll the manifest; restore + swap when a newer epoch is
        published. Returns True iff the serving index changed."""
        m = read_manifest(self.snapshot_dir)
        if m is None:
            return False
        self.writer_epoch = max(self.writer_epoch, m.epoch)
        if m.epoch <= self.epoch:
            return False
        # restore into a FRESH pipeline; the current one keeps serving
        # until the swap, and survives a failed restore untouched
        fresh = self._build()
        try:
            fresh.restore(self.snapshot_dir, m.step)
        except FileNotFoundError:
            # the step was rotated away before we got to it (we lagged
            # more than max_snapshots publishes) — degrade: keep serving
            # the old index and try again next poll
            self.refresh_failures += 1
            self.metrics.inc("refresh_failures")
            return False
        if self.epoch > 0 and m.epoch > self.epoch + 1:
            self.epochs_skipped += m.epoch - self.epoch - 1
        self.pipeline = fresh           # atomic swap
        self.epoch = m.epoch
        self.step = m.step
        self.refreshes += 1
        self.metrics.inc("refreshes")
        self._last_refresh_t = time.perf_counter()
        return True

    @property
    def epochs_behind(self) -> int:
        return max(0, self.writer_epoch - self.epoch)

    # -------------------------------------------------------------- query
    def query(self, tokens: Any, lengths: Any = None) -> QueryResult:
        """Read-only dup verdicts against the replica's current epoch."""
        t0 = time.perf_counter()
        out = self.pipeline.query(tokens, lengths)
        self.metrics.observe("query_ms", (time.perf_counter() - t0) * 1e3)
        self.metrics.inc("queries")
        self.metrics.inc("query_docs", int(len(out.is_dup)))
        return out

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        age = (time.perf_counter() - self._last_refresh_t
               if self._last_refresh_t is not None else None)
        snap = self.metrics.snapshot()
        snap["cluster"] = {
            "role": "replica",
            "replica_id": self.replica_id,
            "epoch": self.epoch,
            "step": self.step,
            "writer_epoch": self.writer_epoch,
            "epochs_behind": self.epochs_behind,
            "epochs_skipped": self.epochs_skipped,
            "refreshes": self.refreshes,
            "refresh_failures": self.refresh_failures,
            "refresh_age_s": age,
            "count": self.pipeline.inserted if self.epoch else 0,
        }
        return snap
