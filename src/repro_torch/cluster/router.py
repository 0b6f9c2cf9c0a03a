"""DedupCluster: the client-facing facade over one writer + N replicas
(port of `repro/cluster/router.py`).

Writes (`submit`/`results`) go to the writer; reads (`query`) round-robin
over replicas that are fresh enough (epoch within max_staleness_epochs of
the writer's), falling back to the writer's own index when none qualify —
a cold cluster (nothing published yet) degrades to single-process
behavior instead of erroring. All components run in-process and
caller-driven here; the process boundary in a real deployment is exactly
the manifest + snapshot directory the replicas already poll, so nothing
in the protocol changes when the replicas move out of process.

    ┌────────┐ submit   ┌──────────────┐ snapshot+manifest ┌───────────┐
    │ client ├─────────►│ ClusterWriter├──────────────────►│ snapshots │
    │        │          │ (DedupService)│     epoch N      │  (shared) │
    │        │ query    └──────────────┘                   └─────┬─────┘
    │        ├─────────► round-robin ──► ReadReplica 0..N-1 ◄────┘
    └────────┘           (staleness-gated)    restore+swap   poll
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.cluster.replica import ReadReplica
from repro_torch.cluster.writer import (DEFAULT_TENANT, ClusterConfig,
                                        ClusterWriter)
from repro_torch.index.pipeline import QueryResult
from repro_torch.service.metrics import MetricsRegistry
from repro_torch.service.service import Ticket

__all__ = ["DedupCluster"]


class DedupCluster:
    """One writer + cfg.n_replicas in-process read replicas."""

    def __init__(self, cfg: ClusterConfig):
        self.cfg = cfg
        self.writer = ClusterWriter(cfg)
        self.replicas = [
            ReadReplica(cfg.service, cfg.service.snapshot_dir, i)
            for i in range(cfg.n_replicas)]
        self.metrics = MetricsRegistry()
        self._rr = 0

    # ------------------------------------------------------------- writes
    def submit(self, docs: Any, lengths: Any = None, *,
               tenant: str = DEFAULT_TENANT) -> Ticket:
        return self.writer.submit(docs, lengths, tenant=tenant)

    def results(self, ticket: Ticket) -> Any:
        return self.writer.results(ticket)

    def publish(self, flush: bool = True) -> int:
        return self.writer.publish(flush=flush)

    def flush(self) -> None:
        self.writer.flush()

    def poll(self) -> None:
        """One cooperative tick: pump the writer's batching clock and let
        every replica poll the manifest."""
        self.writer.poll()
        for r in self.replicas:
            r.refresh()

    def refresh_replicas(self) -> int:
        """Force a manifest poll on every replica; returns how many
        swapped in a new epoch."""
        return sum(bool(r.refresh()) for r in self.replicas)

    # -------------------------------------------------------------- reads
    def _eligible(self) -> list[ReadReplica]:
        lag = self.cfg.max_staleness_epochs
        return [r for r in self.replicas
                if r.epoch > 0 and self.writer.epoch - r.epoch <= lag]

    def query(self, tokens: Any, lengths: Any = None) -> QueryResult:
        """Route a read to a fresh-enough replica (round-robin); fall back
        to the writer's own index when none qualifies."""
        pool = self._eligible()
        if not pool:
            self.metrics.inc("query_fallback_writer")
            self.metrics.inc("query_docs", int(np.asarray(tokens).shape[0]))
            return self.writer.query(tokens, lengths)
        r = pool[self._rr % len(pool)]
        self._rr += 1
        self.metrics.inc("query_docs", int(np.asarray(tokens).shape[0]))
        self.metrics.observe("staleness_epochs",
                             float(self.writer.epoch - r.epoch))
        return r.query(tokens, lengths)

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        return {
            "router": snap,
            "writer": self.writer.stats(),
            "replicas": [r.stats() for r in self.replicas],
        }
