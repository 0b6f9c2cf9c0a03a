"""ClusterWriter: the single admission owner of a dedup cluster (port of
`repro/cluster/writer.py`).

Wraps one DedupService (which keeps owning micro-batching, pipelined
execution, growth, snapshot rotation) and adds the cluster-facing duties:

  publication   — `publish()` takes a SYNCHRONOUS snapshot through the
                  service's IndexManager (the manifest must only ever
                  point at fully-committed steps) and atomically bumps the
                  shared manifest's epoch. `publish_every=N` auto-publishes
                  every N materialized batches via the service's outcome
                  hook. Epochs resume from the on-disk manifest across
                  writer restarts, so replicas never see time move
                  backwards.
  tenancy       — per-tenant QPS token buckets and live-doc budgets
                  (repro_torch.cluster.tenancy). QPS rejection happens before
                  any doc is enqueued (Backpressure with an exact
                  retry-after), so an over-quota tenant cannot occupy
                  queue slots; live-doc budgets evict the tenant's oldest
                  docs through the index's DELETION CONTRACT, keeping the
                  exact-dup filter consistent via discard_refs.
  backpressure  — the service's bounded admission queue is pre-checked
                  here (all-or-nothing per request, and BEFORE the token
                  bucket so a queue rejection never burns quota tokens).

The writer is caller-driven like everything else in the repo: no threads,
no daemons — `submit`/`poll`/`flush` pump the machinery.

The index organization underneath is pluggable (`ServiceConfig.backend`,
any deletion-capable backend of the port for tenant budgets), and the
index lives on `ServiceConfig.device`. On the sharded "hnsw_sharded"
backend (`ServiceConfig(shards>1)`), published epochs are the backend's
coordinated per-shard-stacked snapshots, and the slot ids in the tenancy
ledger are its GLOBAL interleaved ids (`local * nshards + shard`), which
the deletion contract routes to the owning shard: budget evictions work
unchanged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np

from repro_torch.cluster.manifest import (ClusterManifest, publish_manifest,
                                          read_manifest)
from repro_torch.cluster.tenancy import Clock, TenantSpec, TenantState
from repro_torch.index.pipeline import QueryResult
from repro_torch.service.batcher import Backpressure
from repro_torch.service.service import DedupService, ServiceConfig, Ticket

__all__ = ["ClusterConfig", "ClusterWriter"]

DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """One writer + N read replicas sharing service.snapshot_dir."""
    service: ServiceConfig
    n_replicas: int = 2
    # auto-publish a new epoch every N materialized batches (0 = manual
    # publish() only). Mutually exclusive with service.snapshot_every —
    # unpublished periodic snapshots would rotate published steps away.
    publish_every: int = 0
    # replicas lagging more than this many epochs behind the writer are
    # routed around (DedupCluster.query falls back to the writer's own
    # index when no replica qualifies)
    max_staleness_epochs: int = 1
    tenants: tuple[TenantSpec, ...] = ()
    # unknown tenant names auto-register with no quotas (True) or raise
    allow_unregistered: bool = True


class ClusterWriter:
    """Admission owner: DedupService + manifest publication + tenancy."""

    def __init__(self, cfg: ClusterConfig, clock: Clock = time.perf_counter):
        self.cfg = cfg
        scfg = cfg.service
        if not scfg.snapshot_dir:
            raise ValueError("ClusterConfig.service.snapshot_dir is "
                             "required: replicas refresh from it")
        if cfg.publish_every and scfg.snapshot_every:
            raise ValueError(
                "set publish_every OR service.snapshot_every, not both: "
                "periodic unpublished snapshots would rotate the published "
                "step out from under the replicas")
        if not scfg.record_verdicts:
            raise ValueError("ClusterWriter requires record_verdicts=True "
                             "(tenant bookkeeping reads the verdict store)")
        self.service = DedupService(scfg)
        if self.service.index_manager is None:
            raise ValueError(
                f"backend {self.service.pipeline.backend.name!r} has no "
                f"snapshot lifecycle (supports_growth/snapshots=False); "
                f"a cluster writer cannot publish epochs for it")
        self._clock = clock
        self._tenants: dict[str, TenantState] = {
            t.name: TenantState(t, clock) for t in cfg.tenants}
        self._tenants.setdefault(DEFAULT_TENANT,
                                 TenantState(TenantSpec(DEFAULT_TENANT),
                                             clock))
        self._budgeted = any(t.spec.max_live_docs is not None
                             for t in self._tenants.values())
        be = self.service.pipeline.backend
        if self._budgeted:
            if not be.supports_deletion:
                raise ValueError(
                    f"per-tenant max_live_docs budgets need a "
                    f"supports_deletion backend; {be.name!r} has none")
            if self.service.lifecycle is not None:
                # both would drain the backend's one-record-per-batch slot
                # log; two consumers corrupt the admission-order ledger
                raise ValueError(
                    "tenant live-doc budgets and service-level "
                    "ttl_steps/max_live_docs are mutually exclusive "
                    "(single slot-log consumer)")
            be.track_slots = True
        # doc id -> tenant name for docs whose outcome has not materialized
        self._doc_tenant: dict[int, str] = {}
        # epoch resumes from the shared manifest so a restarted writer
        # publishes strictly later epochs than its predecessor
        m = read_manifest(scfg.snapshot_dir)
        self.epoch = m.epoch if m is not None else 0
        self.publishes = 0
        self._batches_since_publish = 0
        self.service.outcome_hooks.append(self._on_outcome)

    # ------------------------------------------------------------- ingest
    def submit(self, docs: Any, lengths: Any = None, *,
               tenant: str = DEFAULT_TENANT) -> Ticket:
        """Tenant-routed admission. Raises Backpressure (nothing enqueued)
        on a full queue or an over-rate tenant."""
        st = self._tenants.get(tenant)
        if st is None:
            if not self.cfg.allow_unregistered:
                raise KeyError(f"unknown tenant {tenant!r}; registered: "
                               f"{sorted(self._tenants)}")
            st = self._tenants[tenant] = TenantState(TenantSpec(tenant),
                                                     self._clock)
        if lengths is not None:
            n = int(np.asarray(docs).shape[0])
        else:
            docs = [np.asarray(d) for d in docs]
            n = len(docs)
        st.submitted += n
        # queue headroom BEFORE the token bucket: a queue-full rejection
        # must not burn the tenant's quota tokens
        headroom = self.service.admission_headroom()
        if headroom is not None and n > headroom:
            st.rejected_queue += n
            self.service.metrics.inc("docs_rejected", n)
            raise Backpressure("queue_full",
                               retry_after_s=self.cfg.service.retry_after_s,
                               tenant=tenant)
        if st.bucket is not None and not st.bucket.try_take(n):
            st.rejected_qps += n
            self.service.metrics.inc("docs_rejected_qps", n)
            raise Backpressure("qps_quota", retry_after_s=st.bucket.eta(n),
                               tenant=tenant)
        # register ownership for the ids this submit WILL assign, before
        # the service can materialize any of them (submit pumps the
        # executor, so outcomes for these very docs may fire inside it)
        start = self.service.next_doc_id
        for did in range(start, start + n):
            self._doc_tenant[did] = tenant
        try:
            ticket = self.service.submit(docs, lengths)
        except BaseException:
            for did in range(start, start + n):
                self._doc_tenant.pop(did, None)
            raise
        # exact-dup short-circuits resolve at submit and never reach an
        # outcome — drop their ownership entries now (materialized docs
        # were already popped by the hook)
        for did in range(*ticket):
            if did in self._doc_tenant and self.service.verdict_ready(did):
                del self._doc_tenant[did]
        return ticket

    def results(self, ticket: Ticket) -> Any:
        return self.service.results(ticket)

    def poll(self) -> None:
        self.service.poll()

    def flush(self) -> None:
        self.service.flush()

    def query(self, tokens: Any, lengths: Any = None) -> QueryResult:
        """Writer-local read path (the router's fallback when every
        replica is too stale)."""
        return self.service.pipeline.query(tokens, lengths)

    # ------------------------------------------------- outcome bookkeeping
    def _on_outcome(self, out: Any) -> None:
        mb = out.batch
        if self._budgeted:
            # exactly ONE slot-log record per materialized batch (the
            # lifecycle discipline): slots are in kept-row order
            logs = self.service.pipeline.backend.pop_slot_log(1)
            slots = (np.asarray(logs[0], np.int64) if logs
                     else np.zeros(0, np.int64))
            kept_rows = np.flatnonzero(out.keep & mb.valid)
            for row, slot in zip(kept_rows, slots):
                did = int(mb.doc_ids[row])
                name = self._doc_tenant.get(did, DEFAULT_TENANT)
                st = self._tenants.setdefault(
                    name, TenantState(TenantSpec(name), self._clock))
                st.ledger.append((did, int(slot)))
                st.admitted += 1
        else:
            for row in np.flatnonzero(out.keep & mb.valid):
                name = self._doc_tenant.get(int(mb.doc_ids[row]),
                                            DEFAULT_TENANT)
                if name in self._tenants:
                    self._tenants[name].admitted += 1
        for row in np.flatnonzero(mb.valid):
            self._doc_tenant.pop(int(mb.doc_ids[row]), None)
        if self._budgeted:
            self._enforce_budgets()
        if self.cfg.publish_every:
            self._batches_since_publish += 1
            if self._batches_since_publish >= self.cfg.publish_every:
                # no flush inside the hook — we ARE the flush path
                self.publish(flush=False)

    def _enforce_budgets(self) -> None:
        doomed_slots: list[int] = []
        doomed_docs: list[int] = []
        for st in self._tenants.values():
            n_over = st.over_budget()
            for _ in range(n_over):
                did, slot = st.ledger.popleft()
                doomed_docs.append(did)
                doomed_slots.append(slot)
            st.evicted += n_over
        if not doomed_slots:
            return
        pipe = self.service.pipeline
        n = pipe.delete(np.asarray(doomed_slots, np.int64))
        self.service.metrics.inc("docs_evicted_budget", len(doomed_slots))
        if pipe.exact is not None:
            pipe.exact.discard_refs(np.asarray(doomed_docs, np.int64))
        if (pipe.dead_fraction
                >= self.cfg.service.compact_watermark > 0):
            pipe.compact()
        del n

    # ------------------------------------------------------------ publish
    def publish(self, flush: bool = True) -> int:
        """Commit a synchronous snapshot and advance the manifest epoch.
        Returns the new epoch."""
        if flush:
            self.service.flush()
        im = self.service.index_manager
        step = im.snapshot(sync=True)
        self.epoch += 1
        self.publishes += 1
        self._batches_since_publish = 0
        pipe = self.service.pipeline
        extra = {}
        if pipe.exact is not None:
            extra["exact_entries"] = len(pipe.exact)
        publish_manifest(self.cfg.service.snapshot_dir, ClusterManifest(
            epoch=self.epoch, step=step, count=int(pipe.inserted),
            backend=pipe.backend.name, published_unix=time.time(),
            extra=extra))
        return self.epoch

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        snap = self.service.stats()
        snap["cluster"] = {
            "role": "writer",
            "epoch": self.epoch,
            "publishes": self.publishes,
            "pending_ownership": len(self._doc_tenant),
            "tenants": {name: st.stats()
                        for name, st in self._tenants.items()},
        }
        return snap
