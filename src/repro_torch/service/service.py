"""DedupService: the online ingestion front-end, tickets in, verdicts out
(port of `repro/service/service.py`).

Composition of the serving subsystem:

  submit(docs) ─> MicroBatcher ─> PipelinedExecutor ─> verdict store
                  (bucketed        (depth-bounded,        ^
                   coalescing)      one CUDA stream)      │
                        IndexManager (growth + snapshots) ┘

The index organization is pluggable: `ServiceConfig.backend` names any
`repro_torch.index` registry key ("hnsw" — FOLD, the default —
"hnsw_sharded", "hnsw_raw", "brute", "dpk", "flat_lsh", "prefix_filter",
or a third-party registration), and the service composes the generic
DedupPipeline for it. It runs on `ServiceConfig.device`: cuda unless
"cpu" is asked for, and with no card a cuda service raises.
Every backend gets micro-batching, pipelined execution, growth watermarks,
and snapshot rotation for free; backends that declare
supports_growth/supports_snapshots = False run without an IndexManager.

The service is caller-driven (no background thread): `submit` pumps every
batch the batching policy allows, `flush` forces the ragged remainder
through and blocks until all in-flight batches materialize, and `results`
flushes on demand when a ticket's verdicts are not yet complete. This keeps
the whole subsystem deterministic and exception-transparent — the properties
the equivalence tests rely on.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from repro_torch.core.dedup import FoldConfig
from repro_torch.core.hnsw import program_cache_sizes
from repro_torch.index import make_pipeline, validate_opts
from repro_torch.index.exact import doc_hash
from repro_torch.lifecycle import LifecycleManager
from repro_torch.service.batcher import Backpressure, MicroBatcher
from repro_torch.service.executor import BatchOutcome, PipelinedExecutor
from repro_torch.service.index_manager import IndexManager
from repro_torch.service.metrics import MetricsRegistry

__all__ = ["ServiceConfig", "DedupService", "DocVerdict", "Ticket",
           "Backpressure", "resolve_backend"]


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    fold: FoldConfig = dataclasses.field(default_factory=FoldConfig)
    # index organization: any repro_torch.index registry key + factory options
    # (e.g. backend="flat_lsh", backend_opts={"topk": 160}). FoldConfig
    # fields can be overridden per-service the same way — e.g.
    # backend_opts={"query_chunk": 256} bounds the batched-search visited
    # working set (fold.query_chunk=None derives a default from capacity).
    backend: str = "hnsw"
    backend_opts: dict = dataclasses.field(default_factory=dict)
    # micro-batching
    max_batch: int = 128
    max_wait_ms: float = 5.0
    max_len: int = 512
    len_buckets: tuple[int, ...] | None = None
    batch_buckets: tuple[int, ...] | None = None
    # pipelining
    pipeline_depth: int = 2
    # Fig. 7 stage-breakdown sampling: every Nth micro-batch runs in
    # blocking timer mode and its t_in_batch / t_search / t_insert land in
    # the stats() latency histograms (0 disables). A timed batch blocks
    # between stages, so keep N well above the pipeline depth.
    stage_timer_every: int = 32
    # index lifecycle
    grow_watermark: float = 0.85
    growth_factor: float = 2.0
    max_capacity: int | None = None
    snapshot_dir: str | None = None
    snapshot_every: int = 0          # batches between snapshots; 0 = off
    max_snapshots: int = 3
    # document lifecycle (repro_torch.lifecycle; requires a supports_deletion
    # backend): ttl_steps expires a doc that many materialized batches
    # after insertion (0 = off); max_live_docs evicts oldest-inserted docs
    # beyond the ceiling (None = off); compact_watermark triggers index
    # compaction once that fraction of capacity is tombstoned
    ttl_steps: int = 0
    max_live_docs: int | None = None
    compact_watermark: float = 0.25
    # distribution: >1 selects the "hnsw_sharded" backend (fold.capacity
    # is then per shard; every shard lives on `device`)
    shards: int = 1
    # bounded admission: reject submits (Backpressure, with a retry-after
    # hint) once pending + in-flight docs would exceed this bound, instead
    # of letting the queue grow without limit under overload (None = the
    # historical unbounded behavior). Rejection is all-or-nothing per
    # submit — a rejected call enqueues nothing.
    max_pending_docs: int | None = None
    retry_after_s: float = 0.05
    # fire-and-forget producers that only read stats() should disable the
    # per-doc verdict store — it grows with every document until results()
    # pops it, i.e. forever if nobody asks
    record_verdicts: bool = True
    # the torch device of the index: None means cuda (raises with no card)
    device: str | None = None


@dataclasses.dataclass(frozen=True)
class DocVerdict:
    doc_id: int
    admitted: bool
    reason: str            # "admitted" | "batch_dup" | "index_dup" | "exact_dup"
    neighbor_id: int       # best retrieved neighbor (-1 = none)
    similarity: float      # its similarity (-inf when no neighbor)


class Ticket(NamedTuple):
    start: int   # first doc id covered (inclusive)
    stop: int    # last doc id covered (exclusive)


def resolve_backend(cfg: ServiceConfig) -> tuple[str, dict]:
    """(registry key, factory opts) for a service config — the shards>1
    promotion to "hnsw_sharded", backend_opts validation against the
    factory's accepted keys, and the config's device. Shared by
    DedupService and the cluster read replicas, which must build the
    IDENTICAL pipeline shape."""
    backend_key = cfg.backend
    opts = dict(cfg.backend_opts)
    if cfg.shards > 1:
        if backend_key == "hnsw":
            backend_key = "hnsw_sharded"
        elif backend_key != "hnsw_sharded":
            raise ValueError(
                f"shards={cfg.shards} requires the 'hnsw_sharded' "
                f"backend, got backend={cfg.backend!r}")
        opts.setdefault("shards", cfg.shards)
    # unknown keys raise with the accepted list instead of being silently
    # swallowed by a **opts factory
    validate_opts(backend_key, opts)
    opts.setdefault("device", cfg.device)
    return backend_key, opts


class DedupService:
    """Online dedup serving facade over any registered index backend."""

    def __init__(self, cfg: ServiceConfig | None = None):
        self.cfg = cfg = cfg or ServiceConfig()
        backend_key, opts = resolve_backend(cfg)
        self.pipeline = make_pipeline(backend_key, cfg=cfg.fold, **opts)
        be = self.pipeline.backend
        # capability flags are defaulted class attributes on DedupBackend
        # (every built-in subclasses it; structural third-party backends
        # define their own — see protocol.py)
        if not be.supports_snapshots and (
                cfg.snapshot_dir or cfg.snapshot_every):
            raise ValueError(
                f"snapshots are not supported by backend {be.name!r}; "
                f"unset snapshot_dir/snapshot_every")
        if be.supports_growth:
            self.index_manager = IndexManager(
                self.pipeline, grow_watermark=cfg.grow_watermark,
                growth_factor=cfg.growth_factor,
                max_capacity=cfg.max_capacity,
                snapshot_dir=cfg.snapshot_dir,
                snapshot_every=cfg.snapshot_every,
                max_snapshots=cfg.max_snapshots)
        else:
            self.index_manager = None        # capacity is fixed at init
        if cfg.ttl_steps or cfg.max_live_docs is not None:
            if self.pipeline.exact is not None:
                # service-level lifecycle evicts by index slot and cannot
                # map evictions back to content hashes, so the filter would
                # keep vetoing re-admission of evicted docs forever. The
                # cluster writer's per-tenant budgets DO maintain the
                # (doc id, slot, hash) ledger — use those instead.
                raise ValueError(
                    "fold.exact_filter is incompatible with service-level "
                    "ttl_steps/max_live_docs (evicted docs' hashes would "
                    "veto their own re-admission); use repro_torch.cluster "
                    "per-tenant live-doc budgets instead")
            # raises for supports_deletion=False backends
            self.lifecycle = LifecycleManager(
                self.pipeline, ttl_steps=cfg.ttl_steps,
                max_live_docs=cfg.max_live_docs,
                compact_watermark=cfg.compact_watermark)
        else:
            self.lifecycle = None            # documents never leave
        self.batcher = MicroBatcher(
            max_batch=cfg.max_batch, max_wait_ms=cfg.max_wait_ms,
            len_buckets=cfg.len_buckets, batch_buckets=cfg.batch_buckets,
            max_len=cfg.max_len, max_pending=cfg.max_pending_docs)
        self.metrics = MetricsRegistry()
        self.executor = PipelinedExecutor(
            self.pipeline, depth=cfg.pipeline_depth,
            on_outcome=self._record_outcome,
            timers_every=cfg.stage_timer_every)
        self._next_id = 0
        self._verdicts: dict[int, DocVerdict] = {}
        # exact front door: content hash of each queued (not yet
        # materialized) doc, so _record_outcome can register admitted docs
        # in the filter under their service doc id
        self._pending_hash: dict[int, int] = {}
        # extension hooks invoked (in order) at the END of every
        # materialized-batch callback — the cluster writer wires manifest
        # publication and tenant ledger upkeep here
        self.outcome_hooks: list = []

    @property
    def backend(self):
        """The serving pipeline (the reference's older attribute name)."""
        return self.pipeline

    @property
    def next_doc_id(self) -> int:
        """The doc id the next submitted document will receive (ids are
        assigned sequentially; the cluster writer uses this to register
        per-tenant ownership before outcomes can materialize)."""
        return self._next_id

    # ------------------------------------------------------------ ingest
    def backlog(self) -> int:
        """Docs accepted but not yet materialized (queued + in flight)."""
        return self.batcher.pending + self.executor.inflight_docs

    def admission_headroom(self) -> int | None:
        """Docs a submit may add before Backpressure (None = unbounded)."""
        if self.cfg.max_pending_docs is None:
            return None
        return max(0, self.cfg.max_pending_docs - self.backlog())

    def submit(self, docs, lengths=None) -> Ticket:
        """Queue documents; returns a ticket covering their doc ids.

        docs: either an iterable of 1-D token arrays, or a padded (N, L)
        matrix with `lengths` (the corpus/ingest interchange format).

        Raises Backpressure (all-or-nothing: nothing was enqueued) when
        max_pending_docs is configured and the request does not fit.

        With the exact-dup front end on (fold.exact_filter), documents
        whose content hash is already known are resolved HERE — an instant
        "exact_dup" verdict, no batching, no signature, no search."""
        if lengths is not None:
            docs = np.asarray(docs)
            seq = [docs[i, : int(lengths[i])] for i in range(docs.shape[0])]
        else:
            seq = [np.asarray(d) for d in docs]
        n = len(seq)
        if self.cfg.max_pending_docs is not None \
                and self.backlog() + n > self.cfg.max_pending_docs:
            self.metrics.inc("docs_rejected", n)
            raise Backpressure("queue_full",
                               retry_after_s=self.cfg.retry_after_s)
        start = self._next_id
        exact = self.pipeline.exact
        cap = self.batcher.len_buckets[-1]
        for d in seq:
            did = self._next_id
            self._next_id += 1
            if exact is not None:
                # hash what the batcher will actually process (truncation
                # included), so replays of over-length docs still hit
                h = doc_hash(d[:cap])
                ref = exact.lookup(h)
                if ref is not None:
                    exact.record_hit()
                    self.metrics.inc("exact_dup")
                    self.metrics.inc("docs_out")
                    if self.cfg.record_verdicts:
                        self._verdicts[did] = DocVerdict(
                            doc_id=did, admitted=False, reason="exact_dup",
                            neighbor_id=int(ref), similarity=1.0)
                    continue
                self._pending_hash[did] = h
            self.batcher.add(did, d)
        self.metrics.inc("docs_in", n)
        self._pump()
        return Ticket(start, self._next_id)

    def _pump(self, force: bool = False) -> None:
        # On failure, keep the ticket contract: batches that never reached
        # the executor go back to the queue so results() can still find
        # them once the caller resolves the failure (e.g. raises
        # max_capacity). A batch whose submit() raised is NOT requeued —
        # submit appends to the in-flight deque before collecting older
        # results, so the failure came from a downstream batch and this one
        # will still materialize on the next flush.
        batches = self.batcher.drain(force=force)
        for idx, mb in enumerate(batches):
            try:
                if self.index_manager is not None:
                    if self.index_manager.maybe_grow(incoming=mb.n_docs):
                        self.metrics.inc("index_grow_events")
                    self.index_manager.note_dispatched(mb.n_docs)
            except Exception:
                for later in reversed(batches[idx:]):
                    self.batcher.requeue(later)
                raise
            try:
                self.executor.submit(mb)
            except Exception:
                for later in reversed(batches[idx + 1:]):
                    self.batcher.requeue(later)
                raise
            self.metrics.inc("batches_dispatched")

    def poll(self) -> None:
        """Give the batching clock a chance to emit an overdue partial
        batch (callers with sparse traffic invoke this periodically)."""
        self._pump()

    def flush(self) -> None:
        """Force everything pending through and block until materialized
        (including any in-flight async snapshot write)."""
        self._pump(force=True)
        self.executor.drain()
        if self.index_manager is not None:
            self.index_manager.wait_snapshots()

    # ------------------------------------------------------------ results
    def _record_outcome(self, out: BatchOutcome) -> None:
        mb = out.batch
        self.metrics.observe("batch_ms", out.wall_s * 1e3)
        if out.stage_times:      # sampled Fig. 7 breakdown (stage_timer_every)
            for key, secs in out.stage_times.items():
                self.metrics.observe(f"{key}_ms", secs * 1e3)
        self.metrics.inc("docs_out", mb.n_docs)
        best = out.sims.argmax(axis=-1)
        rows = np.arange(len(best))
        nbr_ids = out.ids[rows, best]
        nbr_sims = out.sims[rows, best]
        exact = self.pipeline.exact
        if exact is not None:
            # register admitted docs' content hashes under their doc id so
            # future verbatim replays short-circuit at submit (and evicting
            # the doc can discard exactly its entry)
            for i in np.flatnonzero(mb.valid):
                did = int(mb.doc_ids[i])
                h = self._pending_hash.pop(did, None)
                if h is not None and out.keep[i]:
                    exact.add(h, ref=did)
        for i in np.flatnonzero(mb.valid):
            if out.keep[i]:
                reason = "admitted"
            elif not out.keep_in_batch[i]:
                reason = "batch_dup"
            else:
                reason = "index_dup"
            self.metrics.inc(reason)
            if self.cfg.record_verdicts:
                self._verdicts[int(mb.doc_ids[i])] = DocVerdict(
                    doc_id=int(mb.doc_ids[i]),
                    admitted=bool(out.keep[i]),
                    reason=reason,
                    neighbor_id=int(nbr_ids[i]),
                    similarity=float(nbr_sims[i]),
                )
        if self.index_manager is not None:
            self.index_manager.after_batch()
        if self.lifecycle is not None:
            n = self.lifecycle.after_batch()
            if n:
                self.metrics.inc("docs_deleted", n)
        for hook in self.outcome_hooks:
            hook(out)

    def verdict_ready(self, doc_id: int) -> bool:
        """True iff the doc's verdict is already in the store (requires
        record_verdicts; verdicts leave the store when results() pops)."""
        return doc_id in self._verdicts

    def results(self, ticket: Ticket) -> list[DocVerdict]:
        """Per-doc verdicts for a ticket, flushing if still in flight.
        Verdicts are handed out once (popped from the store)."""
        if not self.cfg.record_verdicts:
            raise RuntimeError("record_verdicts=False: this service only "
                               "exposes aggregate stats()")
        if any(i not in self._verdicts for i in range(*ticket)):
            self.flush()
        return [self._verdicts.pop(i) for i in range(*ticket)]

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        backend_stats = self.pipeline.backend.stats()
        # every built-in backend reports its admitted count; reuse it so a
        # stats poll pays at most one host sync
        count = backend_stats.get("count", self.pipeline.inserted)
        snap["index"] = {
            "backend": self.pipeline.backend.name,
            "count": count,
            "capacity": self.pipeline.capacity,
            "occupancy": count / max(self.pipeline.capacity, 1),
            "grow_events": (self.index_manager.grow_events
                            if self.index_manager else 0),
            "snapshots": (self.index_manager.snapshots_taken
                          if self.index_manager else 0),
            "n_deleted": self.pipeline.deleted,
            "dead_fraction": self.pipeline.dead_fraction,
            "t_compact": (self.lifecycle.t_compact_total
                          if self.lifecycle else 0.0),
            "backend_stats": backend_stats,
        }
        if self.pipeline.exact is not None:
            snap["index"]["exact_hits"] = self.pipeline.exact.hits
            snap["index"]["exact_entries"] = len(self.pipeline.exact)
        if self.lifecycle is not None:
            snap["lifecycle"] = self.lifecycle.stats()
        snap["batching"] = {
            "compiled_shapes": sorted(self.batcher.emitted_shapes),
            "truncated_docs": self.batcher.truncated,
            "pending_docs": self.batcher.pending,
            "inflight_batches": self.executor.inflight,
            "inflight_docs": self.executor.inflight_docs,
            "rejected_docs": self.metrics.counters.get("docs_rejected", 0)
            + self.batcher.rejected,
            "compiled_programs": program_cache_sizes(),
        }
        return snap
