"""The pluggable dedup-backend API (port of `repro/index/protocol.py`).

The admission loop is ① signature generation → ② in-batch cleanup →
③ index search → ④ threshold filter → ⑤ admit uniques; steps ①②④ are
shared (`index.pipeline.DedupPipeline`), a backend supplies ③ and ⑤ over
one signature representation plus the capacity lifecycle. Signatures
are torch tensors on the backend's device; a host-side backend (`dpk`,
`flat_lsh`, `prefix_filter`, host stores by design, as in the reference)
answers `search` with numpy arrays.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Protocol, runtime_checkable

__all__ = ["SigSpec", "SigBatch", "StepResult", "DedupBackend",
           "BATCH_FIRST", "INDEX_FIRST"]

# Admission-loop orderings (see DedupPipeline.dedup_step):
#   BATCH_FIRST — FOLD and every sketch baseline: in-batch greedy-leader
#     sweep first, then the index filter over the searches.
#   INDEX_FIRST — join-style semantics (prefix filter): corpus duplicates
#     are excluded *before* the sweep, so an index duplicate never
#     suppresses a later in-batch near-duplicate.
BATCH_FIRST = "batch_first"
INDEX_FIRST = "index_first"


class SigSpec(NamedTuple):
    """What step ① must produce for a backend. needs ⊆ {"sigs", "bitmaps",
    "shingles"}: (B, H) MinHash lanes, (B, T//32) packed bitmaps (+
    popcounts), (B, S) raw shingle hashes."""
    num_hashes: int = 112
    shingle_n: int = 5
    T: int = 4096
    seed: int = 0
    use_kernel: bool = True
    needs: frozenset = frozenset({"sigs"})


class SigBatch(NamedTuple):
    """Step-① output for one batch; fields not asked for are None."""
    sigs: Any = None
    bitmaps: Any = None
    pcs: Any = None
    shingles: Any = None

    @property
    def n_docs(self) -> int:
        for a in self:
            if a is not None:
                return a.shape[0]
        raise ValueError("empty SigBatch")


class StepResult(NamedTuple):
    """Outcome of one dedup_step: tensors on the backend's device, or
    numpy arrays for a host-side backend (the side its `search` answers
    on).

    keep (B,) bool admit mask; keep_in_batch (B,) bool step-② survivors;
    ids (B, k) int32 neighbor ids (-1 = none); sims (B, k) f32."""
    keep: Any
    keep_in_batch: Any
    ids: Any
    sims: Any


@runtime_checkable
class DedupBackend(Protocol):
    """Steps ③+⑤ plus the index lifecycle, over one SigBatch
    representation (see the reference protocol for the full contract).

      name, order, sig_spec, tau_batch, tau_index, capacity, inserted
      device                          the torch device of its signatures
                                      (and of its index, unless host-side)
      batch_sim(sig) -> (B, B)        step-② similarity matrix
      search(sig) -> (ids, sims)      step ③ against the pre-batch corpus
                                      (tensors, or numpy on the host)
      insert(sig, keep, search_ids=None)
                                      step ⑤; keep lives where search's
                                      results do; search_ids are advisory
                                      discovery seeds, passed only to an
                                      insert that declares them.
                                      OVERFLOW CONTRACT:
                                      never silently drop a keep-row —
                                      refuse the batch instead.
      grow(new_capacity)              re-allocate, graph kept exactly
      save(dir, step, async_write=False) / restore(dir, step=None) -> step
      stats_schema() / stats()

    Optional hooks (DedupPipeline checks hasattr):

      fused_step(sig, valid=None) -> StepResult
          Replace steps ②-⑤ with one call, for backends whose whole step
          cannot be split (the sharded HNSW step: every shard's search
          before any shard's insert). The pipeline does the Fig. 7 timing
          around the call (recorded under t_fused_step); fused backends
          never see the timers dict. A fused backend must STILL implement
          `search`: the read-only query path (DedupPipeline.query, the
          cluster read replicas) calls it directly; only batch_sim/insert
          may refuse with a use-fused_step NotImplementedError.
      in_batch_keep(sig, eligible) -> (keep, batch_hit)
          Replace the sim-matrix greedy sweep with a backend-native one
          (e.g. lazy host-side set comparisons). Only consulted for
          INDEX_FIRST backends, with eligible = ~index_dup ∧ valid (numpy).

    Capability flags (class attributes with defaults):

      supports_growth / supports_snapshots  (default True)
      supports_deletion                     (default False): the backend
          implements the DELETION CONTRACT below
      track_slots                           (default False): every insert
          logs the slot ids it assigned to admitted rows, in admission
          order, for pop_slot_log() (repro_torch.lifecycle sets it)

    DELETION CONTRACT (supports_deletion backends):

      delete(ids) -> int      remove slot ids from future verdicts; unknown,
                              out-of-range, negative, duplicate and
                              already-deleted ids are ignored; returns the
                              number newly deleted. A resubmitted copy of a
                              deleted doc must be admitted again, and
                              `inserted` counts live docs only.
      deleted: int            cumulative deletes (default 0)
      dead_fraction: float    deleted-but-unreclaimed share of capacity
                              (default 0.0); host-cheap, no device sync
      compact() -> dict       reclaim tombstones (default {"reclaimed": 0})
      pop_slot_log(n=None)    drain up to n pending per-insert slot logs
      pending_slot_log()      the pending slot logs, oldest first, left
                              in place (a lifecycle ledger's snapshot)

    save/restore round-trip deletion state: tombstones and free slots
    survive a snapshot.
    """
    name: str
    order: str

    supports_growth: bool = True
    supports_snapshots: bool = True
    supports_deletion: bool = False
    track_slots: bool = False

    @property
    def sig_spec(self) -> SigSpec: ...
    @property
    def tau_batch(self) -> float: ...
    @property
    def tau_index(self) -> float: ...
    @property
    def capacity(self) -> int: ...
    @property
    def inserted(self) -> int: ...

    def batch_sim(self, sig: SigBatch) -> Any: ...
    def search(self, sig: SigBatch) -> tuple[Any, Any]: ...
    def insert(self, sig: SigBatch, keep: Any,
               search_ids: Any | None = None) -> Any: ...
    def grow(self, new_capacity: int) -> None: ...
    def save(self, ckpt_dir: str, step: int,
             async_write: bool = False) -> None: ...
    def restore(self, ckpt_dir: str, step: int | None = None) -> int: ...
    def stats_schema(self) -> tuple[str, ...]: ...
    def stats(self) -> dict: ...

    # ---- deletion contract defaults
    @property
    def deleted(self) -> int:
        return 0

    @property
    def dead_fraction(self) -> float:
        return 0.0

    def delete(self, ids: Any) -> int:
        raise NotImplementedError(
            f"backend {getattr(self, 'name', type(self).__name__)!r} does "
            f"not support deletion (supports_deletion=False)")

    def compact(self) -> dict:
        return {"reclaimed": 0}

    def pop_slot_log(self, n: int | None = None) -> list:
        """Drain up to n (None = all) per-insert slot logs, oldest first."""
        q = getattr(self, "_slots_q", None)
        if not q:
            return []
        n = len(q) if n is None else min(n, len(q))
        out, rest = list(q[:n]), list(q[n:])
        setattr(self, "_slots_q", rest)
        return out

    def pending_slot_log(self) -> list:
        """The per-insert slot logs not yet drained, oldest first."""
        return list(getattr(self, "_slots_q", None) or [])
