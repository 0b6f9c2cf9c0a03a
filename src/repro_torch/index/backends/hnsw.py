"""FOLD's bitmap-HNSW backend and the FAISS (Jaccard) / FAISS (Hamming)
baseline behind the `repro_torch.index` protocol (port of `_HNSWLifecycle`,
`HNSWBitmapBackend` and `RawHNSWBackend` from
`repro/index/backends/hnsw.py`).

Step ② scores the batch with the bitmap-Jaccard kernel (K2, or K3 under
`cached=False`); steps ③ and ⑤ run core/hnsw.py's tensor programs on the
backend's device. The lifecycle covers capacity (growth, the sync-free
overflow guard), deletion (tombstones, a host free list of reclaimed
slots, online compaction), slot logging for `repro_torch.lifecycle`, and
snapshots in the reference's checkpoint layout, so a snapshot written by
either package restores into the other.

`verify_minhash` keeps the admitted docs' raw MinHash lanes in a store on
the backend's device and rescores the k retrieved candidates by exact lane
agreement inside `search` (sims then in MinHash space, `tau_index =
cfg.tau`).

`hnsw_raw` runs the same index machinery over the raw (H,) MinHash lanes
(`pcs` all zero), scored by core/hnsw.py's raw metrics; its step ② is the
plain pairwise matrix of the same metric, as in the reference (which
routes neither metric through a kernel there).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import spans
from repro_torch.analysis.programs import (ProgramBudget, ProgramSpec,
                                           register_programs)
from repro_torch.core.bitmap import pairwise_hamming, pairwise_minhash_jaccard
from repro_torch.core.dedup import FoldConfig, batch_jaccard, bitmap_tau
from repro_torch.core.hnsw import (HNSWConfig, HNSWState, hnsw_compact,
                                   hnsw_delete, hnsw_grow, hnsw_init,
                                   hnsw_insert_batch, hnsw_search,
                                   sample_levels, state_from_numpy,
                                   state_to_numpy)
from repro_torch.device import resolve_device
from repro_torch.index.pipeline import host
from repro_torch.index.protocol import BATCH_FIRST, DedupBackend, SigBatch, SigSpec
from repro_torch.index.registry import register

__all__ = ["HNSWBitmapBackend", "RawHNSWBackend"]


def _lane_fraction_f64(eq: torch.Tensor) -> torch.Tensor:
    """Fraction of equal lanes rounded as the reference's exact-verify
    rescoring rounds it: numpy's float64 mean, cast to f32. The division
    is by a tensor, so it stays an IEEE division on every device."""
    H = torch.tensor(float(eq.shape[-1]), dtype=torch.float64,
                     device=eq.device)
    return (eq.sum(-1).to(torch.float64) / H).to(torch.float32)


class _HNSWLifecycle(DedupBackend):
    """Capacity lifecycle, overflow refusal and deletion (tombstones,
    free-slot reuse, online compaction) shared by HNSW backends.

    Subclasses provide `cfg`, `hnsw_cfg`, `state`, `device` and a
    `_batches` level-seed counter; the hooks cover side containers that
    must track capacity (the bitmap backend's exact-verify sig store)."""

    cfg: FoldConfig
    hnsw_cfg: HNSWConfig
    state: HNSWState
    device: torch.device
    _batches: int

    # sync-free occupancy upper bound: the true count lives on the device,
    # so the host syncs only when the bound says a batch might not fit
    _known_count: int = 0
    _dispatched_bound: int = 0

    supports_growth = True
    supports_snapshots = True
    supports_deletion = True
    track_slots = False

    # deletion state (the protocol's DELETION CONTRACT)
    _n_deleted = 0        # cumulative successful deletes
    _n_dead = 0           # tombstones awaiting compact (host-exact)
    _t_compact = 0.0      # cumulative compact() wall seconds
    _free: list | None = None      # reclaimed slot ids (host free list)
    _count_hw: int | None = None   # host mirror of state.count (slot log)

    # -- overflow refusal ----------------------------------------------------
    def _guard_capacity(self, keep, offered: int = 0) -> None:
        """Refuse an insert that could overflow the fixed-capacity index:
        a verdict must never claim admission for a dropped row.

        The sync-free bound charges the kept-row count when the mask is
        host-resident (numpy), and the batch size B for a tensor mask
        until a (rare) sync re-anchors the bound. `offered` reclaimed free
        slots take rows without fresh capacity, so only max(0, charge -
        offered) counts against the high-water bound (dead slots hold
        capacity until compact())."""
        cap = self.hnsw_cfg.capacity
        if isinstance(keep, np.ndarray):
            charge = int(keep.sum())
        else:
            charge = int(keep.shape[0])
        fresh = max(0, charge - offered)
        if self._known_count + self._dispatched_bound + fresh <= cap:
            self._dispatched_bound += fresh
            return
        self._known_count = spans.to_int(self.state.count)  # foldlint: sync-ok(rare re-anchor: only when the sync-free bound says the batch might not fit)
        self._dispatched_bound = 0
        n_keep = spans.to_int(torch.as_tensor(keep).sum())  # foldlint: sync-ok(already syncing to re-anchor; exact kept count is free here)
        fresh = max(0, n_keep - offered)
        if self._known_count + fresh > cap:
            raise RuntimeError(
                f"HNSW index full: {self._known_count} of {cap} slots used "
                f"and the batch admits {fresh} beyond the free list; call "
                f"grow() — or compact() if tombstones are pending — before "
                f"inserting — refusing to silently drop admitted docs")
        self._dispatched_bound = fresh

    def _seeds_from(self, search_ids):
        """Step-③ neighbor ids -> batched-insert discovery seeds (only for
        the batched path with cfg.reuse_search)."""
        if (search_ids is None or not self.hnsw_cfg.batched_insert
                or not getattr(self.cfg, "reuse_search", True)):
            return None
        return search_ids.to(torch.int32)

    @property
    def inserted(self) -> int:
        """LIVE document count: admitted - deleted (a host sync on one
        reduction)."""
        return spans.to_int(((self.state.node_level >= 0) & ~self.state.dead).sum())  # foldlint: sync-ok(occupancy poll; one reduction)

    # -- deletion / compaction ----------------------------------------------
    @property
    def deleted(self) -> int:
        return self._n_deleted

    @property
    def dead_fraction(self) -> float:
        return self._n_dead / max(self.hnsw_cfg.capacity, 1)

    def delete(self, ids) -> int:  # foldlint: cold-path
        """Tombstone slot ids (idempotent); slots become reusable only
        after compact()."""
        ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
        ids = ids[(ids >= 0) & (ids < self.hnsw_cfg.capacity)]
        if len(ids) == 0:
            return 0
        # pad to the next power of two so that the delete program's
        # signatures (program_cache_sizes) grow as the reference's do
        D = 1 << int(len(ids) - 1).bit_length() if len(ids) > 1 else 1
        pad = np.full(D, -1, np.int32)
        pad[:len(ids)] = ids
        self.state, n_dev = hnsw_delete(
            self.hnsw_cfg, self.state, spans.upload(pad, self.device))
        n = spans.to_int(n_dev)
        self._n_deleted += n
        self._n_dead += n
        return n

    def _rederive_free(self) -> int:  # foldlint: cold-path
        """Host free list = every unlinked slot below the high-water mark,
        re-derived from the device state. Returns the count mark."""
        count = spans.to_int(self.state.count)
        node_level = spans.to_host(self.state.node_level[:count])
        self._free = [int(i) for i in np.flatnonzero(node_level < 0)]
        return count

    def compact(self) -> dict:  # foldlint: cold-path
        """Repair adjacency around tombstones, unlink them, and re-derive
        the host free list (host sync: callers schedule it off the hot
        path). Under an open record of `repro_torch.spans`, the free list's
        re-derivation is the span `compact.free` (`hnsw_compact` holds
        `compact.repair` and `compact.unlink`)."""
        t0 = time.perf_counter()
        self.state, n_dev = hnsw_compact(self.hnsw_cfg, self.state)
        reclaimed = spans.to_int(n_dev)
        with spans.span("compact.free"):
            count = self._rederive_free()
        self._n_dead = 0
        self._count_hw = count
        self._known_count = count               # re-anchor overflow guard
        self._dispatched_bound = 0
        self._t_compact += time.perf_counter() - t0
        return {"reclaimed": reclaimed, "free": len(self._free or []),
                "t_compact": self._t_compact}

    def _prepare_slots(self, keep, B: int):
        """Overflow guard, then pop up to B reclaimed slots for the device
        to consume before fresh capacity (a refusal leaks no free slot).
        Popped slots no kept row used are orphaned until the next
        compact() re-derives the free list. Returns (free_dev (B,) int32
        | None, free_host list)."""
        free = self._free if self._free else []
        offered = min(B, len(free))
        self._guard_capacity(keep, offered=offered)
        if offered == 0:
            return None, []
        take, self._free = free[:offered], free[offered:]
        pad = np.full(B, -1, np.int32)
        pad[:offered] = take
        return spans.upload(pad, self.device), take

    def _log_slots(self, keep, free_host):
        """Host mirror of the device slot assignment: the j-th kept row
        lands in free_host[j] while frees last, then in consecutive fresh
        slots from the pre-insert high-water count. Returns (order, slots)."""
        order = np.flatnonzero(host(keep))  # foldlint: sync-ok(slot logging is opt-in; lifecycle needs the host mask)
        if self._count_hw is None:
            self._count_hw = spans.to_int(self.state.count)  # foldlint: sync-ok(one-time count-mirror seed; advanced host-side after)
        t = min(len(order), len(free_host))
        slots = np.concatenate([
            np.asarray(free_host[:t], np.int64),  # foldlint: sync-ok(host free-list bookkeeping)
            self._count_hw + np.arange(len(order) - t, dtype=np.int64),
        ]).astype(np.int32)
        self._count_hw += len(order) - t
        return order, slots

    def _record_insert(self, sig, keep, free_host) -> None:
        """Slot-dependent bookkeeping for one insert: the exact-verify sig
        store scatter and the track_slots log, and the count of admitted
        rows placed in reclaimed slots (`reused`, on the open span of
        `repro_torch.spans`); sync-free when neither is active."""
        sig_store = getattr(self, "_sig_store", None)
        if sig_store is None and not self.track_slots:
            self._count_hw = None       # host count mirror goes stale
            return
        order, slots = self._log_slots(keep, free_host)
        if sig_store is not None and len(order):
            dev_slots = spans.upload(slots.astype(np.int64), self.device)
            rows = spans.upload(order, self.device)
            sig_store[dev_slots] = sig.sigs[rows]
        if self.track_slots:
            q = list(getattr(self, "_slots_q", []))
            q.append(slots)
            self._slots_q = q
        # the admitted rows placed in reclaimed slots
        spans.add(reused=min(len(order), len(free_host)))

    # -- hooks ---------------------------------------------------------------
    def _after_grow(self, new_capacity: int) -> None:
        pass

    def _reset_containers(self, capacity: int) -> None:
        """Rebuild side containers at a snapshot's capacity."""

    def _extra_tree(self) -> dict:
        """Extra checkpoint leaves beyond {state, batches}."""
        return {}

    def _take_extra(self, got: dict) -> None:
        pass

    # -- lifecycle -----------------------------------------------------------
    def grow(self, new_capacity: int) -> None:  # foldlint: cold-path
        """Re-pad the index to a larger capacity (graph kept exactly)."""
        self.hnsw_cfg, self.state = hnsw_grow(self.hnsw_cfg, self.state,
                                              new_capacity)
        self.cfg = dataclasses.replace(self.cfg, capacity=new_capacity)
        self._after_grow(new_capacity)
        self._known_count = int(self.state.count)
        self._dispatched_bound = 0

    def _tree(self) -> dict:
        """The checkpoint tree, leaf for leaf the reference's: `state` in
        HNSWState field order with uint32 vectors, `batches` an int32
        scalar, plus the hooks' leaves."""
        tree = {"state": HNSWState(**state_to_numpy(self.state)),
                "batches": np.int32(self._batches)}
        tree.update(self._extra_tree())
        return tree

    def save(self, ckpt_dir: str, step: int, async_write: bool = False):  # foldlint: cold-path
        """Checkpoint the index in the reference's layout; async_write
        snapshots to host now and writes in a background thread
        (checkpoint.wait_pending orders writes)."""
        from repro_torch.train import checkpoint as ckpt
        writer = ckpt.save_async if async_write else ckpt.save
        writer(ckpt_dir, step, self._tree(),
               extra={"capacity": self.hnsw_cfg.capacity})

    def restore(self, ckpt_dir: str, step: int | None = None) -> int:  # foldlint: cold-path
        from repro_torch.train import checkpoint as ckpt
        step = ckpt.latest_step(ckpt_dir) if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint found in {ckpt_dir!r}")
        meta = ckpt.manifest(ckpt_dir, step)
        cap = int(meta.get("capacity", self.hnsw_cfg.capacity))
        target = max(cap, self.hnsw_cfg.capacity)
        if cap != self.hnsw_cfg.capacity:
            # adopt the snapshot's capacity, grown back to the configured
            # size after the load
            self.hnsw_cfg = self.hnsw_cfg._replace(capacity=cap)
            self.cfg = dataclasses.replace(self.cfg, capacity=cap)
            self._reset_containers(cap)
        like = {"state": HNSWState(*[0] * len(HNSWState._fields)),
                "batches": 0}
        like.update({k: 0 for k in self._extra_tree()})
        got = ckpt.restore(ckpt_dir, step, like)
        self.state = state_from_numpy(got["state"]._asdict(), self.device)
        self._batches = int(got["batches"])
        self._take_extra(got)
        if target > cap:
            self.grow(target)
        # host mirrors re-derived from the restored arrays: tombstones and
        # free slots live in HNSWState; cumulative `deleted` restarts at
        # the restored tombstone count
        count = self._rederive_free()
        self._n_dead = int(self.state.dead.sum())
        self._n_deleted = self._n_dead
        self._count_hw = count
        self._slots_q = []
        self._known_count = count
        self._dispatched_bound = 0
        return step


class HNSWBitmapBackend(_HNSWLifecycle):
    """FOLD's index: HNSW top-k over one-hot-folded bitmap signatures,
    with the optional exact-verify sig store (cfg.verify_minhash)."""

    name = "hnsw"
    order = BATCH_FIRST

    def __init__(self, cfg: FoldConfig,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.hnsw_cfg = cfg.hnsw()
        self.state: HNSWState = hnsw_init(self.hnsw_cfg, self.device)
        self.tau_b = bitmap_tau(cfg)
        self._sig_store = (self._empty_store(cfg.capacity)
                           if cfg.verify_minhash else None)
        self._batches = 0     # level-seed basis: monotone, sync-free

    def _empty_store(self, rows: int) -> torch.Tensor:
        return torch.zeros((rows, self.cfg.num_hashes), dtype=torch.int32,
                           device=self.device)

    @property
    def sig_spec(self) -> SigSpec:
        return SigSpec(num_hashes=self.cfg.num_hashes,
                       shingle_n=self.cfg.shingle_n, T=self.cfg.T,
                       seed=self.cfg.seed, use_kernel=self.cfg.use_kernel,
                       needs=frozenset({"sigs", "bitmaps"}))

    @property
    def tau_batch(self) -> float:
        return self.tau_b

    @property
    def tau_index(self) -> float:
        # exact-verify rescoring reports sims in MinHash space
        return self.cfg.tau if self.cfg.verify_minhash else self.tau_b

    @property
    def capacity(self) -> int:
        return self.hnsw_cfg.capacity

    def batch_sim(self, sig: SigBatch):
        return batch_jaccard(sig.bitmaps, sig.pcs, self.cfg.use_kernel,
                             self.cfg.cached)

    def search(self, sig: SigBatch):
        ids, sims = hnsw_search(self.hnsw_cfg, self.state, sig.bitmaps,
                                k=self.cfg.k)
        if self.cfg.verify_minhash:
            # rescore the k candidates by exact lane agreement
            cand = self._sig_store[torch.clamp(ids, min=0).to(torch.int64)]
            lane = _lane_fraction_f64(sig.sigs[:, None, :] == cand)
            sims = torch.where(ids >= 0, lane, torch.full_like(lane, -np.inf))
        return ids, sims

    def insert(self, sig: SigBatch, keep, search_ids=None):
        B = sig.bitmaps.shape[0]
        levels = torch.from_numpy(sample_levels(
            B, self.hnsw_cfg, seed=self._batches + self.cfg.seed + 1))
        self._batches += 1
        # refuse BEFORE any state mutation: past the guard every kept row
        # has a slot, so the sig-store scatter stays in lockstep
        free_dev, free_host = self._prepare_slots(keep, B)
        self._record_insert(sig, keep, free_host)
        self.state, _ = hnsw_insert_batch(
            self.hnsw_cfg, self.state, sig.bitmaps, sig.pcs,
            spans.upload(levels, self.device),
            spans.to_device(keep, self.device),
            seed_ids=self._seeds_from(search_ids), free_slots=free_dev)
        return self.state.count     # timing handle

    # -- hooks: the exact-verify sig store tracks capacity --------------------
    def _after_grow(self, new_capacity: int) -> None:
        store = self._sig_store
        if store is not None and store.shape[0] < new_capacity:
            self._sig_store = torch.cat(
                [store, self._empty_store(new_capacity - store.shape[0])])

    def _reset_containers(self, capacity: int) -> None:
        if self._sig_store is not None:
            self._sig_store = self._empty_store(capacity)

    def _extra_tree(self) -> dict:
        if self._sig_store is None:
            return {}
        return {"sig_store": self._sig_store.cpu().numpy().view(np.uint32)}

    def _take_extra(self, got: dict) -> None:  # foldlint: cold-path (restore hook)
        if self._sig_store is not None:
            store = np.ascontiguousarray(got["sig_store"].astype(np.uint32))
            self._sig_store = torch.from_numpy(store.view(np.int32)).to(
                self.device)

    def stats_schema(self) -> tuple[str, ...]:
        return ("count", "capacity", "batches", "deleted", "dead", "free")

    def stats(self) -> dict:
        return {"count": self.inserted, "capacity": self.capacity,
                "batches": self._batches, "deleted": self._n_deleted,
                "dead": self._n_dead, "free": len(self._free or [])}


class RawHNSWBackend(_HNSWLifecycle):
    """FAISS (Jaccard) / FAISS (Hamming): FOLD's index machinery over raw
    (H,) MinHash signatures scored by
      - minhash_jaccard: fraction of equal lanes (tie-heavy; low recall), or
      - hamming: bit agreement across the packed lanes (fast; misaligned).
    tau applies directly in the metric's own space. As in the reference,
    FoldConfig.select_heuristic does not reach this index."""

    name = "hnsw_raw"
    order = BATCH_FIRST

    def __init__(self, cfg: FoldConfig, metric: str = "minhash_jaccard",
                 device: str | torch.device | None = None):
        if metric not in ("minhash_jaccard", "hamming"):
            raise ValueError(f"unknown raw metric {metric!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.metric = metric
        self.hnsw_cfg = HNSWConfig(
            capacity=cfg.capacity, words=cfg.num_hashes, M=cfg.M, M0=cfg.M0,
            ef_construction=cfg.ef_construction, ef_search=cfg.ef_search,
            max_level=cfg.max_level, metric=metric,
            query_chunk=cfg.query_chunk,
            batched_insert=cfg.batched_insert)
        self.state: HNSWState = hnsw_init(self.hnsw_cfg, self.device)
        self._batches = 0     # level-seed basis: monotone, sync-free

    @property
    def sig_spec(self) -> SigSpec:
        return SigSpec(num_hashes=self.cfg.num_hashes,
                       shingle_n=self.cfg.shingle_n, seed=self.cfg.seed,
                       use_kernel=self.cfg.use_kernel,
                       needs=frozenset({"sigs"}))

    @property
    def tau_batch(self) -> float:
        return self.cfg.tau

    @property
    def tau_index(self) -> float:
        return self.cfg.tau

    @property
    def capacity(self) -> int:
        return self.hnsw_cfg.capacity

    def batch_sim(self, sig: SigBatch):
        pair = (pairwise_minhash_jaccard if self.metric == "minhash_jaccard"
                else pairwise_hamming)
        return pair(sig.sigs, sig.sigs)

    def search(self, sig: SigBatch):
        return hnsw_search(self.hnsw_cfg, self.state, sig.sigs, k=self.cfg.k)

    def insert(self, sig: SigBatch, keep, search_ids=None):
        B = sig.sigs.shape[0]
        levels = torch.from_numpy(sample_levels(
            B, self.hnsw_cfg, seed=self._batches + self.cfg.seed + 1))
        self._batches += 1
        free_dev, free_host = self._prepare_slots(keep, B)
        self._record_insert(sig, keep, free_host)
        pcs = torch.zeros(B, dtype=torch.int32, device=self.device)
        self.state, _ = hnsw_insert_batch(
            self.hnsw_cfg, self.state, sig.sigs, pcs,
            spans.upload(levels, self.device),
            spans.to_device(keep, self.device),
            seed_ids=self._seeds_from(search_ids), free_slots=free_dev)
        return self.state.count     # timing handle

    def stats_schema(self) -> tuple[str, ...]:
        return ("count", "capacity", "metric", "deleted", "dead", "free")

    def stats(self) -> dict:
        return {"count": self.inserted, "capacity": self.capacity,
                "metric": self.metric, "deleted": self._n_deleted,
                "dead": self._n_dead, "free": len(self._free or [])}


# -- analyzable program specs (repro_torch.analysis) -------------------------
# The reference's pinned spec geometry (independent of FoldConfig defaults so
# a default bump does not silently re-baseline the goldens), run on the
# seeded filled index of repro_torch.analysis.inputs.
_SPEC_CAP = 8192      # index capacity (slots)
_SPEC_K = 4
_SPEC_DELETE = 64     # ids per delete: every 16th filled slot
_STATE_LEAVES = len(HNSWState._fields)


def _delete_ids(ix, device) -> torch.Tensor:
    step = max(ix.n_docs // _SPEC_DELETE, 1)
    return torch.arange(0, step * _SPEC_DELETE, step, dtype=torch.int32,
                        device=device)


def _search_spec(name: str, metric: str, syncs: tuple[int, int],
                 temp_bytes: int) -> ProgramSpec:
    def make(device):
        from repro_torch.analysis.inputs import spec_index
        ix = spec_index(_SPEC_CAP, metric).on(device)
        return hnsw_search, (ix.cfg, ix.state, ix.queries), {"k": _SPEC_K}
    return ProgramSpec(
        name=name, make=make, alias_expect=0,  # foldlint: disable=F141 (the port's ProgramSpec: alias_expect)
        budget=ProgramBudget(
            temp_bytes=temp_bytes, gather=220, host_syncs=syncs[0],
            card_syncs=syncs[1],
            note="temp ceiling raised from the reference's 24,000,000 to "
                 "the card's measurement: each beam step's (Q, F*M0, W) "
                 "gather of candidate rows and its int64 popcount "
                 "temporaries are materialized, where XLA fuses them"))


@register_programs("index.backends.hnsw")
def _hnsw_programs() -> list[ProgramSpec]:
    def make_insert(device):
        from repro_torch.analysis.inputs import spec_index
        ix = spec_index(_SPEC_CAP).on(device)
        free = torch.full_like(ix.pcs, -1)
        return hnsw_insert_batch, (ix.cfg, ix.state, ix.queries, ix.pcs,
                                   ix.levels, ix.keep, ix.seed_ids, free), {}

    def make_delete(device):
        from repro_torch.analysis.inputs import spec_index
        ix = spec_index(_SPEC_CAP).on(device)
        return hnsw_delete, (ix.cfg, ix.state, _delete_ids(ix, device)), {}

    def make_compact(device):
        # compact after the delete spec's tombstones: real repair work
        from repro_torch.analysis.inputs import spec_index
        ix = spec_index(_SPEC_CAP).on(device)
        ix.state.dead[_delete_ids(ix, device).to(torch.int64)] = True
        return hnsw_compact, (ix.cfg, ix.state), {}

    return [
        _search_spec("hnsw/search", "bitmap_jaccard", (29, 29), 80_000_000),
        _search_spec("hnsw_raw/search", "minhash_jaccard", (25, 25),
                     26_000_000),
        ProgramSpec(
            name="hnsw/insert", make=make_insert,
            alias_expect=_STATE_LEAVES - 3,  # foldlint: disable=F141 (the port's ProgramSpec: alias_expect)
            budget=ProgramBudget(
                temp_bytes=80_000_000, scatter=200, host_syncs=52,
                card_syncs=55,
                note="two-phase batched insert (discover + commit), in "
                     "place; the commit makes 2 card syncs (its arrays "
                     "down, its plan up) and one K5 launch. The returned "
                     "state shares vectors, pb, "
                     "neighbors, node_level and dead; count, entry and "
                     "top_level are re-made 0-d tensors (12 bytes at any "
                     "capacity; the reference donates all 8). Ceiling "
                     "over the reference's: temp 80,000,000 (64,000,000; "
                     "the search's materialized temporaries, 77,252,096 "
                     "on the card)")),
        ProgramSpec(
            name="hnsw/delete", make=make_delete,
            alias_expect=_STATE_LEAVES,  # foldlint: disable=F141 (the port's ProgramSpec: alias_expect)
            budget=ProgramBudget(temp_bytes=8_000_000, host_syncs=1,
                                 card_syncs=2)),
        ProgramSpec(
            name="hnsw/compact", make=make_compact,
            alias_expect=_STATE_LEAVES - 3,  # foldlint: disable=F141 (the port's ProgramSpec: alias_expect)
            budget=ProgramBudget(
                temp_bytes=1_250_000_000, host_syncs=7, card_syncs=7,
                note="adjacency repair runs off the hot path (lifecycle "
                     "watermark), in place: entry, top_level and count are "
                     "re-derived 0-d tensors (the reference's 6 of 8 keep "
                     "count). temp ceiling 1,250,000,000 over the "
                     "reference's 800,000,000: the repair pool's (chunk, "
                     "K, W) rows and int64 popcounts, 1,214,590,976 on "
                     "the card")),
    ]


@register("hnsw")
def _make_hnsw(cfg: FoldConfig | None = None,
               device: str | torch.device | None = None,
               **opts) -> HNSWBitmapBackend:
    if opts:
        cfg = dataclasses.replace(cfg or FoldConfig(), **opts)
    return HNSWBitmapBackend(cfg or FoldConfig(), device=device)


@register("hnsw_raw")
def _make_hnsw_raw(cfg: FoldConfig | None = None,
                   metric: str = "minhash_jaccard",
                   device: str | torch.device | None = None,
                   **opts) -> RawHNSWBackend:
    if opts:    # FoldConfig overrides (e.g. query_chunk), like "hnsw"
        cfg = dataclasses.replace(cfg or FoldConfig(), **opts)
    return RawHNSWBackend(cfg or FoldConfig(), metric=metric, device=device)
