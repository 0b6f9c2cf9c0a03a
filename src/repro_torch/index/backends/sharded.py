"""Index-sharded FOLD as a peer backend ("hnsw_sharded"; port of
`repro/index/backends/sharded.py`).

Each of `shards` independent HNSW sub-graphs owns 1/N of the admitted
corpus (capacity below is PER SHARD). The whole ②-⑤ step is one call into
core/sharded.py, so this backend implements the protocol's `fused_step`
hook instead of split batch_sim/search/insert, and the generic
DedupPipeline routes around its shared sweep. Batches are padded to a
multiple of nshards (extra rows valid=False), so the executor drives this
exactly like any other backend. Retrieved neighbor ids/sims are internal
to the fused step and surface as -1/-inf.

The shards live on ONE device (`device`; None means cuda), where the
reference lays one per mesh device; `axis` is kept only for the snapshot
manifest. `shards=None` means 1, as the reference's default on one device.

Full lifecycle peer of "hnsw" (growth, snapshots, deletion):

  * grow(new_total) re-pads every shard to ceil(new_total/nshards)
    per-shard slots (core.sharded.sharded_grow), so the serving layer's
    sync-free occupancy watermark works unchanged.
  * save/restore writes ONE snapshot directory in the reference's bytes:
    the stacked per-shard state arrays plus a shard-layout manifest
    {"capacity" (per shard), "shards", "axis"}. A snapshot taken at N
    shards restores at N' >= N (scale-out: the N sub-graphs land on the
    first N shards, the rest start empty) and REFUSES N' < N: per-shard
    HNSW graphs cannot be merged. A scale-out restore invalidates
    previously exported global slot ids (their encoding depends on N).
  * deletion routes by GLOBAL SLOT ID = local_slot * nshards + shard
    (stable under grow(), which changes only the per-shard capacity):
    delete() splits ids by `id % nshards` and tombstones each shard's
    rows; compact() repairs and unlinks per sub-graph and re-derives
    per-shard host free lists; the fused step offers each shard its own
    reclaimed slots ahead of fresh capacity.

Insertion uses the two-phase batched insert per shard
(`FoldConfig.batched_insert`), seeded with the ids that shard's own
search just retrieved (`FoldConfig.reuse_search`).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.analysis.programs import (ProgramBudget, ProgramSpec,
                                           register_programs)
from repro_torch.core.dedup import FoldConfig, bitmap_tau
from repro_torch.core.hnsw import HNSWState, sample_levels
from repro_torch.core.sharded import (make_sharded_compact,
                                      make_sharded_dedup_step,
                                      make_sharded_delete,
                                      make_sharded_search, sharded_grow,
                                      sharded_init, stack_states,
                                      unstack_states)
from repro_torch.device import resolve_device
from repro_torch.index.pipeline import host
from repro_torch.index.protocol import (BATCH_FIRST, DedupBackend, SigBatch,
                                        SigSpec, StepResult)
from repro_torch.index.registry import register

__all__ = ["ShardedDedupBackend"]


class ShardedDedupBackend(DedupBackend):
    name = "hnsw_sharded"
    order = BATCH_FIRST      # nominal; the fused step owns the ordering
    supports_growth = True
    supports_snapshots = True
    supports_deletion = True
    track_slots = False

    def __init__(self, cfg: FoldConfig, shards: int | None = None,
                 device: str | torch.device | None = None,
                 axis: str = "data"):
        n = 1 if shards is None else int(shards)
        if n < 1:
            raise ValueError(f"shards={n}: need at least one shard")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.axis = axis
        self.nshards = n
        self.hnsw_cfg = cfg.hnsw()
        self.states = sharded_init(self.hnsw_cfg, n, self.device)
        self._lower()
        self._batches = 0
        # sync-free per-shard occupancy bound: round-robin keeps shards
        # within one doc of each other, so the max per-shard high-water
        # count plus a conservative per-batch charge upper-bounds them all
        self._known_max = 0
        self._bound = 0
        # deletion state (the protocol's DELETION CONTRACT)
        self._n_deleted = 0        # cumulative successful deletes
        self._n_dead = 0           # live tombstones awaiting compact
        self._t_compact = 0.0
        self._free: list[list[int]] = [[] for _ in range(self.nshards)]
        self._count_hw: np.ndarray | None = None   # (nshards,) host mirror
        self._slots_q: list = []

    def _lower(self) -> None:
        """(Re)build the fused step and the delete/compact/search calls
        against the current per-shard capacity (at init, grow, restore)."""
        self._step = make_sharded_dedup_step(
            self.hnsw_cfg, self.nshards, tau=bitmap_tau(self.cfg),
            k=self.cfg.k, masked=True,
            reuse_search=getattr(self.cfg, "reuse_search", True),
            free_slots=True)
        self._delete = make_sharded_delete(self.hnsw_cfg)
        self._compact = make_sharded_compact(self.hnsw_cfg)
        self._search = make_sharded_search(self.hnsw_cfg, self.nshards,
                                           k=self.cfg.k)

    @property
    def sig_spec(self) -> SigSpec:
        return SigSpec(num_hashes=self.cfg.num_hashes,
                       shingle_n=self.cfg.shingle_n, T=self.cfg.T,
                       seed=self.cfg.seed, use_kernel=self.cfg.use_kernel,
                       needs=frozenset({"sigs", "bitmaps"}))

    @property
    def tau_batch(self) -> float:
        return bitmap_tau(self.cfg)

    @property
    def tau_index(self) -> float:
        return bitmap_tau(self.cfg)

    @property
    def capacity(self) -> int:
        return self.hnsw_cfg.capacity * self.nshards

    @property
    def inserted(self) -> int:
        """LIVE document count across all shards (a host sync on one
        reduction)."""
        live = sum(((st.node_level >= 0) & ~st.dead).sum()
                   for st in self.states)
        return int(live)  # foldlint: sync-ok(occupancy poll; one reduction)

    def _counts(self) -> np.ndarray:
        """Per-shard high-water counts, (nshards,) host int64 (a sync)."""
        return torch.stack([st.count for st in self.states]).cpu().numpy(
        ).astype(np.int64)

    # -- slot-id encoding ----------------------------------------------------
    # global slot id = local_slot * nshards + shard: stable under grow()
    # (which only changes the per-shard capacity, never nshards), dense in
    # [0, capacity), and decodable on the host without a device sync.
    def _decode_slots(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return ids % self.nshards, ids // self.nshards

    # -- overflow refusal ----------------------------------------------------
    def _guard_capacity(self, per_shard: int, offered_min: int) -> None:
        """Refuse a batch that could overflow ANY shard (sync-free bound).

        Round-robin assignment puts at most ceil(B/n) = per_shard docs on
        one shard; offered_min reclaimed slots are available on every
        shard, so only the difference charges fresh capacity against the
        max per-shard high-water mark. Near capacity one host sync reads
        the true max, then either refuses with a grow() hint or
        re-anchors."""
        cap = self.hnsw_cfg.capacity
        fresh = max(0, per_shard - offered_min)
        if self._known_max + self._bound + fresh <= cap:
            self._bound += fresh
            return
        self._known_max = int(self._counts().max())  # foldlint: sync-ok(rare re-anchor: only when the sync-free bound says the batch might not fit)
        self._bound = 0
        if self._known_max + fresh > cap:
            raise RuntimeError(
                f"sharded index full: a shard holds {self._known_max} of "
                f"{cap} slots and the incoming batch may not fit; call "
                f"grow() — or compact() if tombstones are pending — (or "
                f"run under the service's IndexManager growth watermark) "
                f"before inserting — refusing to silently drop admitted "
                f"docs")
        self._bound = fresh

    # -- slot logging (track_slots / lifecycle ledger) -----------------------
    def _record_insert(self, keep, free_taken: list[list[int]]) -> None:
        """Host mirror of the fused step's per-shard slot assignment.

        Row r routes to shard r % nshards; within a shard, kept rows (in
        row order) consume that shard's offered frees first, then fresh
        slots from its high-water count. Syncs `keep`; only called while
        track_slots is on. The count mirror is seeded from the PRE-insert
        state in fused_step."""
        order = np.flatnonzero(host(keep))  # foldlint: sync-ok(slot logging is opt-in; lifecycle needs the host mask)
        taken = [0] * self.nshards
        slots = np.empty(len(order), np.int64)
        for j, r in enumerate(order):
            s = int(r) % self.nshards
            fh = free_taken[s]
            if taken[s] < len(fh):
                local = fh[taken[s]]
                taken[s] += 1
            else:
                local = int(self._count_hw[s])
                self._count_hw[s] += 1
            slots[j] = local * self.nshards + s
        self._slots_q.append(slots.astype(np.int32))

    # -- protocol: fused ②-⑤ -------------------------------------------------
    def fused_step(self, sig: SigBatch, valid=None) -> StepResult:
        bitmaps, pcs = sig.bitmaps, sig.pcs
        B = bitmaps.shape[0]
        pad = (-B) % self.nshards
        per_shard = (B + pad) // self.nshards
        # offer each shard up to per_shard reclaimed slots; the guard
        # credits only the count available on EVERY shard (conservative)
        offer = [f[:per_shard] for f in self._free]
        self._guard_capacity(per_shard, min(len(o) for o in offer))
        self._free = [f[len(o):] for f, o in zip(self._free, offer)]
        frees = np.full((self.nshards, per_shard), -1, np.int32)
        for s, o in enumerate(offer):
            frees[s, :len(o)] = o
        valid = np.ones(B, bool) if valid is None else host(valid).astype(bool)
        if pad:
            bitmaps = torch.cat([bitmaps, bitmaps.new_zeros(
                (pad, bitmaps.shape[1]))])
            pcs = torch.cat([pcs, pcs.new_zeros(pad)])
            valid = np.pad(valid, (0, pad))
        levels = torch.from_numpy(sample_levels(
            B + pad, self.hnsw_cfg, seed=self._batches + self.cfg.seed + 1))
        self._batches += 1
        if self.track_slots and self._count_hw is None:
            # one-time sync of the per-shard high-water mirror, BEFORE the
            # step so this batch's own inserts are not double-counted
            self._count_hw = self._counts()  # foldlint: sync-ok(one-time count-mirror seed; advanced host-side after)
        dev = self.device
        self.states, keep, keep_in = self._step(
            self.states, bitmaps, pcs, levels.to(dev),
            torch.from_numpy(valid).to(dev), torch.from_numpy(frees).to(dev))
        if self.track_slots:
            self._record_insert(keep, offer)
        else:
            self._count_hw = None    # host count mirror goes stale
        # the merged similarities are internal to the fused step; surface
        # the verdict with neighbor ids unknown (-1)
        k = self.cfg.k
        ids = torch.full((B, k), -1, dtype=torch.int32, device=dev)
        sims = torch.full((B, k), -float("inf"), dtype=torch.float32,
                          device=dev)
        return StepResult(keep=keep[:B], keep_in_batch=keep_in[:B],
                          ids=ids, sims=sims)

    # unreached on the admission path while fused_step exists, but `search`
    # also serves the READ-ONLY query path (DedupPipeline.query, the
    # cluster replicas): merged global top-k with interleaved global ids.
    # Every shard sees the whole batch, so no row padding is needed here.
    def search(self, sig: SigBatch):
        return self._search(self.states, sig.bitmaps, sig.pcs)

    def batch_sim(self, sig):
        raise NotImplementedError("fused backend: use fused_step")

    def insert(self, sig, keep):
        raise NotImplementedError("fused backend: use fused_step")

    # -- deletion / compaction (the protocol's DELETION CONTRACT) ------------
    @property
    def deleted(self) -> int:
        return self._n_deleted

    @property
    def dead_fraction(self) -> float:
        # host-exact tombstone counter: no device sync (polled every batch)
        return self._n_dead / max(self.capacity, 1)

    def delete(self, ids) -> int:  # foldlint: cold-path
        """Tombstone global slot ids, each routed to its owning shard
        (id % nshards). Idempotent; slots become reusable only after
        compact()."""
        ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
        ids = ids[(ids >= 0) & (ids < self.capacity)]
        if len(ids) == 0:
            return 0
        shard, local = self._decode_slots(ids)
        per = [local[shard == s] for s in range(self.nshards)]
        width = max(len(p) for p in per)
        # padded to the next power of two, as the reference pads for
        # stable compiled shapes
        D = 1 << int(width - 1).bit_length() if width > 1 else 1
        mat = np.full((self.nshards, D), -1, np.int64)
        for s, p in enumerate(per):
            mat[s, :len(p)] = p
        self.states, n_dev = self._delete(
            self.states, torch.from_numpy(mat.astype(np.int32)).to(self.device))
        n = int(n_dev.sum())        # host sync
        self._n_deleted += n
        self._n_dead += n
        return n

    def _rederive_free(self) -> np.ndarray:  # foldlint: cold-path
        """Per-shard host free lists = every unlinked slot below each
        shard's high-water mark, re-derived from the device state. Returns
        the per-shard counts."""
        counts = self._counts()
        self._free = [
            [int(i) for i in np.flatnonzero(
                st.node_level[:int(c)].cpu().numpy() < 0)]
            for st, c in zip(self.states, counts)]
        return counts

    def compact(self) -> dict:  # foldlint: cold-path
        """Repair every sub-graph's adjacency around its tombstones, unlink
        them, and re-derive the per-shard host free lists (host sync:
        callers schedule this off the hot path)."""
        t0 = time.perf_counter()
        self.states, n_dev = self._compact(self.states)
        reclaimed = int(n_dev.sum())
        counts = self._rederive_free()
        self._n_dead = 0
        self._count_hw = counts.copy()
        self._known_max = int(counts.max())     # re-anchor overflow guard
        self._bound = 0
        self._t_compact += time.perf_counter() - t0
        return {"reclaimed": reclaimed,
                "free": sum(len(f) for f in self._free),
                "t_compact": self._t_compact}

    # -- lifecycle -----------------------------------------------------------
    def grow(self, new_capacity: int) -> None:  # foldlint: cold-path
        """Re-pad every shard to ceil(new_capacity/nshards) per-shard slots
        (graphs kept exactly). new_capacity is TOTAL capacity, matching the
        `capacity` property. Global slot ids are interleaved, so ids
        exported before a grow stay valid after it."""
        per_shard = -(-new_capacity // self.nshards)
        if per_shard <= self.hnsw_cfg.capacity:
            return
        self.hnsw_cfg, self.states = sharded_grow(self.hnsw_cfg, self.states,
                                                  per_shard)
        self.cfg = dataclasses.replace(self.cfg, capacity=per_shard)
        self._lower()
        self._known_max = int(self._counts().max())
        self._bound = 0

    def save(self, ckpt_dir: str, step: int, async_write: bool = False):  # foldlint: cold-path
        """One coordinated snapshot in the reference's layout: the stacked
        per-shard HNSW arrays plus the shard-layout manifest."""
        from repro_torch.train import checkpoint as ckpt
        tree = {"states": stack_states(self.states),
                "batches": np.int32(self._batches)}
        writer = ckpt.save_async if async_write else ckpt.save
        writer(ckpt_dir, step, tree,
               extra={"capacity": self.hnsw_cfg.capacity,
                      "shards": self.nshards, "axis": self.axis})

    def restore(self, ckpt_dir: str, step: int | None = None) -> int:  # foldlint: cold-path
        """Restore a coordinated snapshot onto this backend's shards.

        Shard-layout rules: a snapshot taken at N shards restores exactly
        at N' == N; N' > N is a scale-out restore (the N saved sub-graphs
        land on the first N shards, the rest start empty; admission
        round-robins over all N'); N' < N is REFUSED (per-shard HNSW
        graphs cannot be merged). Per-shard capacity follows the "hnsw"
        convention: the snapshot's is adopted, then grown back up to the
        configured size if smaller."""
        from repro_torch.train import checkpoint as ckpt
        step = ckpt.latest_step(ckpt_dir) if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint found in {ckpt_dir!r}")
        meta = ckpt.manifest(ckpt_dir, step)
        snap_shards = int(meta.get("shards", 1))
        if snap_shards > self.nshards:
            raise ValueError(
                f"snapshot was taken at {snap_shards} shards but this "
                f"backend has {self.nshards}: per-shard HNSW graphs cannot "
                f"be merged — restore on >= {snap_shards} shards (scale-out "
                f"is supported, scale-in is not)")
        snap_cap = int(meta.get("capacity", self.hnsw_cfg.capacity))
        like = {"states": HNSWState(*[0] * len(HNSWState._fields)),
                "batches": 0}
        got = ckpt.restore(ckpt_dir, step, like)
        st = got["states"]
        exp = (snap_shards, snap_cap, self.hnsw_cfg.words)
        if tuple(st.vectors.shape) != exp:
            raise ValueError(
                f"snapshot geometry {tuple(st.vectors.shape)} does not "
                f"match manifest/config expectation {exp} "
                f"(words/M0/max_level must match the saving config)")
        # the target-geometry stacked arrays: empty shards padded
        # (scale-out) and empty per-shard slots (capacity adopt-then-grow)
        cap_t = max(snap_cap, self.hnsw_cfg.capacity)
        pad_n, pad_c = self.nshards - snap_shards, cap_t - snap_cap

        def padded(a, cval, cap_axis):
            width = [(0, 0)] * a.ndim
            width[0] = (0, pad_n)
            if cap_axis is not None:
                width[cap_axis] = (0, pad_c)
            return np.pad(a, width, constant_values=cval)

        stacked = HNSWState(
            vectors=padded(st.vectors, 0, 1),
            pb=padded(st.pb, 0, 1),
            neighbors=padded(st.neighbors, -1, 2),
            node_level=padded(st.node_level, -1, 1),
            dead=padded(st.dead, False, 1),
            entry=padded(st.entry, -1, None),
            top_level=padded(st.top_level, -1, None),
            count=padded(st.count, 0, None),
        )
        self.hnsw_cfg = self.hnsw_cfg._replace(capacity=cap_t)
        self.cfg = dataclasses.replace(self.cfg, capacity=cap_t)
        self.states = unstack_states(stacked, self.device)
        self._lower()
        self._batches = int(got["batches"])
        # every host-side deletion mirror is re-derived from the restored
        # arrays: tombstones and free-listed slots live in the states
        counts = self._rederive_free()
        self._n_dead = int(stacked.dead.sum())
        self._n_deleted = self._n_dead
        self._count_hw = counts.copy()
        self._slots_q = []
        self._known_max = int(counts.max())
        self._bound = 0
        return step

    def stats_schema(self) -> tuple[str, ...]:
        return ("count", "capacity", "shards", "deleted", "dead", "free")

    def stats(self) -> dict:
        return {"count": self.inserted, "capacity": self.capacity,
                "shards": self.nshards, "deleted": self._n_deleted,
                "dead": self._n_dead,
                "free": sum(len(f) for f in self._free)}


# -- analyzable program specs (repro_torch.analysis) -------------------------
# The fused ②-⑤ step on ONE shard, as the reference's spec pins a 1-device
# mesh: the step runs every shard's programs in turn, so one shard is the
# program the layout repeats.
_SPEC_CAP = 4096      # per-shard capacity
_SPEC_B = 64


@register_programs("index.backends.sharded")
def _sharded_programs() -> list[ProgramSpec]:
    def make_step(device):
        from repro_torch.analysis.inputs import spec_index
        cfg = FoldConfig(capacity=_SPEC_CAP)
        ix = spec_index(_SPEC_CAP).on(device)
        step = make_sharded_dedup_step(
            ix.cfg, 1, tau=bitmap_tau(cfg), k=cfg.k, masked=True,
            reuse_search=True, free_slots=True)
        B = _SPEC_B
        return step, ([ix.state], ix.queries[:B], ix.pcs[:B], ix.levels[:B],
                      torch.ones(B, dtype=torch.bool, device=device),
                      torch.full((1, B), -1, dtype=torch.int32,
                                 device=device)), {}
    return [ProgramSpec(
        name="hnsw_sharded/fused_step", make=make_step,
        alias_expect=len(HNSWState._fields) - 3,  # foldlint: disable=F141 (the port's ProgramSpec: alias_expect)
        budget=ProgramBudget(
            temp_bytes=900_000_000, host_syncs=70, card_syncs=76,
            note="each shard's insert updates its state in place: vectors, "
                 "pb, neighbors, node_level and dead are shared, count, "
                 "entry and top_level re-made 0-d tensors (the reference "
                 "keeps donation off and aliases none)"))]


@register("hnsw_sharded")
def _make_sharded(cfg: FoldConfig | None = None, shards: int | None = None,
                  device: str | torch.device | None = None,
                  axis: str = "data", **opts) -> ShardedDedupBackend:
    if opts:    # FoldConfig overrides (e.g. query_chunk), like "hnsw"
        cfg = dataclasses.replace(cfg or FoldConfig(), **opts)
    return ShardedDedupBackend(cfg or FoldConfig(), shards=shards,
                               device=device, axis=axis)
