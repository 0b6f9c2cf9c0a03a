"""FOLD's bitmap-HNSW backend behind the `repro_torch.index` protocol (port
of `HNSWBitmapBackend` and the parts of `_HNSWLifecycle` the main path
uses, from `repro/index/backends/hnsw.py`).

Step ② scores the batch with the bitmap-Jaccard kernel (K2, or K3 under
`cached=False`); steps ③ and ⑤ run core/hnsw.py's tensor programs on the
backend's device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.dedup import FoldConfig, batch_jaccard, bitmap_tau
from repro_torch.core.hnsw import (HNSWConfig, HNSWState, hnsw_grow, hnsw_init,
                                   hnsw_insert_batch, hnsw_search,
                                   sample_levels)
from repro_torch.device import resolve_device
from repro_torch.index.protocol import BATCH_FIRST, DedupBackend, SigBatch, SigSpec
from repro_torch.index.registry import register

__all__ = ["HNSWBitmapBackend"]


class _HNSWLifecycle(DedupBackend):
    """Capacity lifecycle and overflow refusal shared by HNSW backends.

    Subclasses provide `cfg`, `hnsw_cfg`, `state`, `device` and a
    `_batches` level-seed counter."""

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
    supports_snapshots = False
    supports_deletion = False
    track_slots = False

    def _guard_capacity(self, keep) -> None:
        """Refuse an insert that could overflow the fixed-capacity index:
        a verdict must never claim admission for a dropped row. The
        (device) keep mask is charged the batch size until a (rare) sync
        re-anchors the bound."""
        cap = self.hnsw_cfg.capacity
        charge = int(keep.shape[0])
        if self._known_count + self._dispatched_bound + charge <= cap:
            self._dispatched_bound += charge
            return
        self._known_count = int(self.state.count)  # foldlint: sync-ok(rare re-anchor: only when the sync-free bound says the batch might not fit)
        self._dispatched_bound = 0
        n_keep = int(keep.sum())  # foldlint: sync-ok(already syncing to re-anchor; exact kept count is free here)
        if self._known_count + n_keep > cap:
            raise RuntimeError(
                f"HNSW index full: {self._known_count} of {cap} slots used "
                f"and the batch admits {n_keep}; call grow() before "
                f"inserting — refusing to silently drop admitted docs")
        self._dispatched_bound = n_keep

    def _seeds_from(self, search_ids):
        """Step-③ neighbor ids -> batched-insert discovery seeds (only with
        cfg.reuse_search)."""
        if search_ids is None or not getattr(self.cfg, "reuse_search", True):
            return None
        return search_ids.to(torch.int32)

    @property
    def inserted(self) -> int:
        """LIVE document count (a host sync on one reduction)."""
        return int(((self.state.node_level >= 0) & ~self.state.dead).sum())  # foldlint: sync-ok(occupancy poll; one reduction)

    def grow(self, new_capacity: int) -> None:  # foldlint: cold-path
        """Re-pad the index to a larger capacity (graph kept exactly)."""
        self.hnsw_cfg, self.state = hnsw_grow(self.hnsw_cfg, self.state,
                                              new_capacity)
        self.cfg = dataclasses.replace(self.cfg, capacity=new_capacity)
        self._known_count = int(self.state.count)
        self._dispatched_bound = 0

    def save(self, ckpt_dir: str, step: int, async_write: bool = False):
        raise NotImplementedError("save (the checkpoint layout) is not "
                                  "ported yet")

    def restore(self, ckpt_dir: str, step: int | None = None) -> int:
        raise NotImplementedError("restore (the checkpoint layout) is not "
                                  "ported yet")

    def compact(self) -> dict:
        raise NotImplementedError("compact is not ported yet")


class HNSWBitmapBackend(_HNSWLifecycle):
    """FOLD's index: HNSW top-k over one-hot-folded bitmap signatures."""

    name = "hnsw"
    order = BATCH_FIRST

    def __init__(self, cfg: FoldConfig,
                 device: str | torch.device | None = None):
        for flag, what in (("verify_minhash", "verify_minhash"),
                           ("select_heuristic", "select_heuristic "
                            "(_select_diverse)")):
            if getattr(cfg, flag):
                raise NotImplementedError(f"{what} is not ported yet")
        if not cfg.batched_insert:
            raise NotImplementedError("batched_insert=False (the per-doc "
                                      "_insert_one path) is not ported yet")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.hnsw_cfg = cfg.hnsw()
        self.state: HNSWState = hnsw_init(self.hnsw_cfg, self.device)
        self.tau_b = bitmap_tau(cfg)
        self._batches = 0     # level-seed basis: monotone, sync-free

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
        return self.tau_b

    @property
    def capacity(self) -> int:
        return self.hnsw_cfg.capacity

    def batch_sim(self, sig: SigBatch):
        return batch_jaccard(sig.bitmaps, sig.pcs, self.cfg.use_kernel,
                             self.cfg.cached)

    def search(self, sig: SigBatch):
        return hnsw_search(self.hnsw_cfg, self.state, sig.bitmaps,
                           k=self.cfg.k)

    def insert(self, sig: SigBatch, keep, search_ids=None):
        B = sig.bitmaps.shape[0]
        levels = torch.from_numpy(sample_levels(
            B, self.hnsw_cfg, seed=self._batches + self.cfg.seed + 1))
        self._batches += 1
        # refuse BEFORE any state mutation. No reclaimed slots are offered:
        # only compaction frees slots, and it is not ported yet.
        self._guard_capacity(keep)
        self.state, _ = hnsw_insert_batch(self.hnsw_cfg, self.state,
                                          sig.bitmaps, sig.pcs,
                                          levels.to(self.device), keep,
                                          seed_ids=self._seeds_from(search_ids))
        return self.state.count     # timing handle

    def stats_schema(self) -> tuple[str, ...]:
        return ("count", "capacity", "batches")

    def stats(self) -> dict:
        return {"count": self.inserted, "capacity": self.capacity,
                "batches": self._batches}


@register("hnsw")
def _make_hnsw(cfg: FoldConfig | None = None,
               device: str | torch.device | None = None,
               **opts) -> HNSWBitmapBackend:
    if opts:
        cfg = dataclasses.replace(cfg or FoldConfig(), **opts)
    return HNSWBitmapBackend(cfg or FoldConfig(), device=device)
