"""Brute-force online admission, the exact reference and Table 1's ground
truth (port of `repro/index/backends/brute.py`).

Per incoming document: exact MinHash-Jaccard against *every* admitted
signature, over the store in chunks of `_CHUNK` rows. O(N) per doc. The
store lives on the backend's device; one chunk's (B, chunk) similarity
and its per-query best are plain torch reductions there (no TPU kernel
computes them in the reference either: its `pairwise_minhash_jaccard` is
plain jnp). Only the free list is host bookkeeping.

Ties are common (similarities are multiples of 1/H) and are broken as the
reference breaks them: the first maximum within a chunk (`jnp.argmax`),
the earlier chunk across chunks (a strict `best > sims` update).

Deletion is eager (no tombstones): a deleted row is masked out of every
later search and its slot goes onto a free list that insert drains before
fresh rows, so `dead_fraction` stays 0.0 and `compact()` is the protocol's
no-op.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitmap import pairwise_minhash_jaccard
from repro_torch.core.dedup import FoldConfig
from repro_torch.device import resolve_device
from repro_torch.index.protocol import BATCH_FIRST, DedupBackend, SigBatch, SigSpec
from repro_torch.index.registry import register

__all__ = ["BruteForceBackend"]

_CHUNK = 8192      # db-axis chunking bounds the (B, N, H) comparison temp


def _chunk_best(qsigs: torch.Tensor, db_chunk: torch.Tensor,
                free_mask: torch.Tensor):
    """Similarity + free mask + per-query best for one db chunk: (first
    argmax, max), each (B,). Free rows score -inf and never win."""
    sim = pairwise_minhash_jaccard(qsigs, db_chunk)
    sim = torch.where(free_mask[None, :], torch.full_like(sim, -np.inf), sim)
    best = sim.max(dim=1).values
    col = torch.arange(sim.shape[1], device=sim.device, dtype=torch.int32)
    first = torch.where(sim == best[:, None], col, sim.shape[1]).min(dim=1)
    return first.values, best


class BruteForceBackend(DedupBackend):
    name = "brute"
    order = BATCH_FIRST
    supports_growth = True
    supports_snapshots = True
    supports_deletion = True
    track_slots = False

    def __init__(self, cfg: FoldConfig,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.store = torch.zeros((cfg.capacity, cfg.num_hashes),
                                 dtype=torch.int32, device=self.device)
        self.n = 0                       # high-water row mark
        self._free: list[int] = []       # deleted rows < n, reusable
        self._free_mask = np.zeros(cfg.capacity, bool)
        self._free_dev: torch.Tensor | None = None   # device copy, lazily
        self._n_deleted = 0

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
        return self.store.shape[0]

    @property
    def inserted(self) -> int:
        return self.n - len(self._free)

    @property
    def deleted(self) -> int:
        return self._n_deleted

    def _free_on_device(self) -> torch.Tensor:
        if self._free_dev is None:
            self._free_dev = torch.from_numpy(self._free_mask).to(self.device)
        return self._free_dev

    def batch_sim(self, sig: SigBatch):
        return pairwise_minhash_jaccard(sig.sigs, sig.sigs)

    def search(self, sig: SigBatch):
        B = sig.sigs.shape[0]
        ids = torch.full((B,), -1, dtype=torch.int32, device=self.device)
        sims = torch.full((B,), -np.inf, dtype=torch.float32,
                          device=self.device)
        free = self._free_on_device()
        for s in range(0, self.n, _CHUNK):
            e = min(s + _CHUNK, self.n)
            j, best = _chunk_best(sig.sigs, self.store[s:e], free[s:e])
            better = best > sims       # strict: an earlier chunk keeps ties
            ids = torch.where(better, j + s, ids)
            sims = torch.where(better, best, sims)
        return ids[:, None], sims[:, None]

    def insert(self, sig: SigBatch, keep, search_ids=None) -> None:
        keep_h = torch.as_tensor(keep).cpu().numpy().astype(bool)  # foldlint: sync-ok(host free-list bookkeeping needs the admitted rows)
        order = np.flatnonzero(keep_h)
        t = min(len(order), len(self._free))
        fresh = len(order) - t
        if self.n + fresh > self.capacity:
            raise RuntimeError(
                f"brute store full: {self.n} of {self.capacity} rows used "
                f"and the batch admits {fresh} beyond the free list; call "
                f"grow() — refusing to silently drop admitted docs")
        slots = np.concatenate(
            [np.asarray(self._free[:t], np.int64),  # foldlint: sync-ok(host free-list bookkeeping)
             self.n + np.arange(fresh, dtype=np.int64)]).astype(np.int32)
        self._free = self._free[t:]
        if len(order):
            dev_slots = torch.from_numpy(slots.astype(np.int64)).to(self.device)
            rows = torch.from_numpy(order).to(self.device)
            self.store[dev_slots] = sig.sigs[rows]
        if t:
            self._free_mask[slots[:t]] = False
            self._free_dev = None
        self.n += fresh
        if self.track_slots:
            q = list(getattr(self, "_slots_q", []))
            q.append(slots)
            self._slots_q = q

    def delete(self, ids) -> int:  # foldlint: cold-path
        ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
        ids = ids[(ids >= 0) & (ids < self.n)]
        ids = ids[~self._free_mask[ids]]
        if len(ids) == 0:
            return 0
        self._free_mask[ids] = True
        self._free_dev = None
        self._free = sorted(self._free + [int(i) for i in ids])
        self._n_deleted += len(ids)
        return len(ids)

    def grow(self, new_capacity: int) -> None:  # foldlint: cold-path
        if new_capacity <= self.capacity:
            return
        pad = new_capacity - self.capacity
        self.store = torch.cat([self.store, torch.zeros(
            (pad, self.cfg.num_hashes), dtype=torch.int32,
            device=self.device)])
        self._free_mask = np.concatenate([self._free_mask,
                                          np.zeros(pad, bool)])
        self._free_dev = None

    def _tree(self) -> dict:
        """The checkpoint tree, leaf for leaf the reference's."""
        return {"store": self.store.cpu().numpy().view(np.uint32),
                "n": np.int64(self.n),
                "free_mask": self._free_mask.astype(np.uint8)}

    def save(self, ckpt_dir: str, step: int, async_write: bool = False):  # foldlint: cold-path
        from repro_torch.train import checkpoint as ckpt
        writer = ckpt.save_async if async_write else ckpt.save
        writer(ckpt_dir, step, self._tree(),
               extra={"capacity": self.capacity})

    def restore(self, ckpt_dir: str, step: int | None = None) -> int:  # foldlint: cold-path
        from repro_torch.train import checkpoint as ckpt
        step = ckpt.latest_step(ckpt_dir) if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint found in {ckpt_dir!r}")
        meta = ckpt.manifest(ckpt_dir, step)
        cap = int(meta.get("capacity", self.capacity))
        target = max(cap, self.capacity)
        got = ckpt.restore(ckpt_dir, step,
                           {"store": 0, "n": 0, "free_mask": 0})
        store = np.ascontiguousarray(got["store"].astype(np.uint32))
        self.store = torch.from_numpy(store.view(np.int32)).to(self.device)
        self.n = int(got["n"])
        self._free_mask = np.asarray(got["free_mask"], bool)
        self._free_dev = None
        # the free list round-trips through the mask; cumulative `deleted`
        # is not persisted and restarts at the restored free count
        self._free = [int(i) for i in np.flatnonzero(self._free_mask[:self.n])]
        self._n_deleted = len(self._free)
        self._slots_q = []
        if target > cap:
            self.grow(target)
        return step

    def stats_schema(self) -> tuple[str, ...]:
        return ("count", "capacity", "deleted", "free")

    def stats(self) -> dict:
        return {"count": self.inserted, "capacity": self.capacity,
                "deleted": self._n_deleted, "free": len(self._free)}


@register("brute")
def _make_brute(cfg: FoldConfig | None = None,
                device: str | torch.device | None = None) -> BruteForceBackend:
    return BruteForceBackend(cfg or FoldConfig(), device=device)
