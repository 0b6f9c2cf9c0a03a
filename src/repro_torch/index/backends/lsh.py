"""MinHash-LSH bucket backends (paper §2.1, Fig 1; Table 1), port of
`repro/index/backends/lsh.py`.

  DPKBackend    ("dpk")      IBM Data-Prep-Kit-style banding. With
      rebuild=True (default) the band buckets are re-materialized over the
      full accumulated corpus on every search — the behaviour the paper
      identifies as DPK's scalability failure (candidate buckets shift with
      every incoming document), producing the linear throughput collapse of
      Fig. 2/6. rebuild=False keeps incremental buckets (kinder than real
      DPK; useful for ablations).

  FlatLSHBackend ("flat_lsh") Milvus MINHASH_LSH analogue: incremental
      buckets, but candidate retrieval is *budgeted*: at most `topk`
      DISTINCT candidates are verified per query (the paper's Table 1
      trades recall for throughput via this knob). Candidates beyond the
      budget are silently dropped — the recall failure mode the paper
      describes.

Band/row counts are calibrated to tau via the S-curve (H=112, tau=0.7 →
14 bands × 8 rows, threshold ≈ 0.72).

Both backends are HOST-SIDE by design, as in the reference: stores,
buckets and verification are numpy/dict structures. Only step ① (MinHash,
kernel K1 on a card) and step ②'s `batch_sim` run on the backend's
device. `search` takes the batch's signatures to the host once, as uint32
(`.view(np.uint32)`: the port's int32 bits must never be sign-extended
into band keys or the store), and `insert` reuses that copy. Verification
is the reference's numpy code, so it rounds as the reference does
(float64 mean, stored into f32 sims).
"""
# foldlint: module-sync-ok(host-side backend: search/insert operate on numpy stores and python dict buckets by design)
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from repro_torch.baselines.base import band_keys, pick_bands
from repro_torch.core.bitmap import pairwise_minhash_jaccard
from repro_torch.core.dedup import FoldConfig
from repro_torch.device import resolve_device
from repro_torch.index.protocol import BATCH_FIRST, DedupBackend, SigBatch, SigSpec
from repro_torch.index.registry import register

__all__ = ["DPKBackend", "FlatLSHBackend"]


class _BandedLSHBase(DedupBackend):
    """Shared store/bucket machinery: (capacity, H) uint32 signature rows
    plus (capacity, bands) uint64 band keys and a key->row bucket map.

    Row allocation goes through `_alloc_rows` so subclasses can layer a
    free-list on top (FlatLSH deletion); `_free_mask` is None for backends
    without deletion (DPK — a rebuilt-every-search bucket map has no stable
    rows to free)."""

    order = BATCH_FIRST
    supports_growth = True
    supports_snapshots = True
    supports_deletion = False
    track_slots = False
    _free_mask: np.ndarray | None = None

    def __init__(self, cfg: FoldConfig,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.bands, self.rows = pick_bands(cfg.num_hashes, cfg.tau)
        self.store = np.zeros((cfg.capacity, cfg.num_hashes), np.uint32)
        self.keys = np.zeros((cfg.capacity, self.bands), np.uint64)
        self.n = 0
        self.buckets: dict[int, list[int]] = defaultdict(list)
        # stashed search -> insert: the batch's host signatures and keys
        self._qsigs: np.ndarray | None = None
        self._qkeys: np.ndarray | None = None

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
        return len(self.store)

    @property
    def inserted(self) -> int:
        return self.n

    def batch_sim(self, sig: SigBatch):
        return pairwise_minhash_jaccard(sig.sigs, sig.sigs)

    def _host_batch(self, sig: SigBatch) -> tuple[np.ndarray, np.ndarray]:
        """The batch's signatures on the host as uint32 (one copy) and
        their band keys, stashed for insert."""
        sigs = sig.sigs.cpu().numpy().view(np.uint32)
        self._qsigs = sigs
        self._qkeys = band_keys(sigs, self.bands, self.rows)
        return sigs, self._qkeys

    @staticmethod
    def _best(store_rows: np.ndarray, cand: np.ndarray, q: np.ndarray):
        """Verify candidates by exact lane agreement; return (id, sim)."""
        sims = (store_rows == q[None, :]).mean(axis=1)
        j = int(np.argmax(sims))
        return int(cand[j]), float(sims[j])

    def insert(self, sig: SigBatch, keep, search_ids=None) -> None:
        # search_ids (the step-③ reuse hook) is advisory and unused here:
        # bucket insertion re-derives everything from the stashed band keys
        if self._qkeys is None:
            raise RuntimeError("insert() before search()")
        new_idx = np.flatnonzero(np.asarray(keep))
        rows = self._alloc_rows(len(new_idx))
        self.store[rows] = self._qsigs[new_idx]
        self.keys[rows] = self._qkeys[new_idx]
        self._bucket_new(rows, new_idx)
        if self.track_slots:
            q = list(getattr(self, "_slots_q", []))
            q.append(rows.astype(np.int32))
            self._slots_q = q
        self._qsigs = self._qkeys = None

    def _check_room(self, fresh: int) -> None:
        if self.n + fresh > self.capacity:
            raise RuntimeError(
                f"{self.name} store full: {self.n} of {self.capacity} rows "
                f"used and the batch admits {fresh} beyond the free list; "
                f"call grow() (or run under the service's IndexManager "
                f"growth watermark) — refusing to silently drop admitted "
                f"docs")

    def _alloc_rows(self, m: int) -> np.ndarray:
        """Allocate m store rows (fresh only; FlatLSH layers free-list
        reuse on top). Raises before any mutation on overflow."""
        self._check_room(m)
        rows = np.arange(self.n, self.n + m, dtype=np.int64)
        self.n += m
        return rows

    def _bucket_new(self, rows: np.ndarray, new_idx: np.ndarray) -> None:
        raise NotImplementedError

    def grow(self, new_capacity: int) -> None:
        if new_capacity <= self.capacity:
            return
        pad = new_capacity - self.capacity
        self.store = np.concatenate(
            [self.store, np.zeros((pad, self.cfg.num_hashes), np.uint32)])
        self.keys = np.concatenate(
            [self.keys, np.zeros((pad, self.bands), np.uint64)])
        if self._free_mask is not None:
            self._free_mask = np.concatenate(
                [self._free_mask, np.zeros(pad, bool)])

    def save(self, ckpt_dir: str, step: int, async_write: bool = False):
        """Checkpoint leaves as the reference's: store uint32, keys
        uint64, n a 0-d int64, and free_mask uint8 where deletion is on."""
        from repro_torch.train import checkpoint as ckpt
        tree = {"store": self.store, "keys": self.keys,
                "n": np.int64(self.n)}
        if self._free_mask is not None:       # deletion state round-trips
            tree["free_mask"] = self._free_mask.astype(np.uint8)
        writer = ckpt.save_async if async_write else ckpt.save
        writer(ckpt_dir, step, tree, extra={"capacity": self.capacity})

    def restore(self, ckpt_dir: str, step: int | None = None) -> int:
        from repro_torch.train import checkpoint as ckpt
        step = ckpt.latest_step(ckpt_dir) if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint found in {ckpt_dir!r}")
        meta = ckpt.manifest(ckpt_dir, step)
        cap = int(meta.get("capacity", self.capacity))
        target = max(cap, self.capacity)
        tmpl = {"store": 0, "keys": 0, "n": 0}
        if self._free_mask is not None:
            tmpl["free_mask"] = 0
        got = ckpt.restore(ckpt_dir, step, tmpl)
        self.store, self.keys = got["store"], got["keys"]
        self.n = int(got["n"])
        if self._free_mask is not None:
            self._take_free(np.asarray(got["free_mask"], bool))
        self.buckets = defaultdict(list)
        self._rebucket()
        if target > cap:
            self.grow(target)
        return step

    def _take_free(self, mask: np.ndarray) -> None:
        raise NotImplementedError      # only deletion subclasses restore it

    def _rebucket(self) -> None:
        """Rebuild the bucket map from the persisted band keys (free-listed
        rows stay unbucketed — a restored index never resurrects them)."""
        for i in range(self.n):
            if self._free_mask is not None and self._free_mask[i]:
                continue
            for k in self.keys[i]:
                self.buckets[int(k)].append(i)

    def stats_schema(self) -> tuple[str, ...]:
        return ("count", "capacity", "buckets")

    def stats(self) -> dict:
        return {"count": self.inserted, "capacity": self.capacity,
                "buckets": len(self.buckets)}


class DPKBackend(_BandedLSHBase):
    name = "dpk"

    def __init__(self, cfg: FoldConfig, rebuild: bool = True,
                 device: str | torch.device | None = None):
        super().__init__(cfg, device=device)
        self.rebuild = rebuild

    def search(self, sig: SigBatch):
        sigs_np, qkeys = self._host_batch(sig)
        if self.rebuild and self.n > 0:
            # DPK failure mode: buckets recomputed over the full corpus
            self.buckets = defaultdict(list)
            self._rebucket()
        B = len(sigs_np)
        ids = np.full((B, 1), -1, np.int32)
        sims = np.full((B, 1), -np.inf, np.float32)
        for i in range(B):
            cand: list[int] = []
            for k in qkeys[i]:
                cand.extend(self.buckets.get(int(k), ()))
            if not cand:
                continue
            cand = np.unique(np.asarray(cand, dtype=np.int64))
            ids[i, 0], sims[i, 0] = self._best(self.store[cand], cand,
                                               sigs_np[i])
        return ids, sims

    def _bucket_new(self, rows, new_idx) -> None:
        if not self.rebuild:        # incremental mode maintains buckets live
            for r in rows:
                for k in self.keys[r]:
                    self.buckets[int(k)].append(int(r))


class FlatLSHBackend(_BandedLSHBase):
    name = "flat_lsh"
    supports_deletion = True

    def __init__(self, cfg: FoldConfig, topk: int = 4,
                 device: str | torch.device | None = None):
        super().__init__(cfg, device=device)
        self.topk = topk
        self._free: list[int] = []      # deleted rows < n, reusable, sorted
        self._free_mask = np.zeros(cfg.capacity, bool)
        self._n_deleted = 0

    @property
    def inserted(self) -> int:
        return self.n - len(self._free)

    @property
    def deleted(self) -> int:
        return self._n_deleted

    def delete(self, ids) -> int:
        """Eager deletion: pull the rows out of their band buckets (they
        can never be retrieved again) and free-list them for reuse."""
        ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
        ids = ids[(ids >= 0) & (ids < self.n)]
        ids = ids[~self._free_mask[ids]]
        if len(ids) == 0:
            return 0
        for r in ids:
            r = int(r)
            for k in self.keys[r]:
                b = self.buckets.get(int(k))
                if b is not None and r in b:
                    b.remove(r)
        self._free_mask[ids] = True
        self._free = sorted(self._free + [int(i) for i in ids])
        self._n_deleted += len(ids)
        return len(ids)

    def _alloc_rows(self, m: int) -> np.ndarray:
        t = min(m, len(self._free))
        self._check_room(m - t)
        rows = np.concatenate(
            [np.asarray(self._free[:t], np.int64),
             np.arange(self.n, self.n + m - t, dtype=np.int64)])
        self._free = self._free[t:]
        self._free_mask[rows] = False
        self.n += m - t
        return rows

    def _take_free(self, mask: np.ndarray) -> None:
        # cumulative `deleted` is not persisted; it restarts at the
        # restored free count
        self._free_mask = mask
        self._free = [int(i) for i in np.flatnonzero(mask[:self.n])]
        self._n_deleted = len(self._free)
        self._slots_q = []

    def stats_schema(self) -> tuple[str, ...]:
        return ("count", "capacity", "buckets", "deleted", "free")

    def stats(self) -> dict:
        return {**super().stats(), "deleted": self._n_deleted,
                "free": len(self._free)}

    def search(self, sig: SigBatch):
        sigs_np, qkeys = self._host_batch(sig)
        B = len(sigs_np)
        ids = np.full((B, 1), -1, np.int32)
        sims = np.full((B, 1), -np.inf, np.float32)
        for i in range(B):
            # dedup WHILE collecting: the budget counts DISTINCT candidates
            cand: list[int] = []
            seen: set[int] = set()
            for k in qkeys[i]:
                for r in self.buckets.get(int(k), ()):
                    if r not in seen:
                        seen.add(r)
                        cand.append(r)
                        if len(cand) >= self.topk:    # the topK budget
                            break
                if len(cand) >= self.topk:
                    break
            if not cand:
                continue
            cand = np.asarray(cand, dtype=np.int64)
            ids[i, 0], sims[i, 0] = self._best(self.store[cand], cand,
                                               sigs_np[i])
        return ids, sims

    def _bucket_new(self, rows, new_idx) -> None:
        for r in rows:
            for k in self.keys[r]:
                self.buckets[int(k)].append(int(r))


@register("dpk")
def _make_dpk(cfg: FoldConfig | None = None, rebuild: bool = True,
              device: str | torch.device | None = None) -> DPKBackend:
    return DPKBackend(cfg or FoldConfig(), rebuild=rebuild, device=device)


@register("flat_lsh")
def _make_flat(cfg: FoldConfig | None = None, topk: int = 4,
               device: str | torch.device | None = None) -> FlatLSHBackend:
    return FlatLSHBackend(cfg or FoldConfig(), topk=topk, device=device)
