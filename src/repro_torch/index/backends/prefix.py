"""Prefix-filter set-similarity join (paper baseline; Xiao et al., Vernica
et al.) behind the `repro_torch.index` protocol (port of
`repro/index/backends/prefix.py`).

Documents are 5-word shingle-hash *sets* (no MinHash sketching — the only
backend whose SigSpec requests raw shingles, so its pipeline runs no
MinHash kernel). Shingles are globally ordered by ascending frequency
("rare first"); a document with |s| shingles indexes its first
p = |s| - ceil(tau * |s|) + 1 prefix tokens. Two documents can only reach
Jaccard >= tau if their prefixes intersect, so candidates come from an
inverted index over prefix tokens, then exact set-Jaccard verifies. The
join is host-side Python by nature, in the reference and here; only the
shingling (step ①) runs on the backend's device.

Shingles reach the host as uint32 (`.view(np.uint32)` of the port's int32
bits), so the 0xFFFFFFFF padding is recognised and dropped and a shingle
>= 2**31 keeps its value, its frequency order and its snapshot bytes.

Join semantics are INDEX_FIRST: corpus duplicates are excluded *before* the
in-batch sweep, matching the sequential one-pass join of the original
baseline. `in_batch_keep` keeps the lazy pairwise comparisons of that pass
(float64 Jaccard against tau) instead of materializing a (B, B) matrix;
`search` and `batch_sim` store the float64 Jaccard into f32, as the
reference does.
"""
# foldlint: module-sync-ok(host-side backend: prefix-filter join over python sets/dicts by design)
from __future__ import annotations

import math
from collections import Counter, defaultdict

import numpy as np
import torch

from repro_torch.core.dedup import FoldConfig
from repro_torch.device import resolve_device
from repro_torch.index.protocol import (INDEX_FIRST, DedupBackend, SigBatch,
                                        SigSpec)
from repro_torch.index.registry import register

__all__ = ["PrefixFilterBackend"]

_PAD = 0xFFFFFFFF     # shingle_hashes padding sentinel


class PrefixFilterBackend(DedupBackend):
    name = "prefix_filter"
    order = INDEX_FIRST
    supports_growth = True
    supports_snapshots = True
    supports_deletion = False
    track_slots = False

    def __init__(self, cfg: FoldConfig,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.freq: Counter = Counter()
        self.sets: list[frozenset] = []
        self.prefixes: list[list[int]] = []     # as indexed at insert time
        self.inverted: dict[int, list[int]] = defaultdict(list)
        self._soft_capacity = cfg.capacity      # lists are unbounded; the
        self._batch_sets: list[frozenset] = []  # capacity is a policy knob

    @property
    def sig_spec(self) -> SigSpec:
        return SigSpec(shingle_n=self.cfg.shingle_n, seed=self.cfg.seed,
                       needs=frozenset({"shingles"}))

    @property
    def tau_batch(self) -> float:
        return self.cfg.tau

    @property
    def tau_index(self) -> float:
        return self.cfg.tau

    @property
    def capacity(self) -> int:
        return self._soft_capacity

    @property
    def inserted(self) -> int:
        return len(self.sets)

    # -- set machinery -------------------------------------------------------
    def _prefix(self, s: frozenset) -> list[int]:
        if not s:
            return []
        ordered = sorted(s, key=lambda t: (self.freq[t], t))
        p = len(s) - math.ceil(self.cfg.tau * len(s)) + 1
        return ordered[:max(p, 1)]

    @staticmethod
    def _jaccard(a: frozenset, b: frozenset) -> float:
        if not a and not b:
            return 1.0
        return len(a & b) / len(a | b)

    # -- protocol: steps ③ ② ⑤ (INDEX_FIRST order) ---------------------------
    def search(self, sig: SigBatch):
        sh = sig.shingles.cpu().numpy().view(np.uint32)
        sets = [frozenset(row[row != _PAD].tolist()) for row in sh]
        self._batch_sets = sets                 # reused by in_batch/insert
        B = len(sets)
        ids = np.full((B, 1), -1, np.int32)
        sims = np.full((B, 1), -np.inf, np.float32)
        for i, s in enumerate(sets):
            cand_ids: set[int] = set()
            for tok in self._prefix(s):
                cand_ids.update(self.inverted.get(tok, ()))
            for j in cand_ids:
                jac = self._jaccard(s, self.sets[j])
                if jac > sims[i, 0]:
                    ids[i, 0], sims[i, 0] = j, jac
        return ids, sims

    def batch_sim(self, sig: SigBatch):
        sets = self._batch_sets
        B = len(sets)
        sim = np.zeros((B, B), np.float32)
        for i in range(B):
            for j in range(i + 1):
                sim[i, j] = sim[j, i] = self._jaccard(sets[i], sets[j])
        return sim

    def in_batch_keep(self, sig: SigBatch, eligible):
        """Lazy sequential sweep: each doc is compared only against the
        already-kept leaders (the original join's inner loop)."""
        sets = self._batch_sets
        tau = self.cfg.tau
        B = len(sets)
        keep = np.zeros(B, bool)
        hit = np.zeros(B, bool)
        kept: list[int] = []
        for i, s in enumerate(sets):
            hit[i] = any(self._jaccard(s, sets[j]) >= tau for j in kept)
            if eligible[i] and not hit[i]:
                keep[i] = True
                kept.append(i)
        return keep, hit

    def insert(self, sig: SigBatch, keep, search_ids=None) -> None:
        for i in np.flatnonzero(np.asarray(keep)):
            s = self._batch_sets[i]
            self.freq.update(s)
            doc_id = len(self.sets)
            self.sets.append(s)
            pre = self._prefix(s)
            self.prefixes.append(pre)
            for tok in pre:
                self.inverted[tok].append(doc_id)
        self._batch_sets = []

    # -- protocol: lifecycle -------------------------------------------------
    def grow(self, new_capacity: int) -> None:
        self._soft_capacity = max(self._soft_capacity, new_capacity)

    def save(self, ckpt_dir: str, step: int, async_write: bool = False):
        """Ragged sets/prefixes flatten to (values, offsets) pairs; freq and
        the inverted index are derived state, rebuilt on restore."""
        from repro_torch.train import checkpoint as ckpt
        ordered = [sorted(s) for s in self.sets]
        tree = {
            "set_vals": np.asarray([x for s in ordered for x in s],
                                   np.uint32),
            "set_offs": np.cumsum([0] + [len(s) for s in ordered],
                                  dtype=np.int64),
            "pre_vals": np.asarray([x for p in self.prefixes for x in p],
                                   np.uint32),
            "pre_offs": np.cumsum([0] + [len(p) for p in self.prefixes],
                                  dtype=np.int64),
        }
        writer = ckpt.save_async if async_write else ckpt.save
        writer(ckpt_dir, step, tree,
               extra={"capacity": self._soft_capacity,
                      "n_docs": len(self.sets)})

    def restore(self, ckpt_dir: str, step: int | None = None) -> int:
        from repro_torch.train import checkpoint as ckpt
        step = ckpt.latest_step(ckpt_dir) if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint found in {ckpt_dir!r}")
        meta = ckpt.manifest(ckpt_dir, step)
        n = int(meta["n_docs"])
        got = ckpt.restore(ckpt_dir, step, {"set_vals": 0, "set_offs": 0,
                                            "pre_vals": 0, "pre_offs": 0})
        so, po = got["set_offs"], got["pre_offs"]
        self.sets = [frozenset(got["set_vals"][so[i]:so[i + 1]].tolist())
                     for i in range(n)]
        self.prefixes = [got["pre_vals"][po[i]:po[i + 1]].tolist()
                         for i in range(n)]
        self.freq = Counter()
        for s in self.sets:
            self.freq.update(s)
        self.inverted = defaultdict(list)
        for doc_id, pre in enumerate(self.prefixes):
            for tok in pre:
                self.inverted[tok].append(doc_id)
        self._soft_capacity = max(self._soft_capacity,
                                  int(meta.get("capacity", 0)))
        return step

    def stats_schema(self) -> tuple[str, ...]:
        return ("count", "capacity", "tokens_indexed")

    def stats(self) -> dict:
        return {"count": len(self.sets), "capacity": self._soft_capacity,
                "tokens_indexed": len(self.inverted)}


@register("prefix_filter")
def _make_prefix(cfg: FoldConfig | None = None,
                 device: str | torch.device | None = None
                 ) -> PrefixFilterBackend:
    return PrefixFilterBackend(cfg or FoldConfig(), device=device)
