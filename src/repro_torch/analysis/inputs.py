"""Seeded inputs of the program specs: a small filled index per geometry.

The reference's specs are abstract (ShapeDtypeStructs). The port's
analyzer runs each program once, so a spec needs real tensors, and the
counts it records should be those of a real beam search, not of an empty
graph. For each (capacity, metric) this module fills an index ONCE per
process, on the CPU: an eighth of its capacity, from the signatures of
Common Crawl preset documents (`SyntheticCorpus`, seed 0), inserted in
batches of SPEC_BATCH by `hnsw_insert_batch`; the next batch is the query
batch, searched once for the insert's seed ids and keep mask. Makers clone
what they take onto the analyzer's device (`SpecIndex.on`), so a program
that updates its state in place never touches the cached index.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.hnsw import (HNSWConfig, HNSWState, hnsw_init,
                                   hnsw_insert_batch, hnsw_search,
                                   sample_levels)

__all__ = ["SPEC_BATCH", "SpecIndex", "spec_index", "spec_cfg"]

SPEC_BATCH = 128      # rows per fill batch and per query batch
SPEC_K = 4


class SpecIndex(NamedTuple):
    """A filled index on the CPU and one query batch against it."""
    cfg: HNSWConfig
    state: HNSWState
    n_docs: int            # the filled slots are 0 .. n_docs - 1
    queries: torch.Tensor  # (SPEC_BATCH, W) int32
    pcs: torch.Tensor      # (SPEC_BATCH,) int32 (zeros under a raw metric)
    levels: torch.Tensor   # (SPEC_BATCH,) int32, sample_levels
    seed_ids: torch.Tensor  # (SPEC_BATCH, SPEC_K) int32: the queries' search
    keep: torch.Tensor     # (SPEC_BATCH,) bool: best sim under the tau

    def on(self, device) -> "SpecIndex":
        """A copy of every tensor on `device` (fresh storage)."""
        return self._replace(
            state=HNSWState(*(t.to(device, copy=True) for t in self.state)),
            **{f: getattr(self, f).to(device, copy=True)
               for f in ("queries", "pcs", "levels", "seed_ids", "keep")})


def spec_cfg(capacity: int, metric: str = "bitmap_jaccard") -> HNSWConfig:
    """FoldConfig()'s HNSW geometry at `capacity`, under `metric` (a raw
    metric indexes the (H,) MinHash lanes, as the reference's spec does)."""
    from repro_torch.core.dedup import FoldConfig
    cfg = FoldConfig(capacity=capacity)
    hcfg = cfg.hnsw()
    if metric != "bitmap_jaccard":
        hcfg = hcfg._replace(metric=metric, words=cfg.num_hashes)
    return hcfg


@functools.lru_cache(maxsize=None)
def _corpus_signatures(n_batches: int) -> tuple:
    """((sigs, bitmaps, pcs), ...) of the first n_batches preset batches."""
    from repro_torch.core.dedup import FoldConfig, FoldPipeline
    from repro_torch.data.corpus import DATASET_PRESETS, SyntheticCorpus
    corpus = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    pipe = FoldPipeline(FoldConfig(), device="cpu")
    out = []
    for _ in range(n_batches):
        sig = pipe.signatures(*corpus.next_batch(SPEC_BATCH)[:2])
        out.append((sig.sigs, sig.bitmaps, sig.pcs))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def spec_index(capacity: int, metric: str = "bitmap_jaccard") -> SpecIndex:
    """The filled index of this geometry (built on first use; the cached
    tensors are shared, so callers take `.on(device)` copies)."""
    from repro_torch.core.dedup import FoldConfig, bitmap_tau
    cfg = spec_cfg(capacity, metric)
    n_fill = max(capacity // 8 // SPEC_BATCH, 1)
    batches = _corpus_signatures(n_fill + 1)

    def rows(b):
        sigs, bitmaps, pcs = b
        if metric == "bitmap_jaccard":
            return bitmaps, pcs
        return sigs, torch.zeros_like(pcs)

    state = hnsw_init(cfg, "cpu")
    keep_all = torch.ones(SPEC_BATCH, dtype=torch.bool)
    for i, b in enumerate(batches[:n_fill]):
        vecs, pcs = rows(b)
        levels = torch.from_numpy(sample_levels(SPEC_BATCH, cfg, seed=i + 1))
        state, _ = hnsw_insert_batch(cfg, state, vecs, pcs, levels, keep_all)
    queries, pcs = rows(batches[n_fill])
    ids, sims = hnsw_search(cfg, state, queries, k=SPEC_K)
    tau = bitmap_tau(FoldConfig())
    return SpecIndex(
        cfg=cfg, state=state, n_docs=n_fill * SPEC_BATCH, queries=queries,
        pcs=pcs,
        levels=torch.from_numpy(sample_levels(SPEC_BATCH, cfg,
                                              seed=n_fill + 1)),
        seed_ids=ids, keep=sims[:, 0] < tau)
