"""Index-sharded FOLD: N independent HNSW sub-graphs behind one step (port
of `repro/core/sharded.py`).

The index is split into `nshards` sub-graphs, each over 1/N of the
admitted corpus. Per incoming batch:

  1. every shard sees the whole query batch (the reference all-gathers
     the per-device query shards; here the shards share one device, so
     the batch is simply passed to each);
  2. every shard searches its sub-graph for ALL queries;
  3. the per-query results are merged across shards: the admission
     filter needs only each query's best similarity over all shards (the
     reference's `pmax`), and the read-only search merges the per-shard
     top-k into one global top-k;
  4. documents that survive the threshold go to shard `row % nshards`
     (round-robin over their batch index) and are inserted there.

Recall: searching N sub-graphs of size C/N and merging is at least as
accurate as one size-C graph searched with the same ef (each sub-search
explores ef nodes of a smaller graph), so sharding adds recall rather
than trading it.

Representation. The shards are a list of N per-shard `HNSWState`s, each
the port's core/hnsw.py state, all on one device (the reference's CI runs
its shards on virtual devices of one host). `stack_states` /
`unstack_states` convert to and from the reference's stacked layout (a
leading shard axis on every field) for checkpoints. The reference's
`sharded_state_specs` and its shard_map constructor have no counterpart:
a `device` argument takes their place. Global slot ids are
`local * nshards + shard`.

Ties follow the reference: the merge of `make_sharded_search` is a
stable descending sort over the shard-major concatenation (`lax.top_k`
keeps the lower index first on ties), and never `torch.topk`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitmap import chunked_pairwise_bitmap_jaccard
from repro_torch.core.hnsw import (HNSWConfig, HNSWState, hnsw_compact,
                                   hnsw_delete, hnsw_grow, hnsw_init,
                                   hnsw_insert_batch, hnsw_search,
                                   state_from_numpy, state_to_numpy)
from repro_torch.index.pipeline import greedy_leader

__all__ = ["sharded_init", "make_sharded_dedup_step", "sharded_grow",
           "make_sharded_delete", "make_sharded_compact",
           "make_sharded_search", "stack_states", "unstack_states"]

_INF = float("inf")


def sharded_init(cfg: HNSWConfig, nshards: int,
                 device: str | torch.device | None = None
                 ) -> list[HNSWState]:
    """N empty per-shard states on one device (None means cuda)."""
    return [hnsw_init(cfg, device) for _ in range(nshards)]


def stack_states(states: list[HNSWState]) -> HNSWState:
    """The reference's stacked layout: every field as a host numpy array
    with a leading shard axis (vectors as uint32)."""
    per = [state_to_numpy(st) for st in states]
    return HNSWState(*(np.stack([p[f] for p in per])
                       for f in HNSWState._fields))


def unstack_states(stacked: HNSWState, device: str | torch.device | None = None
                   ) -> list[HNSWState]:
    """Per-shard states on `device` from a stacked (numpy) HNSWState."""
    n = np.shape(stacked.count)[0]
    return [state_from_numpy({f: np.asarray(getattr(stacked, f))[s]
                              for f in HNSWState._fields}, device)
            for s in range(n)]


def sharded_grow(cfg: HNSWConfig, states: list[HNSWState], new_capacity: int
                 ) -> tuple[HNSWConfig, list[HNSWState]]:
    """Re-pad every shard to a larger PER-SHARD capacity; each sub-graph is
    kept exactly and the per-shard scalars are untouched."""
    if new_capacity < cfg.capacity:
        raise ValueError(f"cannot shrink: {new_capacity} < {cfg.capacity}")
    if new_capacity == cfg.capacity:
        return cfg, states
    grown = [hnsw_grow(cfg, st, new_capacity)[1] for st in states]
    return cfg._replace(capacity=new_capacity), grown


def make_sharded_delete(cfg: HNSWConfig):
    """Returns `delete(states, ids) -> (states, n_newly_dead)`.

    ids (nshards, D) int32, -1 padded: LOCAL per-shard slot ids, row s for
    shard s (hnsw_delete semantics: out-of-range, unused and already-dead
    ids are ignored). n_newly_dead is per shard, (nshards,)."""
    def delete(states, ids):
        out, ns = [], []
        for s, st in enumerate(states):
            st, n = hnsw_delete(cfg, st, ids[s])
            out.append(st)
            ns.append(n)
        return out, torch.stack(ns)
    return delete


def make_sharded_compact(cfg: HNSWConfig):
    """Returns `compact(states) -> (states, n_reclaimed)`: core.hnsw's
    online compaction on every sub-graph independently (shards never
    reference each other's slots). n_reclaimed is per shard, (nshards,)."""
    def compact(states):
        out, ns = [], []
        for st in states:
            st, n = hnsw_compact(cfg, st)
            out.append(st)
            ns.append(n)
        return out, torch.stack(ns)
    return compact


def make_sharded_search(cfg: HNSWConfig, nshards: int, *, k: int = 4,
                        query_chunk: int | None = None):
    """Returns read-only `search(states, bitmaps, pcs) -> (ids, sims)`:
    every shard searches its sub-graph for all queries and the per-shard
    top-k are merged into one global top-k, ids as GLOBAL interleaved slot
    ids (local * nshards + shard), -1 where the merged similarity is not
    finite. bitmaps (B, W); outputs (B, k)."""
    def search(states, bitmaps, pcs):
        B = bitmaps.shape[0]
        all_ids, all_sims = [], []
        for s, st in enumerate(states):
            ids, sims = hnsw_search(cfg, st, bitmaps, k=k,
                                    query_chunk=query_chunk)
            found = ids >= 0
            all_ids.append(torch.where(found, ids * nshards + s,
                                       torch.full_like(ids, -1)))
            all_sims.append(torch.where(found, sims,
                                        torch.full_like(sims, -_INF)))
        # (B, nshards * k), shard-major within each query's row
        cat_ids = torch.stack(all_ids, 1).reshape(B, -1)
        cat_sims = torch.stack(all_sims, 1).reshape(B, -1)
        top, ix = torch.sort(cat_sims, dim=1, descending=True, stable=True)
        top, ix = top[:, :k], ix[:, :k]
        mids = torch.gather(cat_ids, 1, ix)
        return torch.where(torch.isfinite(top), mids,
                           torch.full_like(mids, -1)), top
    return search


def make_sharded_dedup_step(cfg: HNSWConfig, nshards: int, *, tau: float,
                            k: int = 4, query_chunk: int | None = None,
                            sub_batches: int = 1, masked: bool = False,
                            reuse_search: bool = True,
                            free_slots: bool = False):
    """Returns `step(states, bitmaps, pcs, levels) -> (states, keep)`.

    bitmaps (B, W), pcs (B,), levels (B,) on the states' device; keep (B,)
    bool. Every shard's search runs before any shard's insert.

    sub_batches > 1 (and dividing B) splits the batch into sequential
    slices (the paper's Fig. 9 protocol): slice j is deduped against the
    index that already holds slices < j, and row r of a slice goes to
    shard r % nshards. query_chunk bounds the batched search's working set
    (None defers to hnsw_search's resolution, 0 disables chunking).

    masked=True adds an argument `valid (B,) bool`: False rows are shape
    padding, never admitted, keep False; the step then returns (states,
    keep, keep_in) with keep_in the in-batch survivors.

    reuse_search=True seeds each shard's batched insert with the ids its
    own step-③ search just retrieved (only with cfg.batched_insert).

    free_slots=True adds a trailing argument `frees (nshards, F) int32`
    (-1 padded): row s holds shard s's reclaimed LOCAL slot ids, consumed
    before fresh capacity. Incompatible with sub_batches > 1 (each slice
    would re-consume the same frees).

    The in-batch matrix is the plain block-chunked pairwise bitmap-Jaccard
    (core/bitmap.py), as in the reference, not kernel K2."""
    if free_slots and sub_batches > 1:
        raise ValueError("free_slots is incompatible with sub_batches > 1")

    def one_sub(states, q, pc, lv, va, fs=None):
        B = q.shape[0]
        # (2) in-batch dedup
        sim_in = chunked_pairwise_bitmap_jaccard(q, q, pc, pc)
        keep_in = greedy_leader(sim_in, tau)
        # (3) every shard's sub-graph search for all queries
        found = [hnsw_search(cfg, st, q, k=k, query_chunk=query_chunk)
                 for st in states]
        # (4) the best similarity over all shards is all the filter needs
        best = torch.stack([
            torch.where(ids >= 0, sims, torch.full_like(sims, -_INF)
                        ).max(-1).values for ids, sims in found]).max(0).values
        keep = keep_in & (best < tau)
        if va is not None:
            keep = keep & va
        # (5) round-robin shard assignment of the admitted rows
        shard_of = torch.arange(B, device=q.device) % nshards
        reuse = reuse_search and cfg.batched_insert
        out = [hnsw_insert_batch(cfg, st, q, pc, lv, keep & (shard_of == s),
                                 seed_ids=ids if reuse else None,
                                 free_slots=None if fs is None else fs[s])[0]
               for s, (st, (ids, _)) in enumerate(zip(states, found))]
        return out, keep, keep_in

    def step(states, bitmaps, pcs, levels, *rest):
        if len(states) != nshards:
            raise ValueError(f"{len(states)} states for {nshards} shards")
        valid = rest[0] if masked else None
        frees = rest[-1] if free_slots else None
        B = bitmaps.shape[0]
        if sub_batches > 1 and B % sub_batches == 0:
            sb = B // sub_batches
            keeps, keep_ins = [], []
            for j in range(sub_batches):   # sequential: slice j sees j' < j
                sl = slice(j * sb, (j + 1) * sb)
                states, kj, kij = one_sub(
                    states, bitmaps[sl], pcs[sl], levels[sl],
                    valid[sl] if valid is not None else None)
                keeps.append(kj)
                keep_ins.append(kij)
            keep = torch.cat(keeps)
            keep_in = torch.cat(keep_ins)
        else:
            states, keep, keep_in = one_sub(states, bitmaps, pcs, levels,
                                            valid, frees)
        if masked:
            return states, keep, keep_in
        return states, keep

    return step
