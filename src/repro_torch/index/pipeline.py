"""One generic online-dedup pipeline over a registered backend (port of
`repro/index/pipeline.py`).

Owns step ① signature generation (what the backend's SigSpec asks for:
MinHash lanes, bitmaps, or raw shingles with no MinHash at all), ② in-batch
cleanup (greedy-leader sweep over the backend's similarity matrix, or the
backend's own `in_batch_keep`) and ④ the threshold filter, in the
backend's admission order (BATCH_FIRST, or INDEX_FIRST for the join-style
prefix filter), plus the Fig. 7 per-stage timers, the exact-duplicate
front door (`FoldConfig.exact_filter`) and the read-only `query`; the
backend contributes ③ search and ⑤ insert and the capacity, snapshot and
deletion lifecycle, which the pipeline delegates. `process_batch` is the
blocking composition: each stage ends in a device synchronisation so its
wall-clock time is the stage's own. Its stats are the open record of
`repro_torch.spans` while it runs: the stages are spans, and the card
syncs under each are counted (stats["spans"]).

Host-side and device results. The device backends (`hnsw`, `hnsw_raw`,
`brute`) return tensors from `search`; the host-side ones (`dpk`,
`flat_lsh`, `prefix_filter`) return numpy arrays, as in the reference.
Whatever `search` returns, the masks built from it (and handed to
`insert`, and returned in the StepResult) live on the same side
(`_beside`); `host` brings any of them to numpy.

A backend whose whole ②-⑤ step is one call (`hnsw_sharded`) implements
the protocol's `fused_step` hook, and `dedup_step` routes to it.
"""
from __future__ import annotations

import inspect
import time
from typing import TYPE_CHECKING, Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.index.protocol import (BATCH_FIRST, INDEX_FIRST, DedupBackend,
                                        SigBatch, StepResult)

if TYPE_CHECKING:
    from repro_torch.index.exact import ExactDupFilter

__all__ = ["DedupPipeline", "QueryResult", "greedy_leader",
           "greedy_leader_split", "host"]


class QueryResult(NamedTuple):
    """Read-only search verdicts (DedupPipeline.query — nothing inserted),
    as host numpy arrays.

    is_dup (B,) bool; ids (B, k) int32 (-1 = none; column 0 is the
    exact-match ref id for exact_hit rows); sims (B, k) f32 (1.0 in column
    0 for exact hits); exact_hit (B,) bool."""
    is_dup: Any
    ids: Any
    sims: Any
    exact_hit: Any


def greedy_leader_split(sim: torch.Tensor, tau: float,
                        eligible: Any = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential greedy-leader over a (B, B) similarity matrix.

    keep[i] = eligible[i] and no kept j < i has sim[i, j] >= tau;
    hit[i] = some kept j < i has sim[i, j] >= tau. The sweep is
    order-dependent, so it stays a sequential loop over rows — on the host,
    over one copy of the (B, B) `sim >= tau` mask (tau is compared in
    float32, as the reference's weakly typed threshold is)."""
    B = sim.shape[0]
    ge = spans.to_host(sim >= tau)
    elig = (np.ones(B, bool) if eligible is None
            else host(eligible).astype(bool))
    keep = np.zeros(B, bool)
    hit = np.zeros(B, bool)
    for i in range(B):
        hit[i] = bool((ge[i, :i] & keep[:i]).any())
        keep[i] = elig[i] and not hit[i]
    dev = sim.device
    return spans.upload(keep, dev), spans.upload(hit, dev)


def greedy_leader(sim: torch.Tensor, tau: float,
                  eligible: Any = None) -> torch.Tensor:
    """Step ②: keep-mask for in-batch dedup."""
    return greedy_leader_split(sim, tau, eligible)[0]


def host(x: Any) -> np.ndarray:
    """A step's array on the host: a tensor is copied back (a counted
    sync), a numpy array (a host-side backend's result) passes through."""
    return spans.to_host(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _beside(mask: Any, ref: Any) -> Any:
    """`mask` on the side `ref` (a search result) lives: numpy when ref is
    numpy (a host-side backend), else a tensor on ref's device."""
    if isinstance(ref, np.ndarray):
        return host(mask)
    return spans.to_device(mask, ref.device)


class DedupPipeline:
    """Host-side orchestration of online dedup over an evolving corpus."""

    def __init__(self, backend: DedupBackend):
        from repro_torch.core.hashing import hash_seeds
        self.backend = backend
        self.device = backend.device
        spec = backend.sig_spec
        self._spec = spec
        self._seeds = (hash_seeds(spec.num_hashes, spec.seed, self.device)
                       if ({"sigs", "bitmaps"} & spec.needs) else None)
        # step ③'s neighbor ids reach only an insert that declares
        # `search_ids` (the protocol's advisory search-reuse parameter)
        self._insert_takes_search_ids = (
            "search_ids" in inspect.signature(backend.insert).parameters)
        # the exact-duplicate front door, opt-in through the shared config
        self.exact: "Optional[ExactDupFilter]" = None
        if getattr(getattr(backend, "cfg", None), "exact_filter", False):
            from repro_torch.index.exact import ExactDupFilter
            self.exact = ExactDupFilter()

    # -- lifecycle (delegated) ----------------------------------------------
    @property
    def capacity(self) -> int:
        return self.backend.capacity

    @property
    def inserted(self) -> int:
        return self.backend.inserted

    def grow(self, new_capacity: int) -> "DedupPipeline":
        self.backend.grow(new_capacity)
        return self

    # deletion lifecycle (the protocol's DELETION CONTRACT; backends with
    # supports_deletion=False raise from delete)
    @property
    def deleted(self) -> int:
        return self.backend.deleted

    @property
    def dead_fraction(self) -> float:
        return self.backend.dead_fraction

    def delete(self, ids: Any) -> int:
        return self.backend.delete(ids)

    def compact(self) -> dict:
        return self.backend.compact()

    def save(self, ckpt_dir: str, step: int,
             async_write: bool = False) -> None:
        self.backend.save(ckpt_dir, step, async_write=async_write)
        if self.exact is not None:
            # host-cheap and loss-safe: written synchronously even when the
            # backend's arrays go out asynchronously
            self.exact.save(ckpt_dir, step)

    def restore(self, ckpt_dir: str, step: int | None = None) -> int:
        step = self.backend.restore(ckpt_dir, step)
        if self.exact is not None:
            self.exact.load(ckpt_dir, step)
        return step

    def stats_schema(self) -> tuple[str, ...]:
        extra = ("n_exact_hits",) if self.exact is not None else ()
        return (("t_signature", "t_in_batch", "t_search", "t_insert",
                 "n_batch_drop", "n_index_drop", "n_insert", "n_overflow",
                 "count") + extra + tuple(self.backend.stats_schema()))

    # -- step ① -------------------------------------------------------------
    def signatures(self, tokens: Any, lengths: Any) -> SigBatch:
        """shingle → (MinHash → bitmap + popcounts) per the backend's
        SigSpec, on the pipeline's device; a spec that needs neither sigs
        nor bitmaps computes no MinHash. tokens (B, L) uint32 ids, numpy
        or tensor."""
        from repro_torch.core import bitmap as bm
        from repro_torch.core.shingle import shingle_hashes, token_tensors
        from repro_torch.kernels import ops
        spec = self._spec
        # host documents go up to the device (a counted sync each)
        tokens, lengths = (
            spans.upload(t, self.device) if t.device.type == "cpu"
            else t.to(self.device) for t in token_tensors(tokens, lengths))
        sh = shingle_hashes(tokens, lengths, spec.shingle_n)
        sigs = bitmaps = pcs = None
        if self._seeds is not None:
            sigs = ops.minhash(sh, self._seeds, use_kernel=spec.use_kernel)
        if "bitmaps" in spec.needs:
            bitmaps = bm.pack_bitmaps(sigs, T=spec.T)
            pcs = bm.popcount(bitmaps)
        return SigBatch(sigs=sigs, bitmaps=bitmaps, pcs=pcs,
                        shingles=sh if "shingles" in spec.needs else None)

    def _insert(self, sig: SigBatch, keep: Any, search_ids: Any) -> Any:
        """Step ⑤, with the search-reuse ids where insert declares them."""
        if self._insert_takes_search_ids:
            return self.backend.insert(sig, keep, search_ids=search_ids)
        return self.backend.insert(sig, keep)

    # -- steps ②-⑤ ----------------------------------------------------------
    def dedup_step(self, sig: SigBatch, valid: Any = None,
                   timers: dict[str, Any] | None = None) -> StepResult:
        """In-batch cleanup, index search, threshold filter, admit uniques,
        in the backend's order.

        valid: optional (B,) bool — False rows are never admitted.
        timers: a dict makes every stage block and record its wall-clock
        time under t_in_batch / t_search / t_insert, and is the open
        record of `repro_torch.spans` for the step (its spans and card
        syncs under timers["spans"]); a fused backend's step is timed
        whole, under t_fused_step (the three split stages then read 0)."""
        fused = getattr(self.backend, "fused_step", None)
        if fused is not None:
            if timers is None:
                return fused(sig, valid=valid)
            timers.setdefault("t_in_batch", 0.0)
            timers.setdefault("t_search", 0.0)
            timers.setdefault("t_insert", 0.0)
            t0 = time.perf_counter()
            res = fused(sig, valid=valid)
            spans.ready(res.keep)
            timers["t_fused_step"] = time.perf_counter() - t0
            return res
        order = self.backend.order
        with spans.span("step", record=timers):
            if order == BATCH_FIRST:
                return self._step_batch_first(sig, valid)
            if order == INDEX_FIRST:
                return self._step_index_first(sig, valid)
        raise ValueError(f"unknown admission order {order!r}")

    # The split stages. Each is a span that, under an open record (a
    # `timers` dict), ends in a device sync and records its seconds under
    # its t_* key.
    def _step_batch_first(self, sig: SigBatch, valid: Any) -> StepResult:
        be = self.backend

        with spans.span("in_batch", "t_in_batch") as sp:
            keep_in_batch = greedy_leader(be.batch_sim(sig), be.tau_batch)
            sp.ready(keep_in_batch)

        with spans.span("search", "t_search") as sp:
            ids, sims = be.search(sig)
            dup_index = (sims >= be.tau_index).any(-1)
            sp.ready(dup_index)

        keep_in_batch = _beside(keep_in_batch, sims)
        keep = keep_in_batch & ~dup_index
        if valid is not None:
            keep = keep & _beside(valid, sims)

        with spans.span("insert", "t_insert") as sp:
            sp.ready(self._insert(sig, keep, ids))
        return StepResult(keep=keep, keep_in_batch=keep_in_batch,
                          ids=ids, sims=sims)

    def _step_index_first(self, sig: SigBatch, valid: Any) -> StepResult:
        """Join-style admission: corpus duplicates are excluded BEFORE the
        in-batch sweep, so an index duplicate never suppresses a later
        in-batch near-duplicate. The sweep is the backend's own
        `in_batch_keep` when it has one."""
        be = self.backend

        with spans.span("search", "t_search"):
            ids, sims = be.search(sig)
            dup_index = host((sims >= be.tau_index).any(-1))

        eligible = ~dup_index
        if valid is not None:
            eligible = eligible & host(valid)

        with spans.span("in_batch", "t_in_batch") as sp:
            if hasattr(be, "in_batch_keep"):
                keep, hit = be.in_batch_keep(sig, eligible)
            else:
                keep, hit = greedy_leader_split(be.batch_sim(sig),
                                                be.tau_batch, eligible)
            keep, hit = _beside(keep, sims), _beside(hit, sims)
            sp.ready(keep)

        with spans.span("insert", "t_insert") as sp:
            sp.ready(self._insert(sig, keep, ids))
        return StepResult(keep=keep, keep_in_batch=~hit, ids=ids, sims=sims)

    def _exact_hits(self, tokens: Any, lengths: Any
                    ) -> Tuple[list, np.ndarray, np.ndarray]:
        """(hashes, hit, refs) for the exact front door: hit marks rows
        whose content hash is already in the filter OR appeared earlier in
        this batch (same tokens, same signature, same eventual verdict)."""
        from repro_torch.index.exact import batch_hashes
        assert self.exact is not None
        hashes = batch_hashes(tokens, lengths)
        B = len(hashes)
        hit = np.zeros(B, bool)
        refs = np.full(B, -1, np.int64)
        seen: set[int] = set()
        for i, h in enumerate(hashes):
            r = self.exact.lookup(h)
            if r is not None:
                hit[i] = True
                refs[i] = r
            elif h in seen:
                hit[i] = True
            else:
                seen.add(h)
        return hashes, hit, refs

    def process_batch(self, tokens: Any,
                      lengths: Any) -> tuple[np.ndarray, dict]:
        """Dedup one incoming batch. Returns (keep_mask (B,) numpy, stats)
        with per-stage times and admit/drop accounting. With the exact
        front door on, content-hash hits are never admitted and are not
        counted as batch or index drops; an all-hit batch pays no device
        work at all."""
        stats: dict[str, Any] = {}
        # the fused route is timed whole and keeps the reference's keys
        split = getattr(self.backend, "fused_step", None) is None
        with spans.span("batch", record=stats, attach=split):
            keep = self._process(tokens, lengths, stats)
        if split:
            spans.finished(stats)
        return keep, stats

    def _process(self, tokens: Any, lengths: Any,
                 stats: dict[str, Any]) -> np.ndarray:
        count0 = self.backend.inserted

        hashes = None
        B = tokens.shape[0]
        hit = np.zeros(B, bool)
        if self.exact is not None:
            hashes, hit, _refs = self._exact_hits(tokens, lengths)
            n_hit = int(hit.sum())
            if n_hit:
                self.exact.record_hit(n_hit)
            stats["n_exact_hits"] = n_hit
            if hit.all():
                # verbatim-replay fast path: no signatures, no search
                for key in ("t_signature", "t_in_batch", "t_search",
                            "t_insert"):
                    stats[key] = 0.0
                stats.update(n_batch_drop=0, n_index_drop=0, n_insert=0,
                             count=count0, n_overflow=0)
                return np.zeros(B, bool)

        with spans.span("signature", "t_signature") as sp:
            sig = self.signatures(tokens, lengths)
            sp.ready(next(a for a in reversed(sig) if a is not None))

        valid = ~hit if hit.any() else None
        res = self.dedup_step(sig, valid=valid, timers=stats)

        keep = host(res.keep)
        keep_in_batch = host(res.keep_in_batch)
        if hashes is not None:
            for i in np.flatnonzero(keep):
                self.exact.add(hashes[int(i)])
        stats["n_batch_drop"] = int((~keep_in_batch & ~hit).sum())
        stats["n_index_drop"] = int((keep_in_batch & ~keep & ~hit).sum())
        stats["n_insert"] = int(keep.sum())
        stats["count"] = self.backend.inserted
        # rows whose verdict claims admission but which the backend did not
        # land; the built-in backends refuse such a batch, so this stays 0
        stats["n_overflow"] = max(
            0, stats["n_insert"] - (stats["count"] - count0))
        return keep

    # -- read-only query ----------------------------------------------------
    def query(self, tokens: Any, lengths: Any = None) -> QueryResult:
        """Search-only "is this a dup?" verdicts; NOTHING is inserted.
        Exact front-door hits skip the search; other rows pay step ① and
        step ③ against the current corpus and the tau_index threshold."""
        B = tokens.shape[0]
        if lengths is None:
            lengths = np.full(B, tokens.shape[1], np.int32)
        hit = np.zeros(B, bool)
        refs = np.full(B, -1, np.int64)
        if self.exact is not None:
            _hashes, hit, refs = self._exact_hits(tokens, lengths)
            if hit.any():
                self.exact.record_hit(int(hit.sum()))
        k = max(1, int(getattr(getattr(self.backend, "cfg", None),
                               "k", 1) or 1))
        if B and hit.all():
            ids = np.full((B, k), -1, np.int32)
            ids[:, 0] = refs.astype(np.int32)
            sims = np.zeros((B, k), np.float32)
            sims[:, 0] = 1.0
            return QueryResult(is_dup=np.ones(B, bool), ids=ids, sims=sims,
                               exact_hit=hit)
        sig = self.signatures(tokens, lengths)
        ids_t, sims_t = self.backend.search(sig)
        ids = host(ids_t).astype(np.int32)
        sims = host(sims_t).astype(np.float32)
        is_dup = (sims >= np.float32(self.backend.tau_index)).any(axis=-1)
        if hit.any():
            is_dup = is_dup | hit
            ids[hit, 0] = refs[hit].astype(np.int32)
            sims[hit, 0] = 1.0
        return QueryResult(is_dup=is_dup, ids=ids, sims=sims, exact_hit=hit)
