"""One generic online-dedup pipeline over a registered backend (port of
`repro/index/pipeline.py`, the BATCH_FIRST admission loop).

Owns step ① signature generation, ② in-batch cleanup (greedy-leader sweep
over the backend's similarity matrix) and ④ the threshold filter, plus the
Fig. 7 per-stage timers; the backend contributes ③ search and ⑤ insert.
`process_batch` is the blocking composition: each stage ends in a device
synchronisation so its wall-clock time is the stage's own.
"""
from __future__ import annotations

import time
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.index.protocol import DedupBackend, SigBatch, StepResult

__all__ = ["DedupPipeline", "greedy_leader", "greedy_leader_split"]


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
    ge = (sim >= tau).cpu().numpy()
    elig = (np.ones(B, bool) if eligible is None
            else torch.as_tensor(eligible).cpu().numpy().astype(bool))
    keep = np.zeros(B, bool)
    hit = np.zeros(B, bool)
    for i in range(B):
        hit[i] = bool((ge[i, :i] & keep[:i]).any())
        keep[i] = elig[i] and not hit[i]
    dev = sim.device
    return torch.from_numpy(keep).to(dev), torch.from_numpy(hit).to(dev)


def greedy_leader(sim: torch.Tensor, tau: float,
                  eligible: Any = None) -> torch.Tensor:
    """Step ②: keep-mask for in-batch dedup."""
    return greedy_leader_split(sim, tau, eligible)[0]


def _ready(x: Any) -> None:
    """Wait for the device work behind a CUDA tensor; no-op otherwise."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


class DedupPipeline:
    """Host-side orchestration of online dedup over an evolving corpus."""

    def __init__(self, backend: DedupBackend):
        from repro_torch.core.hashing import hash_seeds
        if getattr(getattr(backend, "cfg", None), "exact_filter", False):
            raise NotImplementedError(
                "exact_filter (the content-hash front end) is not ported yet")
        self.backend = backend
        self.device = backend.device
        spec = backend.sig_spec
        self._spec = spec
        self._seeds = hash_seeds(spec.num_hashes, spec.seed, self.device)

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

    def stats_schema(self) -> tuple[str, ...]:
        return (("t_signature", "t_in_batch", "t_search", "t_insert",
                 "n_batch_drop", "n_index_drop", "n_insert", "n_overflow",
                 "count") + tuple(self.backend.stats_schema()))

    # -- step ① -------------------------------------------------------------
    def signatures(self, tokens: Any, lengths: Any) -> SigBatch:
        """shingle → MinHash → bitmap (+ popcounts) on the pipeline's
        device. tokens (B, L) uint32 ids, numpy or tensor."""
        # deferred: repro_torch.core.dedup imports this module
        from repro_torch.core.dedup import fold_signatures
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(
                np.ascontiguousarray(tokens, dtype=np.uint32).view(np.int32))
        lengths = torch.as_tensor(np.asarray(lengths, np.int32)
                                  if not isinstance(lengths, torch.Tensor)
                                  else lengths)
        sigs, bitmaps, pcs = fold_signatures(self._spec, self._seeds,
                                             tokens, lengths)
        return SigBatch(sigs=sigs, bitmaps=bitmaps, pcs=pcs)

    # -- steps ②-⑤ ----------------------------------------------------------
    def dedup_step(self, sig: SigBatch, valid: Any = None,
                   timers: dict[str, Any] | None = None) -> StepResult:
        """In-batch cleanup, index search, threshold filter, admit uniques.

        valid: optional (B,) bool — False rows are never admitted.
        timers: a dict makes every stage block and record its wall-clock
        time under t_in_batch / t_search / t_insert."""
        return self._step_batch_first(sig, valid, timers)

    def _step_batch_first(self, sig: SigBatch, valid: Any,
                          timers: dict[str, Any] | None) -> StepResult:
        be = self.backend
        block = timers is not None

        t0 = time.perf_counter()
        keep_in_batch = greedy_leader(be.batch_sim(sig), be.tau_batch)
        if block:
            _ready(keep_in_batch)
            timers["t_in_batch"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        ids, sims = be.search(sig)
        dup_index = (sims >= be.tau_index).any(-1)
        if block:
            _ready(dup_index)
            timers["t_search"] = time.perf_counter() - t0

        keep = keep_in_batch & ~dup_index
        if valid is not None:
            keep = keep & torch.as_tensor(valid, device=keep.device)

        t0 = time.perf_counter()
        handle = be.insert(sig, keep, search_ids=ids)
        if block:
            _ready(handle)
            timers["t_insert"] = time.perf_counter() - t0
        return StepResult(keep=keep, keep_in_batch=keep_in_batch,
                          ids=ids, sims=sims)

    def process_batch(self, tokens: Any,
                      lengths: Any) -> tuple[np.ndarray, dict]:
        """Dedup one incoming batch. Returns (keep_mask (B,) numpy, stats)
        with per-stage times and admit/drop accounting."""
        stats: dict[str, Any] = {}
        count0 = self.backend.inserted

        t0 = time.perf_counter()
        sig = self.signatures(tokens, lengths)
        _ready(sig.pcs)
        stats["t_signature"] = time.perf_counter() - t0

        res = self.dedup_step(sig, timers=stats)

        keep = res.keep.cpu().numpy()
        keep_in_batch = res.keep_in_batch.cpu().numpy()
        stats["n_batch_drop"] = int((~keep_in_batch).sum())
        stats["n_index_drop"] = int((keep_in_batch & ~keep).sum())
        stats["n_insert"] = int(keep.sum())
        stats["count"] = self.backend.inserted
        # rows whose verdict claims admission but which the backend did not
        # land; the built-in backend refuses such a batch, so this stays 0
        stats["n_overflow"] = max(
            0, stats["n_insert"] - (stats["count"] - count0))
        return keep, stats
