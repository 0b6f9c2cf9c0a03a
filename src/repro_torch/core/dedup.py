"""FOLD: the five-step online fuzzy-deduplication workflow (port of
`repro/core/dedup.py`).

  ① signature generation   shingle → MinHash (kernel K1) → bitmap
  ② in-batch cleanup        pairwise bitmap-Jaccard (kernel K2, or K3
                            with cached=False) + greedy-leader sweep
  ③ index search            HNSW top-k over the admitted corpus
  ④ threshold filter        drop if any neighbor similarity >= tau
  ⑤ admit uniques           batched insert of the survivors

`FoldPipeline` is the generic `DedupPipeline` over the bitmap-HNSW
backend. It runs on CUDA unless `device="cpu"` is passed.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core.hnsw import HNSWConfig
from repro_torch.core.shingle import shingle_hashes
from repro_torch.index.pipeline import DedupPipeline, greedy_leader
from repro_torch.index.protocol import SigSpec, StepResult
from repro_torch.kernels import ops

__all__ = ["FoldConfig", "FoldPipeline", "StepResult", "fold_signatures",
           "batch_jaccard", "in_batch_dedup", "bitmap_tau", "greedy_leader"]


@dataclasses.dataclass(frozen=True)
class FoldConfig:
    """The reference's pipeline config, field for field."""
    # signatures (paper defaults)
    num_hashes: int = 112
    shingle_n: int = 5
    T: int = 4096
    # dedup
    tau: float = 0.7
    threshold_space: str = "bitmap"      # "bitmap" (faithful) | "minhash"
    k: int = 4
    verify_minhash: bool = False
    # index
    capacity: int = 65536
    M: int = 16
    M0: int = 32
    ef_construction: int = 64
    ef_search: int = 64
    max_level: int = 4
    query_chunk: int | None = None
    batched_insert: bool = True
    reuse_search: bool = True
    exact_filter: bool = False
    # ablation arms (Fig. 8)
    use_kernel: bool = True              # 'SIMD' arm -> CUDA kernel path
    cached: bool = True                  # popcount-cache arm
    select_heuristic: bool = False
    seed: int = 0

    def hnsw(self) -> HNSWConfig:
        return HNSWConfig(capacity=self.capacity, words=self.T // 32,
                          M=self.M, M0=self.M0,
                          ef_construction=self.ef_construction,
                          ef_search=self.ef_search, max_level=self.max_level,
                          metric="bitmap_jaccard",
                          select_heuristic=self.select_heuristic,
                          query_chunk=self.query_chunk,
                          batched_insert=self.batched_insert)


def bitmap_tau(cfg: FoldConfig) -> float:
    """Threshold in bitmap-similarity space."""
    if cfg.threshold_space == "bitmap":
        return cfg.tau
    if cfg.threshold_space == "minhash":
        return cfg.tau / (2.0 - cfg.tau)
    raise ValueError(cfg.threshold_space)


def batch_jaccard(bitmaps: torch.Tensor, pcs: torch.Tensor,
                  use_kernel: bool = True, cached: bool = True) -> torch.Tensor:
    """Step ②'s (B, B) bitmap-Jaccard matrix: kernel K2, or K3 with
    cached=False (the popcounts are then recomputed, not read)."""
    p = pcs if cached else None
    return ops.bitmap_jaccard(bitmaps, bitmaps, p, p, cached=cached,
                              use_kernel=use_kernel)


def in_batch_dedup(bitmaps: torch.Tensor, pcs: torch.Tensor, tau: float,
                   use_kernel: bool = True, cached: bool = True) -> torch.Tensor:
    """Step ②: keep-mask for a batch of bitmap signatures."""
    return greedy_leader(batch_jaccard(bitmaps, pcs, use_kernel, cached), tau)


def fold_signatures(cfg: FoldConfig | SigSpec, seeds: torch.Tensor,
                    tokens: torch.Tensor, lengths: torch.Tensor,
                    with_bitmaps: bool = True):
    """Step ①, stateless, on the seeds' device: (sigs, bitmaps, pcs).
    Reads cfg.shingle_n, cfg.use_kernel and cfg.T, which a backend's
    SigSpec carries too (`DedupPipeline.signatures` passes one).
    with_bitmaps=False stops at the MinHash lanes (bitmaps, pcs = None), for
    backends whose SigSpec needs only "sigs"."""
    dev = seeds.device
    sh = shingle_hashes(tokens.to(dev), lengths.to(dev), cfg.shingle_n)
    sigs = ops.minhash(sh, seeds, use_kernel=cfg.use_kernel)
    if not with_bitmaps:
        return sigs, None, None
    bitmaps = bm.pack_bitmaps(sigs, T=cfg.T)
    return sigs, bitmaps, bm.popcount(bitmaps)


class FoldPipeline(DedupPipeline):
    """The FOLD workflow: DedupPipeline over the bitmap-HNSW backend."""

    def __init__(self, cfg: FoldConfig | None = None,
                 device: str | torch.device | None = None):
        from repro_torch.index.backends.hnsw import HNSWBitmapBackend
        super().__init__(HNSWBitmapBackend(cfg or FoldConfig(), device=device))

    @property
    def cfg(self) -> FoldConfig:
        return self.backend.cfg

    @property
    def hnsw_cfg(self) -> HNSWConfig:
        return self.backend.hnsw_cfg

    @property
    def state(self):
        return self.backend.state

    @property
    def tau_b(self) -> float:
        return self.backend.tau_b

    @property
    def seeds(self):
        return self._seeds
