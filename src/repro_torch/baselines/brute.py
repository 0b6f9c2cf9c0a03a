"""Brute-force online admission — the exact reference (Table 1 ground
truth); a wrapper over `make_pipeline("brute", ...)` (port of
`repro/baselines/brute.py`)."""
from __future__ import annotations

import torch

from repro_torch.core.dedup import FoldConfig
from repro_torch.index import DedupPipeline, make_pipeline

__all__ = ["BruteForcePipeline"]


def BruteForcePipeline(num_hashes: int = 112, shingle_n: int = 5,
                       tau: float = 0.7, capacity: int = 1 << 20,
                       seed: int = 0,
                       device: str | torch.device | None = None
                       ) -> DedupPipeline:
    cfg = FoldConfig(num_hashes=num_hashes, shingle_n=shingle_n, tau=tau,
                     capacity=capacity, seed=seed)
    return make_pipeline("brute", cfg=cfg,
                         device=device)  # foldlint: disable=F131 (the port's factories add device)
