"""DPK-style MinHash-LSH pipeline (paper §2.1, Fig 1; IBM Data Prep Kit);
a wrapper over `make_pipeline("dpk", ...)` (port of
`repro/baselines/dpk.py`)."""
from __future__ import annotations

import torch

from repro_torch.core.dedup import FoldConfig
from repro_torch.index import DedupPipeline, make_pipeline

__all__ = ["DPKPipeline"]


def DPKPipeline(num_hashes: int = 112, shingle_n: int = 5, tau: float = 0.7,
                capacity: int = 1 << 20, seed: int = 0,
                rebuild: bool = True,
                device: str | torch.device | None = None) -> DedupPipeline:
    cfg = FoldConfig(num_hashes=num_hashes, shingle_n=shingle_n, tau=tau,
                     capacity=capacity, seed=seed)
    return make_pipeline("dpk", cfg=cfg, rebuild=rebuild,
                         device=device)  # foldlint: disable=F131 (the port's factories add device)
