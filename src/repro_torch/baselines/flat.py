"""Milvus MINHASH_LSH analogue: flat bucketed retrieval with a topK budget;
a wrapper over `make_pipeline("flat_lsh", ...)` (port of
`repro/baselines/flat.py`)."""
from __future__ import annotations

import torch

from repro_torch.core.dedup import FoldConfig
from repro_torch.index import DedupPipeline, make_pipeline

__all__ = ["FlatLSHPipeline"]


def FlatLSHPipeline(num_hashes: int = 112, shingle_n: int = 5,
                    tau: float = 0.7, topk: int = 4, capacity: int = 1 << 20,
                    seed: int = 0,
                    device: str | torch.device | None = None
                    ) -> DedupPipeline:
    cfg = FoldConfig(num_hashes=num_hashes, shingle_n=shingle_n, tau=tau,
                     capacity=capacity, seed=seed)
    return make_pipeline("flat_lsh", cfg=cfg, topk=topk,
                         device=device)  # foldlint: disable=F131 (the port's factories add device)
