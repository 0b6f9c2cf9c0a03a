"""FAISS (Jaccard) / FAISS (Hamming) analogues: HNSW over *raw* MinHash
signatures with the naive metric (paper §3.2); a wrapper over
`make_pipeline("hnsw_raw", ...)` (port of `repro/baselines/hnsw_raw.py`).
Identical index machinery to FOLD — only the vertex representation and
distance change, isolating the contribution of the bitmap representation
as the paper's FAISS baselines do."""
from __future__ import annotations

import torch

from repro_torch.core.dedup import FoldConfig
from repro_torch.index import DedupPipeline, make_pipeline

__all__ = ["RawHNSWPipeline"]


def RawHNSWPipeline(metric: str = "minhash_jaccard", num_hashes: int = 112,
                    shingle_n: int = 5, tau: float = 0.7, k: int = 4,
                    capacity: int = 65536, M: int = 16, M0: int = 32,
                    ef_construction: int = 64, ef_search: int = 64,
                    max_level: int = 4, seed: int = 0,
                    device: str | torch.device | None = None
                    ) -> DedupPipeline:
    cfg = FoldConfig(num_hashes=num_hashes, shingle_n=shingle_n, tau=tau,
                     k=k, capacity=capacity, M=M, M0=M0,
                     ef_construction=ef_construction, ef_search=ef_search,
                     max_level=max_level, seed=seed)
    return make_pipeline("hnsw_raw", cfg=cfg, metric=metric,
                         device=device)  # foldlint: disable=F131 (the port's factories add device)
