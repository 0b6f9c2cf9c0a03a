"""Prefix-filter set-similarity join (paper baseline; Xiao et al., Vernica
et al.); a wrapper over `make_pipeline("prefix_filter", ...)`, driven by
the generic DedupPipeline in the join-style INDEX_FIRST order (port of
`repro/baselines/prefix_filter.py`)."""
from __future__ import annotations

import torch

from repro_torch.core.dedup import FoldConfig
from repro_torch.index import DedupPipeline, make_pipeline

__all__ = ["PrefixFilterPipeline"]


def PrefixFilterPipeline(shingle_n: int = 5, tau: float = 0.7,
                         seed: int = 0,
                         device: str | torch.device | None = None
                         ) -> DedupPipeline:
    cfg = FoldConfig(shingle_n=shingle_n, tau=tau, seed=seed)
    return make_pipeline("prefix_filter", cfg=cfg,
                         device=device)  # foldlint: disable=F131 (the port's factories add device)
