"""Assigned input shapes (4 per LM architecture) and applicability rules."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import ALIASES, LONG_CONTEXT_ARCHS

__all__ = ["Shape", "SHAPES", "cells_for", "all_cells"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # train | prefill | decode
    seq: int           # sequence length (train/prefill) or KV-cache length
    batch: int         # global batch


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def cells_for(arch: str) -> list[str]:
    """Applicable shape names for an arch (DESIGN.md §5 skip rules)."""
    mod = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if mod in LONG_CONTEXT_ARCHS:
        shapes.append("long_500k")
    return shapes


def all_cells() -> list[tuple[str, str]]:
    from repro_torch.configs import ARCHS
    return [(a, s) for a in ARCHS for s in cells_for(a)]
