"""Shingling: documents -> overlapping n-gram hashes (port of
`repro/core/shingle.py`).

Shingle positions i >= len - n + 1 hold 0xFFFFFFFF so MinHash ignores
them; documents shorter than n contribute one whole-document shingle.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import UINT32_MAX_BITS, bits32, fmix32, mul32, u32

__all__ = ["shingle_hashes", "num_shingles", "token_tensors"]

_POLY = 0x01000193  # FNV prime


def num_shingles(lengths: torch.Tensor, n: int) -> torch.Tensor:
    """Valid shingles per document: max(len - n + 1, min(len, 1))."""
    lengths = lengths.to(torch.int32)
    return torch.where(lengths >= n, lengths - n + 1,
                       torch.clamp(lengths, max=1))


def shingle_hashes(tokens: torch.Tensor, lengths: torch.Tensor,
                   n: int) -> torch.Tensor:
    """tokens (B, L) token ids (any int dtype, uint32 bits), lengths (B,).

    Returns (B, L) int32 bits: position i holds hash(tokens[i:i+n]);
    positions beyond the shingle count hold 0xFFFFFFFF."""
    t = u32(tokens)
    B, L = t.shape
    h = torch.zeros((B, L), dtype=torch.int64, device=t.device)
    for k in range(n):
        shifted = torch.roll(t, -k, dims=1)
        h = (mul32(h, _POLY) + shifted + 1) & 0xFFFFFFFF
    h = bits32(fmix32(h))
    pos = torch.arange(L, dtype=torch.int32, device=t.device)[None, :]
    valid = pos < num_shingles(lengths.to(t.device), n)[:, None]
    return torch.where(valid, h, torch.full_like(h, UINT32_MAX_BITS))


def token_tensors(tokens, lengths) -> tuple[torch.Tensor, torch.Tensor]:
    """A batch of documents as the port holds it: tokens (B, L) uint32 ids
    (numpy or tensor) as an int32-bits tensor, lengths (B,) as int32. Host
    arrays stay on the CPU; tensors keep their device."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(
            np.ascontiguousarray(tokens, dtype=np.uint32).view(np.int32))
    if not isinstance(lengths, torch.Tensor):
        lengths = torch.as_tensor(np.asarray(lengths, np.int32))
    return tokens, lengths
