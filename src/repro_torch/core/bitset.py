"""Packed 32-bit bitsets: the visited sets of batched HNSW search (port of
`repro/core/bitset.py`).

Words are int32 bit patterns with a leading batch dimension: a (Q, words)
tensor holds one bitset per query. `bitset_add` builds a scatter-OR from
`scatter_add_`, which is exact if and only if every (word, bit) added in
one call is unique and not yet set — the search loop guarantees that by
deduplicating candidate ids and filtering them through `bitset_test`.
Under that contract no int32 addition can overflow (adding bit 31 to a
word without it, or a lower bit to any word, stays in range).
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import bits32
from repro_torch.device import resolve_device

__all__ = ["bitset_words", "bitset_zeros", "bitset_test", "bitset_add",
           "bitset_nbytes"]


def bitset_words(capacity: int) -> int:
    """Number of 32-bit words backing a `capacity`-slot bitset."""
    return (capacity + 31) // 32


def bitset_nbytes(capacity: int) -> int:
    """Bytes of visited state per query."""
    return bitset_words(capacity) * 4


def bitset_zeros(n: int, capacity: int,
                 device: str | torch.device | None = None) -> torch.Tensor:
    """n empty bitsets: (n, (capacity+31)//32) int32, on `device` (cuda
    unless "cpu" is passed)."""
    return torch.zeros((n, bitset_words(capacity)), dtype=torch.int32,
                       device=resolve_device(device))


def bitset_test(bs: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Membership of ids (n, K) in bitsets bs (n, words); ids < 0 -> False."""
    safe = torch.clamp(ids, min=0)
    word = torch.gather(bs, 1, (safe >> 5).to(torch.int64))
    return (((word >> (safe & 31)) & 1) > 0) & (ids >= 0)


def bitset_add(bs: torch.Tensor, ids: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Set the bit of every id (n, K) where mask; updates `bs` in place.

    CONTRACT: masked ids are unique per row and not yet set."""
    safe = torch.clamp(ids, min=0)
    one = torch.ones_like(safe, dtype=torch.int64)
    contrib = torch.where(mask, bits32(one << (safe & 31).to(torch.int64)),
                          torch.zeros_like(safe, dtype=torch.int32))
    return bs.scatter_add_(1, (safe >> 5).to(torch.int64), contrib)
