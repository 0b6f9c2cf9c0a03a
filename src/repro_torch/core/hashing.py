"""Vectorized integer hashing (port of `repro/core/hashing.py`).

uint32 values travel as int32 bit patterns (see the package docstring).
The arithmetic here widens them to int64 in [0, 2**32) — the "u32
domain" — where `>>` is logical and products are reduced mod 2**32
without ever overflowing int64 (`mul32` splits the multiplicand into
16-bit halves), so the CPU and CUDA builds of torch give the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

__all__ = ["UINT32_MAX", "UINT32_MAX_BITS", "u32", "bits32", "mul32",
           "popc", "fmix32", "hash_seeds", "multihash"]

UINT32_MAX = 0xFFFFFFFF
UINT32_MAX_BITS = -1          # the int32 bit pattern of 0xFFFFFFFF
_M32 = 0xFFFFFFFF

_GOLDEN = 0x9E3779B9          # 2^32 / phi
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its low 32 bits unsigned."""
    return x.to(torch.int64) & _M32


def bits32(x: torch.Tensor) -> torch.Tensor:
    """int64 (any value) -> int32 carrying its low 32 bits."""
    x = x.to(torch.int64) & _M32
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def mul32(a: torch.Tensor, c) -> torch.Tensor:
    """(a * c) mod 2**32 for u32-domain `a` and `c` (int or tensor).

    Each partial product stays below 2**48, so no int64 overflow."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 32-bit finalizer on the u32 domain (int64 in, int64 out)."""
    x = u32(x)
    x = x ^ (x >> 16)
    x = mul32(x, _C1)
    x = x ^ (x >> 13)
    x = mul32(x, _C2)
    x = x ^ (x >> 16)
    return x


def popc(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of 32-bit words (int32 bits or u32 domain),
    as int64 (SWAR; torch has no popcount op)."""
    x = u32(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def hash_seeds(num: int, base_seed: int = 0x5EED,
               device: str | torch.device | None = None) -> torch.Tensor:
    """`num` hash-function seeds, (num,) int32 bits of the reference's
    uint32 seeds, on `device` (cuda unless "cpu" is passed)."""
    idx = torch.arange(num, dtype=torch.int64, device=resolve_device(device))
    return bits32(fmix32((mul32(idx, _GOLDEN) + (base_seed & _M32)) & _M32))


def multihash(values: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """(H, ...) u32-domain int64: hash h applied to every value.

    values: (...,) int32 bits; seeds: (H,) int32 bits."""
    v = u32(values)
    s = u32(seeds).reshape((-1,) + (1,) * v.ndim)
    return fmix32((mul32(v[None] ^ s, _GOLDEN) + s) & _M32)
