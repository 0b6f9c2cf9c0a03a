"""Plain PyTorch versions of the four kernels (port of
`repro/kernels/ref.py`).

Each function is the semantic specification of one CUDA kernel in
`kernels/csrc/`: the kernel wrappers take it for CPU tensors, the tests
hold it against the JAX Pallas kernels, and `chip_smoke.py` holds each
CUDA kernel against it on the card. The work is blocked over rows (MinHash:
over hash functions) only to bound the int64 temporaries; blocking never
changes a result.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import (UINT32_MAX, UINT32_MAX_BITS, bits32,
                                      multihash, popc)

__all__ = ["bitmap_jaccard_ref", "hamming_from_px", "hamming_ref",
           "minhash_ref", "popcount", "xor_popcount"]

_BLOCK_ELEMS = 1 << 22     # int64 elements per temporary block


def popcount(words: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Set bits along `dim` of packed 32-bit words, int32."""
    return popc(words).sum(dim).to(torch.int32)


def xor_popcount(qs: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(Q, W) x (N, W) -> (Q, N) int32 popcount(q ^ d)."""
    Q, W = qs.shape
    N = db.shape[0]
    rows = max(1, _BLOCK_ELEMS // max(N * W, 1))
    out = torch.empty((Q, N), dtype=torch.int32, device=qs.device)
    for r in range(0, Q, rows):
        out[r:r + rows] = popcount(qs[r:r + rows, None, :] ^ db[None, :, :])
    return out


def bitmap_jaccard_ref(qs: torch.Tensor, db: torch.Tensor,
                       pq: torch.Tensor | None = None,
                       pb: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, W) x (N, W) packed words -> (Q, N) f32 bitmap-Jaccard.

    J = (pa + pb - px) / (pa + pb + px); empty-vs-empty -> 1.0. pq/pb are
    the cached popcounts, recomputed when None (the NO CACHE arm)."""
    if pq is None:
        pq = popcount(qs)
    if pb is None:
        pb = popcount(db)
    px = xor_popcount(qs, db)
    s = pq.to(torch.int32)[:, None] + pb.to(torch.int32)[None, :]
    union2 = (s + px).to(torch.float32)
    inter2 = (s - px).to(torch.float32)
    return torch.where(union2 > 0, inter2 / torch.clamp(union2, min=1.0),
                       torch.ones_like(union2))


def hamming_from_px(px: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer Hamming distances px (any int dtype) out of `bits` -> f32
    similarity 1 - px / bits, rounded once as fma(-px, f32(1 / bits), 1).

    That is the reference's rounding wherever it is jitted (XLA turns the
    division by a constant into a product with its f32 reciprocal, fused
    with the subtraction) and K4's. It is computed exactly: with
    f32(1 / bits) = m * 2**-k for a 24-bit integer m, 2**k - px * m is an
    exact int64, converted to f32 once (the one rounding), and the scale
    by 2**-k is exact."""
    frac, exp = np.frexp(np.float32(1) / np.float32(bits))
    m = int(frac * (1 << 24))
    k = 24 - int(exp)
    exact = (1 << k) - px.to(torch.int64) * m
    return exact.to(torch.float32) * (2.0 ** -k)


def hamming_ref(qs: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(Q, W) x (N, W) packed words -> (Q, N) f32 normalized Hamming sim."""
    return hamming_from_px(xor_popcount(qs, db), qs.shape[-1] * 32)


def minhash_ref(shingles: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """(B, L) shingle hashes (0xFFFFFFFF = pad) x (H,) seeds -> (B, H)
    MinHash signatures, all int32 bits: sig[b, h] = min_l F_h(sh[b, l])
    under the UNSIGNED order (the min is taken in the u32 domain)."""
    B, L = shingles.shape
    H = seeds.shape[0]
    valid = shingles != UINT32_MAX_BITS
    out = torch.empty((H, B), dtype=torch.int64, device=shingles.device)
    step = max(1, _BLOCK_ELEMS // max(B * L, 1))
    for h in range(0, H, step):
        hashed = multihash(shingles, seeds[h:h + step])      # (h, B, L)
        hashed = torch.where(valid[None], hashed,
                             torch.full_like(hashed, UINT32_MAX))
        out[h:h + step] = hashed.amin(-1)
    return bits32(out.T).contiguous()
