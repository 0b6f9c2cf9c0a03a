"""FOLD bitmap signatures and the three candidate similarities (port of
`repro/core/bitmap.py`).

A MinHash signature (H lanes) folds into a T-bit bitmap, bit[sig mod T]
= 1, packed into W = T/32 words (int32 bits). Bitmap-Jaccard needs three
popcounts: px = popcount(A ^ B), 2I = pa + pb - px, 2U = pa + pb + px.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import bits32, u32
from repro_torch.kernels.ref import hamming_from_px, popcount, xor_popcount

__all__ = [
    "DEFAULT_T",
    "pack_bitmaps",
    "chunked_pairwise_bitmap_jaccard",
    "popcount",
    "bitmap_jaccard_sim",
    "bitmap_jaccard_dist",
    "minhash_jaccard_sim",
    "hamming_sim",
    "lane_fraction",
    "pairwise_bitmap_jaccard",
    "pairwise_minhash_jaccard",
    "pairwise_hamming",
]

DEFAULT_T = 4096  # bitmap size in bits; W = 128 words


def pack_bitmaps(sigs: torch.Tensor, T: int = DEFAULT_T) -> torch.Tensor:
    """(B, H) MinHash lanes (int32 bits) -> (B, T//32) packed words.

    Position p = sig mod T (unsigned: taken in the u32 domain) sets word
    p//32 bit p%32; colliding lanes set the same bit."""
    if T % 32:
        raise ValueError("T must be a multiple of 32")
    W = T // 32
    B = sigs.shape[0]
    pos = u32(sigs) % T                                        # (B, H)
    bits = torch.zeros((B, T), dtype=torch.bool, device=sigs.device)
    bits.scatter_(1, pos, True)
    lanes = bits.reshape(B, W, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=sigs.device) << \
        torch.arange(32, device=sigs.device)
    return bits32((lanes * weights).sum(-1))


# ---------------------------------------------------------------- distances
def _jaccard_ratio(inter2: torch.Tensor, union2: torch.Tensor) -> torch.Tensor:
    """2I / 2U computed in float32 explicitly (the reference's explicit-f32
    rule: no promotion to float64 whatever the integer dtype)."""
    sim = (inter2.to(torch.float32)
           / torch.clamp(union2, min=1).to(torch.float32))
    return torch.where(union2 > 0, sim, torch.ones_like(sim))


def bitmap_jaccard_sim(a, b, pa=None, pb=None) -> torch.Tensor:
    """Bitmap-Jaccard between packed bitmaps (last dim = words)."""
    if pa is None:
        pa = popcount(a)
    if pb is None:
        pb = popcount(b)
    px = popcount(a ^ b)
    return _jaccard_ratio(pa + pb - px, pa + pb + px)


def bitmap_jaccard_dist(a, b, pa=None, pb=None) -> torch.Tensor:
    return 1.0 - bitmap_jaccard_sim(a, b, pa, pb)


def lane_fraction(eq: torch.Tensor) -> torch.Tensor:
    """Fraction of True lanes along the last dim, rounded as the
    reference's `jnp.mean` rounds it, jitted or eager: the count of equal
    lanes (exact in f32) times f32(1 / H), one rounding. An IEEE division
    count / H, which `mean` computes, differs at 62 of the 113 counts at
    H = 112. The reciprocal is a tensor, so no device turns the product
    into anything else."""
    H = eq.shape[-1]
    recip = torch.tensor(np.float32(1) / np.float32(H), dtype=torch.float32,
                         device=eq.device)
    return eq.sum(-1, dtype=torch.int32).to(torch.float32) * recip


def minhash_jaccard_sim(sa, sb) -> torch.Tensor:
    """Raw MinHash-Jaccard: fraction of equal lanes."""
    return lane_fraction(sa == sb)


def hamming_sim(sa, sb) -> torch.Tensor:
    """Normalized Hamming similarity over packed signature bits, rounded
    as the reference's jitted code rounds it (`hamming_from_px`)."""
    return hamming_from_px(popcount(sa ^ sb), sa.shape[-1] * 32)


# ------------------------------------------------- pairwise (Q, N) variants
def pairwise_bitmap_jaccard(qs, db, pq=None, pb=None) -> torch.Tensor:
    """(Q, W) x (N, W) -> (Q, N) bitmap-Jaccard similarity."""
    if pq is None:
        pq = popcount(qs)
    if pb is None:
        pb = popcount(db)
    px = xor_popcount(qs, db)
    s = pq[:, None] + pb[None, :]
    return _jaccard_ratio(s - px, s + px)


def chunked_pairwise_bitmap_jaccard(qs, db, pq=None, pb=None, *,
                                    row_chunk: int = 512,
                                    col_chunk: int = 2048) -> torch.Tensor:
    """pairwise_bitmap_jaccard over (row_chunk, col_chunk) blocks, bounding
    the XOR temporary; blocking never changes a result."""
    if pq is None:
        pq = popcount(qs)
    if pb is None:
        pb = popcount(db)
    out = torch.empty((qs.shape[0], db.shape[0]), dtype=torch.float32,
                      device=qs.device)
    for r in range(0, qs.shape[0], row_chunk):
        for c in range(0, db.shape[0], col_chunk):
            out[r:r + row_chunk, c:c + col_chunk] = pairwise_bitmap_jaccard(
                qs[r:r + row_chunk], db[c:c + col_chunk],
                pq[r:r + row_chunk], pb[c:c + col_chunk])
    return out


def pairwise_minhash_jaccard(qs, db) -> torch.Tensor:
    """(Q, H) x (N, H) lanes -> (Q, N) fraction of equal lanes."""
    return lane_fraction(qs[:, None, :] == db[None, :, :])


def pairwise_hamming(qs, db) -> torch.Tensor:
    return hamming_from_px(xor_popcount(qs, db), qs.shape[-1] * 32)
