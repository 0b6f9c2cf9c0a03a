"""K1: the MinHash min-reduction on the card (port of the Pallas kernel
`_minhash_kernel` / `minhash_kernel_signatures` in
`repro/kernels/minhash.py`).

Source: `csrc/minhash.cu`. It is bound by 32-bit integer work (a dozen
operations per (doc, hash, valid shingle) against four bytes per
shingle). A block compacts a document's valid shingles into shared
memory, wherever the padding stands, and its threads, laid out over
(hash slot, shingle partition) so that no lane idles at H = 112, fold
them into register minima; the thread layout is chosen in the C entry
point from H alone.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

__all__ = ["minhash_kernel_signatures"]


def minhash_kernel_signatures(shingles: torch.Tensor,
                              seeds: torch.Tensor) -> torch.Tensor:
    """(B, L) shingle hashes (0xFFFFFFFF = pad) x (H,) seeds -> (B, H)
    signatures, all int32 bits. Equals kernels.ref.minhash_ref."""
    _lib.check_words("shingles", shingles, 2)
    _lib.check_words("seeds", seeds, 1)
    if shingles.device != seeds.device:
        raise ValueError("shingles and seeds must be on one device")
    if shingles.device.type == "cpu":
        return ref.minhash_ref(shingles, seeds)
    if shingles.device.type != "cuda":
        raise ValueError(f"unsupported device {shingles.device}")
    B, L = shingles.shape
    H = seeds.shape[0]
    out = torch.empty((B, H), dtype=torch.int32, device=shingles.device)
    if B == 0 or H == 0:
        return out
    rc = _lib.library("minhash.cu").fold_minhash(
        shingles.data_ptr(), seeds.data_ptr(), out.data_ptr(), B, L, H,
        _lib.stream_of(shingles))
    _lib.check(rc, "minhash")
    return out
