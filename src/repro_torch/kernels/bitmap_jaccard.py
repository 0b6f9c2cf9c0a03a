"""K2, K3, K4: bitmap-Jaccard and Hamming similarity matrices on the card
(port of `_jaccard_kernel_cached`, `_jaccard_kernel_nocache` and
`_hamming_kernel` behind `bitmap_jaccard_matrix` / `hamming_matrix` in
`repro/kernels/bitmap_jaccard.py`).

Source: `csrc/bitmap_jaccard.cu`. The work is integer XOR + popcount over
words that every output re-reads. K2, K3 and K4 are one tiled kernel with
three epilogues: a block stages 32 query and 32 database rows in shared
memory with coalesced 16-byte loads and each thread keeps a 2 x 4 register
tile of XOR-popcount sums; K3 recounts the rows' popcounts as it stages
them. The tile and grid live only in the C entry points. IEEE divisions,
and K4's single FMA rounding (`ref.hamming_from_px`), keep every result
bit-equal to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

__all__ = ["bitmap_jaccard_matrix", "hamming_matrix"]


def _check_pair(qs: torch.Tensor, db: torch.Tensor) -> None:
    _lib.check_words("qs", qs, 2)
    _lib.check_words("db", db, 2)
    if qs.device != db.device:
        raise ValueError("qs and db must be on one device")
    if qs.shape[1] != db.shape[1]:
        raise ValueError(f"word counts differ: {qs.shape[1]} vs {db.shape[1]}")
    if qs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {qs.device}")


def bitmap_jaccard_matrix(qs: torch.Tensor, db: torch.Tensor,
                          pq: torch.Tensor | None = None,
                          pb: torch.Tensor | None = None, *,
                          cached: bool = True) -> torch.Tensor:
    """(Q, W) x (N, W) words -> (Q, N) f32 bitmap-Jaccard similarity.

    cached=True (K2) reads the popcounts pq (Q,) / pb (N,) int32, computing
    them first when None; cached=False (K3) recounts them inside the
    kernel, the Fig. 8 NO CACHE arm."""
    _check_pair(qs, db)
    Q, W = qs.shape
    N = db.shape[0]
    if cached:
        pq = ref.popcount(qs) if pq is None else pq
        pb = ref.popcount(db) if pb is None else pb
        _lib.check_words("pq", pq, 1)
        _lib.check_words("pb", pb, 1)
        if pq.shape[0] != Q or pb.shape[0] != N:
            raise ValueError("popcount lengths do not match the rows")
        if pq.device != qs.device or pb.device != qs.device:
            raise ValueError("popcounts must be on the words' device")
    if qs.device.type == "cpu":
        return ref.bitmap_jaccard_ref(qs, db, pq if cached else None,
                                      pb if cached else None)
    out = torch.empty((Q, N), dtype=torch.float32, device=qs.device)
    if Q == 0 or N == 0:
        return out
    lib = _lib.library("bitmap_jaccard.cu")
    stream = _lib.stream_of(qs)
    if cached:
        rc = lib.fold_bitmap_jaccard_cached(
            qs.data_ptr(), db.data_ptr(), pq.data_ptr(), pb.data_ptr(),
            out.data_ptr(), Q, N, W, stream)
        _lib.check(rc, "jaccard_cached")
    else:
        rc = lib.fold_bitmap_jaccard_nocache(
            qs.data_ptr(), db.data_ptr(), out.data_ptr(), Q, N, W, stream)
        _lib.check(rc, "jaccard_nocache")
    return out


def hamming_matrix(qs: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(Q, W) x (N, W) words -> (Q, N) f32 normalized Hamming similarity,
    rounded as `ref.hamming_from_px`."""
    _check_pair(qs, db)
    if qs.device.type == "cpu":
        return ref.hamming_ref(qs, db)
    Q, W = qs.shape
    N = db.shape[0]
    out = torch.empty((Q, N), dtype=torch.float32, device=qs.device)
    if Q == 0 or N == 0:
        return out
    rc = _lib.library("bitmap_jaccard.cu").fold_hamming(
        qs.data_ptr(), db.data_ptr(), out.data_ptr(), Q, N, W,
        _lib.stream_of(qs))
    _lib.check(rc, "hamming")
    return out
