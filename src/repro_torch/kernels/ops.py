"""Public entry points for the kernels (port of `repro/kernels/ops.py`).

`use_kernel` selects the kernel path ('SIMD' in the paper's Fig. 8
ablation) or the plain PyTorch version (`use_kernel=False`, the ablation
arm, on whatever device the tensors live). On the kernel path the
tensor's device decides: a CPU tensor takes the plain version, a CUDA
tensor launches the CUDA kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bitmap_jaccard import bitmap_jaccard_matrix, hamming_matrix
from repro_torch.kernels.minhash import minhash_kernel_signatures

__all__ = ["bitmap_jaccard", "hamming", "minhash"]


def bitmap_jaccard(qs: torch.Tensor, db: torch.Tensor,
                   pq: torch.Tensor | None = None,
                   pb: torch.Tensor | None = None, *,
                   cached: bool = True, use_kernel: bool = True) -> torch.Tensor:
    """(Q, W) x (N, W) packed bitmaps -> (Q, N) f32 similarity matrix."""
    if not use_kernel:
        if not cached:
            pq = pb = None  # on-the-fly popcounts (ablation arm)
        return ref.bitmap_jaccard_ref(qs, db, pq, pb)
    return bitmap_jaccard_matrix(qs, db, pq, pb, cached=cached)


def hamming(qs: torch.Tensor, db: torch.Tensor, *,
            use_kernel: bool = True) -> torch.Tensor:
    if not use_kernel:
        return ref.hamming_ref(qs, db)
    return hamming_matrix(qs, db)


def minhash(shingles: torch.Tensor, seeds: torch.Tensor, *,
            use_kernel: bool = True) -> torch.Tensor:
    if not use_kernel:
        return ref.minhash_ref(shingles, seeds)
    return minhash_kernel_signatures(shingles, seeds)
