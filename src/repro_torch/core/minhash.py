"""MinHash signature generation (port of `repro/core/minhash.py`).

sig[h] = min_j F_h(shingle_j) under the unsigned order; padded shingles
(0xFFFFFFFF) are re-masked after the remix. The CUDA kernel in
`kernels/minhash.py` computes the same reduction on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import hash_seeds
from repro_torch.core.shingle import shingle_hashes
from repro_torch.kernels.ref import minhash_ref

__all__ = ["minhash_from_shingles", "minhash_signatures", "default_seeds",
           "DEFAULT_NUM_HASHES"]

DEFAULT_NUM_HASHES = 112


def default_seeds(num_hashes: int = DEFAULT_NUM_HASHES,
                  device: str | torch.device | None = None) -> torch.Tensor:
    return hash_seeds(num_hashes, device=device)


def minhash_from_shingles(sh: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """sh (B, L) shingle hashes (0xFFFFFFFF = invalid), seeds (H,) ->
    (B, H) signatures, all int32 bits."""
    return minhash_ref(sh, seeds)


def minhash_signatures(tokens: torch.Tensor, lengths: torch.Tensor,
                       seeds: torch.Tensor, n: int = 5) -> torch.Tensor:
    """End to end, plain: padded token ids (B, L) (uint32 bits) and
    lengths (B,) -> (B, H) MinHash signatures, int32 bits, on the tensors'
    device."""
    return minhash_from_shingles(shingle_hashes(tokens, lengths, n), seeds)
