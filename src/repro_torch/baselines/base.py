"""Shared signature stage + LSH banding utilities for all baselines (port
of `repro/baselines/base.py`)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import hash_seeds
from repro_torch.device import resolve_device
from repro_torch.index.protocol import SigSpec

__all__ = ["SignatureStage", "band_keys", "pick_bands"]


class SignatureStage:
    """Step ① shared by every pipeline: tokens -> (B, H) MinHash signatures
    (int32 bits) on the stage's device, through `ops.minhash` (kernel K1 on
    a card)."""

    def __init__(self, num_hashes: int = 112, shingle_n: int = 5,
                 seed: int = 0, use_kernel: bool = True,
                 device: str | torch.device | None = None):
        self.num_hashes = num_hashes
        self.shingle_n = shingle_n
        self.use_kernel = use_kernel
        self.device = resolve_device(device)
        self.seeds = hash_seeds(num_hashes, seed, self.device)
        self._spec = SigSpec(num_hashes=num_hashes, shingle_n=shingle_n,
                             seed=seed, use_kernel=use_kernel)

    def __call__(self, tokens, lengths) -> torch.Tensor:
        # deferred: repro_torch.core.dedup imports repro_torch.index
        from repro_torch.core.dedup import fold_signatures
        from repro_torch.core.shingle import token_tensors
        return fold_signatures(self._spec, self.seeds,
                               *token_tensors(tokens, lengths),
                               with_bitmaps=False)[0]


def pick_bands(num_hashes: int, tau: float) -> tuple[int, int]:
    """Choose (bands, rows) with b*r <= H whose S-curve threshold
    (1/b)^(1/r) is closest to tau. Standard MinHash-LSH calibration."""
    best = (1, num_hashes)
    best_err = float("inf")
    for r in range(1, num_hashes + 1):
        b = num_hashes // r
        if b < 1:
            break
        thr = (1.0 / b) ** (1.0 / r) if b > 1 else 1.0
        err = abs(thr - tau)
        if err < best_err:
            best_err, best = err, (b, r)
    return best


def band_keys(sigs: np.ndarray, bands: int, rows: int) -> np.ndarray:
    """(N, H) uint32 -> (N, bands) uint64 band-bucket keys (FNV-1a fold).

    An int32 array is taken as the port's uint32 bits (viewed, never
    sign-extended: a lane >= 2**31 must keep its value)."""
    sigs = np.asarray(sigs)
    if sigs.dtype == np.int32:
        sigs = sigs.view(np.uint32)
    sigs = sigs.astype(np.uint64)
    n = sigs.shape[0]
    keys = np.empty((n, bands), dtype=np.uint64)
    with np.errstate(over="ignore"):  # uint64 wraparound is intentional
        for b in range(bands):
            chunk = sigs[:, b * rows:(b + 1) * rows]
            h = np.full(n, 0xCBF29CE484222325, dtype=np.uint64)
            for r in range(chunk.shape[1]):
                h = (h ^ chunk[:, r]) * np.uint64(0x100000001B3)
            # mix in the band index so identical row values in different
            # bands don't collide into one bucket space
            keys[:, b] = h ^ (np.uint64(b) * np.uint64(0x9E3779B97F4A7C15))
    return keys
