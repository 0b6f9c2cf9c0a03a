"""Built-in backend implementations; importing this package registers them.

Ported so far: `hnsw` and `brute`. The reference's other keys are refused
by `repro_torch.index.registry` until their slice lands.
"""
from repro_torch.index.backends.brute import BruteForceBackend  # noqa: F401
from repro_torch.index.backends.hnsw import HNSWBitmapBackend  # noqa: F401

__all__ = ["BruteForceBackend", "HNSWBitmapBackend"]
