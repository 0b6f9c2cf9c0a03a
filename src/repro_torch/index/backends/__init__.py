"""Built-in backend implementations; importing this package registers them.

Every key of the reference: `hnsw`, `hnsw_sharded`, `hnsw_raw`, `brute`,
`dpk`, `flat_lsh` and `prefix_filter`.
"""
from repro_torch.index.backends.brute import BruteForceBackend  # noqa: F401
from repro_torch.index.backends.hnsw import (HNSWBitmapBackend,  # noqa: F401
                                             RawHNSWBackend)
from repro_torch.index.backends.lsh import DPKBackend, FlatLSHBackend  # noqa: F401
from repro_torch.index.backends.prefix import PrefixFilterBackend  # noqa: F401
from repro_torch.index.backends.sharded import ShardedDedupBackend  # noqa: F401

__all__ = ["BruteForceBackend", "HNSWBitmapBackend", "RawHNSWBackend",
           "DPKBackend", "FlatLSHBackend", "PrefixFilterBackend",
           "ShardedDedupBackend"]
