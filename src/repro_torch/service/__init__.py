"""repro_torch.service — the online dedup serving layer (port of
`repro.service`).

Dynamic micro-batching with bucketed shapes, a depth-bounded executor,
index lifecycle management (growth + snapshot rotation), and a ticketed
front API with serving metrics, generic over any registered backend of the
port. The reference's `ShardedDedupBackend` re-export waits for the
sharded backend, and its `programs.py` (program specs for the JAX analysis
gate) for the analysis slice.
"""
from repro_torch.service.batcher import (Backpressure, MicroBatch,  # noqa: F401
                                         MicroBatcher, pow2_buckets)
from repro_torch.service.executor import (BatchOutcome,  # noqa: F401
                                          PipelinedExecutor)
from repro_torch.service.index_manager import IndexManager  # noqa: F401
from repro_torch.service.metrics import LogHistogram, MetricsRegistry  # noqa: F401
from repro_torch.service.service import (DedupService,  # noqa: F401
                                         DocVerdict, ServiceConfig, Ticket,
                                         resolve_backend)

__all__ = ["MicroBatch", "MicroBatcher", "Backpressure", "pow2_buckets",
           "BatchOutcome", "PipelinedExecutor", "IndexManager",
           "MetricsRegistry", "LogHistogram", "DedupService", "DocVerdict",
           "ServiceConfig", "Ticket", "resolve_backend"]
