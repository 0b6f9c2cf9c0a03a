"""repro_torch.cluster — single-writer / N-reader replicated dedup serving
(port of `repro.cluster`).

The serving architecture on top of `repro_torch.service`: one
ClusterWriter owns admission, insertion, growth, and lifecycle exactly as
DedupService always has; N ReadReplicas serve search-only "is this a
dup?" queries from read-only indexes refreshed through the existing
snapshot rotation plus an atomically-published manifest (monotone epoch).
Multi-tenant namespaces add per-tenant QPS token buckets and live-doc
budgets, and the ticket API gains bounded admission with explicit
Backpressure (reject-with-retry-after) instead of unbounded queues.

Everything is in-process and caller-driven (no threads) — the process
boundary of a real deployment is the snapshot directory + manifest the
replicas already poll, so the protocol is deployment-shaped even though
the reference topology runs in one process.
"""
from repro_torch.cluster.manifest import (MANIFEST_NAME,  # noqa: F401
                                          ClusterManifest, publish_manifest,
                                          read_manifest)
from repro_torch.cluster.replica import ReadReplica  # noqa: F401
from repro_torch.cluster.router import DedupCluster  # noqa: F401
from repro_torch.cluster.tenancy import TenantSpec, TokenBucket  # noqa: F401
from repro_torch.cluster.writer import (DEFAULT_TENANT,  # noqa: F401
                                        ClusterConfig, ClusterWriter)
from repro_torch.service.batcher import Backpressure  # noqa: F401

__all__ = ["ClusterManifest", "MANIFEST_NAME", "publish_manifest",
           "read_manifest", "ReadReplica", "DedupCluster", "TenantSpec",
           "TokenBucket", "ClusterConfig", "ClusterWriter",
           "DEFAULT_TENANT", "Backpressure"]
