"""Cluster manifest: the writer→replica publication record (port of
`repro/cluster/manifest.py`; the JSON is byte for byte the reference's).

One JSON file (`cluster.manifest.json`) living at the top of the shared
snapshot directory, committed atomically (tmp + os.replace) so a replica
polling mid-write sees either the previous epoch or the new one, never a
torn file. The epoch is a monotone counter owned by the writer; `step`
names the committed checkpoint step (train/checkpoint layout) the epoch
corresponds to. Replicas compare epochs — NOT steps — so a writer restart
that resumes the step counter cannot be mistaken for fresh data unless it
also re-reads and advances the manifest epoch (which ClusterWriter does).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

__all__ = ["ClusterManifest", "MANIFEST_NAME", "publish_manifest",
           "read_manifest"]

MANIFEST_NAME = "cluster.manifest.json"


@dataclasses.dataclass(frozen=True)
class ClusterManifest:
    epoch: int            # monotone publication counter (starts at 1)
    step: int             # committed snapshot step this epoch points at
    count: int            # live docs in the index at publish time
    backend: str          # registry key (replicas sanity-check theirs)
    published_unix: float  # wall-clock publish time (staleness display)
    extra: dict = dataclasses.field(default_factory=dict)


def publish_manifest(snapshot_dir: str, m: ClusterManifest) -> str:
    """Atomically commit the manifest; returns its path."""
    os.makedirs(snapshot_dir, exist_ok=True)
    path = os.path.join(snapshot_dir, MANIFEST_NAME)
    fd, tmp = tempfile.mkstemp(dir=snapshot_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(dataclasses.asdict(m), f, indent=1)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def read_manifest(snapshot_dir: str) -> ClusterManifest | None:
    """Parse the current manifest; None when absent or unreadable (a
    corrupt/partial file reads as 'nothing published' — replicas keep
    serving their current index)."""
    path = os.path.join(snapshot_dir, MANIFEST_NAME)
    try:
        with open(path) as f:
            raw = json.load(f)
        return ClusterManifest(
            epoch=int(raw["epoch"]), step=int(raw["step"]),
            count=int(raw.get("count", 0)),
            backend=str(raw.get("backend", "")),
            published_unix=float(raw.get("published_unix", 0.0)),
            extra=dict(raw.get("extra", {})))
    except (OSError, ValueError, KeyError, TypeError):
        return None
