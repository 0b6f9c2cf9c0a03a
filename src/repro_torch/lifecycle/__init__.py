"""Document lifecycle: TTL expiry, LRU eviction, online compaction (port of
`repro/lifecycle`). The mechanism (tombstones, free-slot reuse,
`compact`) is the backends' DELETION CONTRACT; `LifecycleManager` is the
policy."""
from repro_torch.lifecycle.manager import LifecycleManager

__all__ = ["LifecycleManager"]
