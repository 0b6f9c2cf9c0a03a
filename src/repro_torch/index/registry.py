"""String-keyed backend registry (port of `repro/index/registry.py`).

Factories take the shared `FoldConfig` plus keyword options; the
built-in `hnsw` and `brute` backends register on first use. Keys the reference has
but the port does not yet are refused by name.
"""
from __future__ import annotations

import importlib
from typing import TYPE_CHECKING, Any, Callable, Dict, Optional, Tuple

if TYPE_CHECKING:
    from repro_torch.core.dedup import FoldConfig
    from repro_torch.index.pipeline import DedupPipeline
    from repro_torch.index.protocol import DedupBackend

__all__ = ["register", "make", "make_pipeline", "available"]

Factory = Callable[..., "DedupBackend"]

_REGISTRY: Dict[str, Factory] = {}
_NOT_PORTED = ("hnsw_raw", "hnsw_sharded", "dpk", "flat_lsh",
               "prefix_filter")


def register(name: str, factory: Optional[Factory] = None) -> Any:
    """Register a backend factory under `name` (decorator or direct call);
    re-registering a name overwrites it."""
    def _do(f: Factory) -> Factory:
        _REGISTRY[name] = f
        return f
    return _do(factory) if factory is not None else _do


def _lookup(name: str) -> Factory:
    importlib.import_module("repro_torch.index.backends")
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(f"backend {name!r} is not ported yet")
    raise KeyError(f"unknown dedup backend {name!r}; "
                   f"registered: {', '.join(available())}")


def available() -> Tuple[str, ...]:
    """Registered backend keys, sorted."""
    importlib.import_module("repro_torch.index.backends")
    return tuple(sorted(_REGISTRY))


def make(name: str, cfg: "Optional[FoldConfig]" = None,
         **opts: Any) -> "DedupBackend":
    """Instantiate the backend registered under `name`."""
    return _lookup(name)(cfg, **opts)


def make_pipeline(name: str, cfg: "Optional[FoldConfig]" = None,
                  **opts: Any) -> "DedupPipeline":
    """`make` + wrap in the generic DedupPipeline."""
    from repro_torch.index.pipeline import DedupPipeline
    return DedupPipeline(make(name, cfg, **opts))
