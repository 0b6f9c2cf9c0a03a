"""String-keyed backend registry (port of `repro/index/registry.py`).

Factories take the shared `FoldConfig` plus keyword options; the
built-in backends (`hnsw`, `hnsw_sharded`, `hnsw_raw`, `brute`, `dpk`,
`flat_lsh`, `prefix_filter`: the reference's keys) register on first use.

The accepted option set is derived from the live factory signature
(`accepted_opts`), as in the reference. The port's factories also take
`device`, so their sets are the reference's plus that one key (and
`hnsw_sharded`'s lacks the reference's `mesh`: its shards share the one
device).
"""
from __future__ import annotations

import dataclasses
import importlib
import inspect
from typing import (TYPE_CHECKING, Any, Callable, Dict, Mapping, Optional,
                    Tuple)

if TYPE_CHECKING:
    from repro_torch.core.dedup import FoldConfig
    from repro_torch.index.pipeline import DedupPipeline
    from repro_torch.index.protocol import DedupBackend

__all__ = ["register", "make", "make_pipeline", "available",
           "accepted_opts", "validate_opts"]

Factory = Callable[..., "DedupBackend"]

_REGISTRY: Dict[str, Factory] = {}
# signature-derived accepted_opts, memoised per key; register() invalidates
_OPTS_CACHE: Dict[str, Tuple[str, ...]] = {}


def register(name: str, factory: Optional[Factory] = None) -> Any:
    """Register a backend factory under `name` (decorator or direct call);
    re-registering a name overwrites it."""
    def _do(f: Factory) -> Factory:
        _REGISTRY[name] = f
        _OPTS_CACHE.pop(name, None)
        return f
    return _do(factory) if factory is not None else _do


def _lookup(name: str) -> Factory:
    importlib.import_module("repro_torch.index.backends")
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown dedup backend {name!r}; "
                   f"registered: {', '.join(available())}")


def available() -> Tuple[str, ...]:
    """Registered backend keys, sorted."""
    importlib.import_module("repro_torch.index.backends")
    return tuple(sorted(_REGISTRY))


def accepted_opts(name: str) -> Tuple[str, ...]:
    """Keyword options the backend's factory accepts, sorted: its named
    parameters (minus the positional `cfg`), plus the `FoldConfig` field
    names when it takes **opts (it forwards them into
    `dataclasses.replace` on the shared config)."""
    factory = _lookup(name)
    cached = _OPTS_CACHE.get(name)
    if cached is not None:
        return cached
    keys: set = set()
    var_kw = False
    try:
        params = inspect.signature(factory).parameters
    except (TypeError, ValueError):
        return ()
    for i, (pname, p) in enumerate(params.items()):
        if p.kind == inspect.Parameter.VAR_KEYWORD:
            var_kw = True
        elif p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                        inspect.Parameter.KEYWORD_ONLY):
            if not (i == 0 and pname == "cfg"):
                keys.add(pname)
    if var_kw:
        from repro_torch.core.dedup import FoldConfig
        keys.update(f.name for f in dataclasses.fields(FoldConfig))
    out = tuple(sorted(keys))
    _OPTS_CACHE[name] = out
    return out


def validate_opts(name: str, opts: Mapping[str, Any]) -> None:
    """Raise ValueError naming unknown keys in `opts` (and listing the
    accepted ones) instead of letting the factory silently ignore them."""
    accepted = accepted_opts(name)
    unknown = sorted(set(opts) - set(accepted))
    if unknown:
        raise ValueError(
            f"unknown backend_opts {unknown} for backend {name!r}; "
            f"accepted keys: {', '.join(accepted) or '(none)'}")


def make(name: str, cfg: "Optional[FoldConfig]" = None,
         **opts: Any) -> "DedupBackend":
    """Instantiate the backend registered under `name`."""
    return _lookup(name)(cfg, **opts)


def make_pipeline(name: str, cfg: "Optional[FoldConfig]" = None,
                  **opts: Any) -> "DedupPipeline":
    """`make` + wrap in the generic DedupPipeline."""
    from repro_torch.index.pipeline import DedupPipeline
    return DedupPipeline(make(name, cfg, **opts))
