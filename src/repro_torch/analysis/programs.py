"""Registry of analyzable hot-path program specs (port of
`repro/analysis/programs.py`).

A ProgramSpec names one hot-path tensor program plus what the analyzer
needs to run it once and observe it: a maker returning `(fn, args,
kwargs)` with real tensors at the spec's pinned geometry on the device the
analyzer passes in, how many leaves of the input state the returned state
must share storage with, and per-program budgets.

Specs are contributed by the surfaces that own the programs: each index
backend module and the service layer registers a PROVIDER here at import,
so the spec list tracks the code it describes. `default_specs()` imports
the provider modules lazily (avoiding import cycles) and materializes
every spec.

Shape-bucketed program FAMILIES (`ProgramSpec.family`) group the variants
the service runs for its bucketed batch shapes; the analyzer checks the
family's distinct-signature count against the bucket menu (one program
per bucket, ever).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Iterable

__all__ = ["ProgramBudget", "ProgramSpec", "register_programs",
           "iter_specs", "default_specs", "spec_families", "PROVIDER_MODULES"]

# Modules that register program providers as an import side effect. Kept
# explicit (not discovered) so the gate's coverage is reviewable in one
# place; extend when a new surface grows analyzable programs.
PROVIDER_MODULES = (
    "repro_torch.index.backends.hnsw",
    "repro_torch.index.backends.sharded",
    "repro_torch.index.backends.brute",
    "repro_torch.service.programs",
)


@dataclasses.dataclass(frozen=True)
class ProgramBudget:
    """Per-program ceilings checked on one run (None = unchecked).

    `temp_bytes` bounds the allocator's peak growth during the call (on a
    card); `peak_bytes` bounds arguments + outputs + temps. `gather` and
    `scatter` bound the aten gather-class and scatter-class op counts (the
    HBM round trips of the beam loop). `host_syncs` bounds the run's
    data-dependent ops (what the CPU can see of host syncs, a lower bound)
    and `card_syncs` the synchronizations the card's sync-debug mode
    reports (the true count). Both sync ceilings stand at today's counts,
    so that the performance work ratchets them down. `max_programs` is a
    FAMILY budget: the distinct signatures a bucketed surface may run.
    The reference's `while_loops` has no torch meaning (see analyze.py)."""
    temp_bytes: int | None = None
    peak_bytes: int | None = None
    gather: int | None = None
    scatter: int | None = None
    host_syncs: int | None = None
    card_syncs: int | None = None
    max_programs: int | None = None
    # recorded caveat, surfaced in the fingerprint and reports (a budget
    # raised above the reference's, an aliasing that differs from it)
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One analyzable program.

    make(device) returns `(fn, args, kwargs)`: the entry point and fresh
    real tensors at the pinned geometry on `device` (fresh, because the
    state-updating programs write their state in place). `alias_expect` is
    the reference's `donate_expect` in PyTorch terms: how many leaves of
    the input state the returned state must share storage with."""
    name: str                               # e.g. "hnsw/search"
    make: Callable[[Any], tuple[Any, tuple, dict]]
    alias_expect: int = 0
    budget: ProgramBudget = ProgramBudget()
    family: str = ""                        # recompile-budget family key


_PROVIDERS: dict[str, Callable[[], list[ProgramSpec]]] = {}


def register_programs(key: str):
    """Decorator: register a provider returning this surface's specs."""
    def deco(fn: Callable[[], list[ProgramSpec]]):
        _PROVIDERS[key] = fn
        return fn
    return deco


def iter_specs(select: Iterable[str] | None = None) -> list[ProgramSpec]:
    """Materialize registered specs (from already-imported providers).

    `select` filters by exact program name OR prefix up to a "/" (so
    "hnsw" selects every hnsw/* program) OR family."""
    specs: list[ProgramSpec] = []
    for key in sorted(_PROVIDERS):
        specs.extend(_PROVIDERS[key]())
    if select is not None:
        want = set(select)
        specs = [s for s in specs
                 if s.name in want or s.name.split("/")[0] in want
                 or (s.family and s.family in want)]
    names = [s.name for s in specs]
    dup = {n for n in names if names.count(n) > 1}
    if dup:
        raise ValueError(f"duplicate program spec names: {sorted(dup)}")
    return sorted(specs, key=lambda s: s.name)


def default_specs(select: Iterable[str] | None = None) -> list[ProgramSpec]:
    """Import every provider module, then materialize specs."""
    for mod in PROVIDER_MODULES:
        importlib.import_module(mod)
    return iter_specs(select)


def spec_families(specs: Iterable[ProgramSpec]
                  ) -> dict[str, list[ProgramSpec]]:
    """Group bucketed-shape variants by family key (singletons excluded)."""
    fams: dict[str, list[ProgramSpec]] = {}
    for s in specs:
        if s.family:
            fams.setdefault(s.family, []).append(s)
    return fams
