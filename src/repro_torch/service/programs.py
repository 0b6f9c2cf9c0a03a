"""Service-surface program specs: the bucketed-shape search family (port
of `repro/service/programs.py`).

The service's MicroBatcher pads every emitted batch to the
`default_batch_buckets` menu so that the number of distinct programs is
bounded for the process lifetime. This module turns that promise into an
analyzable artifact: one ProgramSpec per bucket, all in the
`service/search` FAMILY, whose budget (`max_programs`) is the menu size
itself. If a refactor adds an unbucketed shape to the hot path, the
family's distinct-signature count diverges from the menu and the gate
fails F161; if two buckets collapse to the same signature, the menu has a
redundant entry and F161 fails the other way.

The variants share the index-side spec geometry and filled index with
`hnsw/search` (repro_torch.index.backends.hnsw): only the batch dimension
varies, exactly what varies in serving.
"""
from __future__ import annotations

from repro_torch.analysis.programs import (ProgramBudget, ProgramSpec,
                                           register_programs)
from repro_torch.core.hnsw import hnsw_search
from repro_torch.service.batcher import default_batch_buckets

__all__ = ["SPEC_MAX_BATCH"]

# Pinned to the ServiceConfig default; the largest variant and
# "hnsw/search" differ only in name.
SPEC_MAX_BATCH = 128
_SPEC_CAP = 8192
_SPEC_K = 4


# temp ceilings over the reference's 24,000,000, at the card's measurement
# rounded up (the search's materialized per-step temporaries grow with B)
_TEMP_OVER = {64: 40_000_000, 128: 80_000_000}


def _variant(B: int, n_buckets: int) -> ProgramSpec:
    def make(device):
        from repro_torch.analysis.inputs import spec_index
        ix = spec_index(_SPEC_CAP).on(device)
        return (hnsw_search, (ix.cfg, ix.state, ix.queries[:B]),
                {"k": _SPEC_K})
    return ProgramSpec(
        name=f"service/search_b{B:03d}", make=make,
        alias_expect=0, family="service/search",  # foldlint: disable=F141 (the port's ProgramSpec: alias_expect)
        budget=ProgramBudget(
            temp_bytes=_TEMP_OVER.get(B, 24_000_000), max_programs=n_buckets,
            host_syncs=29, card_syncs=29,
            note="one program per batch bucket, for the service lifetime"
                 + ("; temp ceiling over the reference's 24,000,000 (the "
                    "search's per-step temporaries)" if B in _TEMP_OVER
                    else "")))


@register_programs("service")
def _service_programs() -> list[ProgramSpec]:
    buckets = default_batch_buckets(SPEC_MAX_BATCH)
    return [_variant(B, len(buckets)) for B in buckets]
