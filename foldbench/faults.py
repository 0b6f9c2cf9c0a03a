"""Faults planted in the program's timed path, to see `correct` come out
false: each is a function of the restored pipeline (the `on_ready` of
`bench.run`) that breaks one part of it. `tests/test_foldbench_run.py`
plants each at a test's size; `control.py --fault <name>` reads one at a
cell's own size on the card."""
from __future__ import annotations

import torch

__all__ = ["FAULTS"]


def unchanged_state(pipe):
    """Insert returns with the index as it was."""
    be = pipe.backend
    be.insert = lambda sig, keep, search_ids=None: be.state.count


def half_batch(pipe):
    """Only the first half of each batch is deduplicated and inserted; the
    rest is reported admitted."""
    step = pipe.dedup_step

    def half(sig, valid=None, timers=None):
        B = sig.bitmaps.shape[0]
        first = torch.arange(B) < (B + 1) // 2
        v = first if valid is None else torch.as_tensor(valid).cpu() & first
        res = step(sig, valid=v, timers=timers)
        return res._replace(keep=res.keep | ~first.to(res.keep.device))

    pipe.dedup_step = half


def altered_answer(pipe):
    """The first admitted row of each batch is reported dropped."""
    step = pipe.dedup_step

    def altered(sig, valid=None, timers=None):
        res = step(sig, valid=valid, timers=timers)
        keep = res.keep.clone()
        kept = torch.nonzero(keep).flatten()
        if len(kept):
            keep[kept[0]] = False
        return res._replace(keep=keep)

    pipe.dedup_step = altered


def no_search_hits(pipe):
    """The index search returns no neighbours."""
    be = pipe.backend

    def search(sig):
        B, k = sig.bitmaps.shape[0], be.cfg.k
        dev = sig.bitmaps.device
        return (torch.full((B, k), -1, dtype=torch.int32, device=dev),
                torch.full((B, k), -float("inf"), device=dev))

    be.search = search


def unlinked_insert(pipe):
    """Insert adds the admitted rows but links none of them: the graph's
    edges and entry point stay as they were."""
    be = pipe.backend
    insert = be.insert

    def unlinked(sig, keep, search_ids=None):
        st = be.state
        kept = (st.neighbors.clone(), st.entry.clone(), st.top_level.clone())
        out = insert(sig, keep, search_ids=search_ids)
        be.state = be.state._replace(neighbors=kept[0], entry=kept[1],
                                     top_level=kept[2])
        return out

    be.insert = unlinked


FAULTS = {f.__name__: f for f in (unchanged_state, half_batch,
                                  altered_answer, no_search_hits,
                                  unlinked_insert)}
