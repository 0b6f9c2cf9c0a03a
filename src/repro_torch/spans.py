"""The dedup path's recorder: spans, card syncs and the recent micro-batches.

A *record* is one unit's stats dict: `process_batch`'s stats, or the
timers of an executor batch sampled by `timers_every`, while that unit
runs the split-stage path. Below an open record,

- `span(name)` times its block into `stats["spans"][name]["s"]` (and,
  given `key`, into `stats[key]`: that is how the stage timers
  `t_signature`, `t_in_batch`, `t_search`, `t_insert` are kept);
- `add(key=n)` adds a count of the work done to the innermost span's
  entry (the insert's commit adds its back-links and their groups, as
  `links` and `groups`, the insert the rows it placed in reclaimed slots,
  as `reused`);
- a record closed may be opened again: `repro_torch.lifecycle`'s expiry
  and compaction run after `process_batch` has returned, and their spans
  (`lifecycle.expire`, `lifecycle.compact` and, inside the latter,
  `compact.repair`, `compact.unlink` and `compact.free`) join the spans of
  the batch after which they ran;
- every host read of device data on the path (a `.cpu()`, a `bool()` or
  `int()` of a tensor, a `torch.nonzero`, an upload of a host array) goes
  through `sync()`, which adds one to the `syncs` of the innermost open
  span; the helpers below call it and then make the read. Each such read
  is a synchronisation on a card, one that
  `torch.cuda.set_sync_debug_mode` reports. The stage timers' own waits
  (`span.ready`) are not counted. The count is taken on any device, so a
  CPU run counts the same reads, though none of them waits there.
- while a `torch.profiler` is recording, each span also opens
  `torch.profiler.record_function(name)`, so that the program's spans lie
  in the same trace as the device's operations.

With no record open, a span and `sync()` do nothing.

The fused route (`hnsw_sharded`) is timed whole by its caller and attaches
no `spans` key to its stats.

`recent()` returns the records of the last `RING` units, oldest first:
each `process_batch` of the split-stage path leaves {"spans": its spans},
and each micro-batch the service materializes leaves its first doc id,
its number of documents, the documents' mean wait in the batcher (from
`add` to the batch's emit), the executor's `dispatch_s` (submit's own
time, until `dedup_step` returns) and `held_s` (from then until the
verdicts have left the device), and, where the batch was sampled, its
spans. The ring and the open record are the process's own: one dedup
path's recorder, as the profiler is.
"""
from __future__ import annotations

import collections
import time
from typing import Any

import numpy as np
import torch

__all__ = ["KEY", "RING", "span", "ready", "sync", "add", "nonzero", "to_host",
           "truth", "to_int", "upload", "to_device", "finished", "emitted", "materialized",
           "recent"]

KEY = "spans"          # the stats key that holds a record's spans
RING = 4096            # micro-batch records kept

_profiling = torch._C._autograd._profiler_enabled
_clock = time.perf_counter


class _Record:
    __slots__ = ("stats", "spans", "stack", "attach")

    def __init__(self, stats: dict, attach: bool):
        self.stats = stats
        # a record opened again (the lifecycle's spans after its batch)
        # adds to the spans it holds
        self.spans: dict[str, dict] = stats.get(KEY, {})
        self.stack: list[dict] = []
        self.attach = attach


_open: _Record | None = None


def ready(x: Any) -> None:
    """Wait for the device work behind a CUDA tensor; no-op otherwise."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


class span:
    """Time a block as `name` under the open record (see the module
    docstring). `record=stats` opens `stats` as the record for the block,
    and the span is its root; where `stats` is the open record already,
    the span does nothing. `attach=False` keeps the `spans` key out of
    the record."""

    __slots__ = ("name", "key", "record", "attach", "t0", "entry",
                 "prof", "opened")

    def __init__(self, name: str, key: str | None = None, *,
                 record: dict | None = None, attach: bool = True):
        self.name = name
        self.key = key
        self.record = record
        self.attach = attach
        self.entry: dict | None = None
        self.prof = None
        self.opened: tuple | None = None

    def __enter__(self) -> "span":
        global _open
        if self.record is not None:
            if _open is not None and _open.stats is self.record:
                return self
            self.opened = (_open,)
            _open = _Record(self.record, self.attach)
        rec = _open
        if rec is not None:
            if _profiling():
                self.prof = torch.autograd.profiler.record_function(
                    self.name)
                self.prof.__enter__()
            self.entry = rec.spans.setdefault(self.name, {"s": 0.0,
                                                          "syncs": 0})
            rec.stack.append(self.entry)
            self.t0 = _clock()
        return self

    def ready(self, x: Any) -> None:
        """End the block's device work before its clock stops: the stage
        timers' wait, made only under an open record, and not counted."""
        if self.entry is not None:
            ready(x)

    def __exit__(self, *exc) -> None:
        global _open
        if self.entry is not None:
            dt = _clock() - self.t0
            self.entry["s"] += dt
            rec = _open
            rec.stack.pop()
            if self.key is not None:
                rec.stats[self.key] = dt
        if self.prof is not None:
            self.prof.__exit__(*exc)
        if self.opened is not None:
            rec, _open = _open, self.opened[0]
            if rec.attach:
                rec.stats[KEY] = rec.spans


def sync() -> None:
    """Count one card sync, made by the host read that follows."""
    # the span that opened the record is on its stack until it closes
    if _open is not None:
        _open.stack[-1]["syncs"] += 1


def add(**counts: int) -> None:
    """Add counts of the work a span did (the commit's `links` and
    `groups`) to the innermost open span's entry."""
    if _open is not None:
        entry = _open.stack[-1]
        for key, n in counts.items():
            entry[key] = entry.get(key, 0) + n


# -- the counted host reads ---------------------------------------------------
def nonzero(mask: torch.Tensor) -> torch.Tensor:
    """1-D int64 indices of the True entries of a 1-D mask."""
    sync()
    return torch.nonzero(mask).squeeze(1)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array."""
    sync()
    return t.cpu().numpy()


def truth(t: torch.Tensor) -> bool:
    sync()
    return bool(t)


def to_int(t: torch.Tensor) -> int:
    sync()
    return int(t)


def upload(a: Any, device: torch.device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) as a tensor on `device`."""
    sync()
    return (torch.from_numpy(a) if isinstance(a, np.ndarray) else a).to(device)


def to_device(x: Any, device: torch.device) -> torch.Tensor:
    """`x` as a tensor on `device`: an upload, unless `x` is a tensor on
    such a device already."""
    if not (isinstance(x, torch.Tensor) and x.device.type == device.type):
        sync()
    return torch.as_tensor(x, device=device)


# -- the service's micro-batches ---------------------------------------------
_ring: collections.deque = collections.deque(maxlen=RING)
# emitted, not yet materialized: id(doc_ids) -> (doc_ids, record); the
# array is held so that its id names it alone
_emitted: collections.OrderedDict = collections.OrderedDict()


def finished(stats: dict) -> None:
    """A `process_batch` finished: its spans join the ring."""
    _ring.append({KEY: stats[KEY]})


def emitted(doc_ids: np.ndarray, n_docs: int, wait_s: float) -> None:
    """The batcher emitted a micro-batch whose `n_docs` documents waited
    `wait_s` on average since their `add`."""
    _emitted[id(doc_ids)] = (doc_ids, {"first_id": int(doc_ids[0]),
                                       "docs": int(n_docs),
                                       "wait_s": float(wait_s)})
    if len(_emitted) > RING:
        _emitted.popitem(last=False)


def materialized(doc_ids: np.ndarray, n_docs: int, dispatch_s: float,
                 held_s: float, sampled: dict | None = None) -> None:
    """The executor materialized a micro-batch: its record joins the ring,
    with the spans of its `sampled` timers, where it was sampled."""
    got = _emitted.pop(id(doc_ids), None)
    if got is not None:
        rec = got[1]
    else:
        rec = {"first_id": int(doc_ids[0]) if len(doc_ids) else -1,
               "docs": int(n_docs)}
    rec["dispatch_s"] = dispatch_s
    rec["held_s"] = held_s
    if sampled and KEY in sampled:
        rec[KEY] = sampled[KEY]
    _ring.append(rec)


def recent() -> list[dict]:
    """The last units' records, oldest first."""
    return list(_ring)
