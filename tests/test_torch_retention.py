"""The retention window on the port's normal path: `LifecycleManager` over
`FoldPipeline` against the benchmark's windowed reference
(`foldbench/reference/window.py`), and a manager restored from a snapshot
mid-cycle, through its own `save`/`load` and through the service's
`restore_latest`, against an unbroken run.

At this size `ef_search` covers every slot, so the index search finds
every live document and the verdicts are the exact windowed pipeline's."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

# the benchmark's package lies at the root of the repository
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from foldbench.reference import window  # noqa: E402
from foldbench.traffic.generate import Stream, load_mix, pad, prefill_batches  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.core.dedup import FoldConfig, FoldPipeline  # noqa: E402
from repro_torch.lifecycle import LifecycleManager  # noqa: E402
from repro_torch.service import DedupService, ServiceConfig  # noqa: E402

CFG = dict(capacity=256, M=8, M0=16, ef_construction=32, ef_search=256)
TTL = 3                       # batches a document stays live
WATERMARK = 0.1               # compact at 26 tombstones of 256 slots
BATCH = 24


def _docs(n_batches: int, seed: int = 2**31 + 5) -> list:
    """Documents per batch: two batches of the Common Crawl preset, then
    the re-crawl mix (half light edits of those, drawn uniformly; half the
    stream continued)."""
    mix = load_mix("cc-recrawl")
    pre = {"docs": 2 * BATCH, "batch_docs": BATCH, "seed": 3}
    docs = [[t[i, :ln[i]] for i in range(len(ln))]
            for t, ln in prefill_batches(mix, pre)]
    stream = Stream(mix, pre, seed)
    return docs + [stream.docs(BATCH) for _ in range(n_batches - 2)]


def _run(pipe, mgr, docs, deletes=None, reused=None) -> list:
    keeps = []
    for batch in docs:
        keep, stats = pipe.process_batch(*pad(batch))
        if deletes is not None:
            deletes.append([])
        mgr.after_batch(record=stats)
        if reused is not None:
            reused.append(stats[spans.KEY]["insert"].get("reused", 0))
        keeps.append(keep)
    return keeps


def _logging_deletes(pipe, log: list) -> None:
    """Every delete's slots, sorted, into the last entry of `log`."""
    be = pipe.backend
    delete = be.delete

    def logged(ids):
        log[-1].append(sorted(int(i) for i in ids))
        return delete(ids)

    be.delete = logged


def test_lifecycle_manager_equals_the_windowed_reference():
    docs = _docs(16)
    cfg = FoldConfig(**CFG)
    pipe = FoldPipeline(cfg, device="cpu")
    mgr = LifecycleManager(pipe, ttl_steps=TTL, compact_watermark=WATERMARK)
    reused: list = []
    keeps = _run(pipe, mgr, docs, reused=reused)
    want, live = window.truth(docs, dataclasses.asdict(cfg),
                              {"lifecycle": {"ttl_batches": TTL}},
                              device="cpu")
    for i, (got, exp) in enumerate(zip(keeps, want)):
        assert got.tolist() == exp.tolist(), i
    assert pipe.inserted == live == mgr.stats()["tracked_live"]
    assert mgr.n_compactions >= 2 and mgr.n_expired > 0
    assert sum(reused) > 0                  # reclaimed slots were reused
    assert pipe.capacity == CFG["capacity"]


def test_restored_manager_expires_as_an_unbroken_run(tmp_path):
    """The index and the ledger saved after batch 4 (expiry under way, no
    compaction yet) and restored into a new pipeline and manager: the
    same slots are deleted at the same batches, compactions included, and
    the verdicts are the same."""
    docs = _docs(14)
    cut = 4
    runs = []
    for restored in (False, True):
        pipe = FoldPipeline(FoldConfig(**CFG), device="cpu")
        mgr = LifecycleManager(pipe, ttl_steps=TTL,
                               compact_watermark=WATERMARK)
        deletes: list = []
        _logging_deletes(pipe, deletes)
        keeps = _run(pipe, mgr, docs[:cut], deletes)
        assert mgr.n_expired > 0 and mgr.n_compactions == 0
        if restored:
            pipe.save(str(tmp_path), 0)
            mgr.save(str(tmp_path), 0)
            pipe = FoldPipeline(FoldConfig(**CFG), device="cpu")
            pipe.restore(str(tmp_path))
            mgr = LifecycleManager(pipe, ttl_steps=TTL,
                                   compact_watermark=WATERMARK)
            assert mgr.load(str(tmp_path), 0)
            _logging_deletes(pipe, deletes)
        keeps += _run(pipe, mgr, docs[cut:], deletes)
        runs.append((keeps, deletes, mgr.stats(), pipe.inserted))
    (k0, d0, s0, n0), (k1, d1, s1, n1) = runs
    assert d1 == d0
    assert [k.tolist() for k in k1] == [k.tolist() for k in k0]
    assert s0["n_compactions"] >= 1
    assert {k: v for k, v in s1.items() if not k.startswith("t_")} == \
        {k: v for k, v in s0.items() if not k.startswith("t_")}
    assert n1 == n0


def _service(directory, **over) -> DedupService:
    return DedupService(ServiceConfig(
        fold=FoldConfig(**CFG), device="cpu", max_batch=32, max_wait_ms=0.0,  # foldlint: disable=F141 (the port's ServiceConfig adds device)
        batch_buckets=(32,), len_buckets=(512,), stage_timer_every=1,
        pipeline_depth=0, ttl_steps=TTL, compact_watermark=WATERMARK,
        snapshot_dir=str(directory), max_snapshots=2, **over))


def _first_deletions(log: list, slots) -> list:
    """Each delete's slots that held a document of `slots` (a slot freed
    and reused later holds another)."""
    left, out = set(int(x) for x in slots), []
    for call in log:
        hit = [x for x in call if x in left]
        left -= set(hit)
        out.append(hit)
    return out


@pytest.mark.parametrize("every,cut", [(2, 5), (3, 7)])
def test_service_restore_latest_carries_the_ledger(tmp_path, every, cut):
    """A service that snapshots every few micro-batches, restarted from its
    latest snapshot, deletes the slots of the documents admitted before
    the snapshot at the same batches as the unbroken service (the
    snapshot's own batch, whose expiry ran after the snapshot was written,
    is expired on load). Before any compaction the restarted service
    deletes exactly what the unbroken one does; after one, the slots of
    later documents may differ, since a restored index takes back the
    reclaimed slots an insert was offered and left unused."""
    docs = _docs(14)
    svc = _service(tmp_path / "a", snapshot_every=every)
    marks: list = []           # (deletes made, compactions) at each snapshot
    deletes: list = [[]]
    _logging_deletes(svc.pipeline, deletes)
    snap = svc.index_manager.snapshot

    def marked(sync=True):
        marks.append((len(deletes[-1]), svc.lifecycle.n_compactions))
        return snap(sync)

    svc.index_manager.snapshot = marked
    for batch in docs:
        svc.submit(*pad(batch))
        svc.flush()
    unbroken = deletes[-1]

    first = _service(tmp_path / "b", snapshot_every=every)
    for batch in docs[:cut]:
        first.submit(*pad(batch))
        first.flush()
    step = first.index_manager.committed_steps()[-1]
    done = step * every                 # the micro-batches of the snapshot
    at, compacted = marks[step - 1]
    with np.load(tmp_path / "b" / f"lifecycle_{step:08d}.npz") as z:
        before = np.concatenate([z["slots"], z["pending_slots"]])
    again = _service(tmp_path / "b", snapshot_every=0)
    log: list = [[]]
    _logging_deletes(again.pipeline, log)
    assert again.index_manager.restore_latest() == step
    for batch in docs[done:]:
        again.submit(*pad(batch))
        again.flush()
    got = log[-1]
    assert len(got) == len(unbroken) - at > 0
    assert _first_deletions(got, before) == \
        _first_deletions(unbroken[at:], before)
    assert sum(map(len, _first_deletions(got, before))) == len(before)
    if not compacted:
        assert got == unbroken[at:]
    assert again.lifecycle.stats()["n_expired"] == \
        svc.lifecycle.stats()["n_expired"]
    assert again.pipeline.inserted == svc.pipeline.inserted
    assert again.lifecycle.stats()["tracked_live"] == again.pipeline.inserted
    seen = [r.get(spans.KEY, {}) for r in spans.recent()]
    assert any("lifecycle.expire" in s for s in seen)
