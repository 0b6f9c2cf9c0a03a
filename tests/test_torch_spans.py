"""The dedup path's recorder (`repro_torch.spans`) on the CPU: the insert's
three phases, the sync counts, the record's bounds (no record, the fused
route) and the service's micro-batch records. The count against
`torch.cuda.set_sync_debug_mode` is a card test (tests/test_torch_cuda.py)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro_torch import spans
from repro_torch.core.dedup import FoldConfig, FoldPipeline
from repro_torch.core.hnsw import hnsw_insert_batch
from repro_torch.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro_torch.index import make_pipeline
from repro_torch.service import DedupService, ServiceConfig
from repro_torch.service.batcher import MicroBatcher
from repro_torch.service.executor import PipelinedExecutor

FOLD = dict(capacity=2048, M=8, M0=16, ef_construction=32, ef_search=32)
PHASES = ("insert.discover", "insert.merge", "insert.commit")


def _stream(n_batches, batch=96, seed=0):
    src = SyntheticCorpus(dataclasses.replace(
        DATASET_PRESETS["common_crawl"], seed=seed))
    return [src.next_batch(batch)[:2] for _ in range(n_batches)]


def _run(batches):
    pipe = FoldPipeline(FoldConfig(**FOLD), device="cpu")
    return [pipe.process_batch(t, ln)[1] for t, ln in batches]


def test_insert_phases_cover_the_insert():
    for st in _run(_stream(4, batch=128)):
        rec = st[spans.KEY]
        assert spans.recent()[-4:].count({spans.KEY: rec}) == 1
        secs = [rec[p]["s"] for p in PHASES]
        assert all(s >= 0 for s in secs)
        # the insert dominates a batch here; its phases are nearly all of it
        assert 0.9 * st["t_insert"] <= sum(secs) <= st["t_insert"]
        for stage in ("signature", "in_batch", "search", "insert"):
            assert rec[stage]["s"] == st[f"t_{stage}"]


def test_sync_counts_are_fixed_by_the_data():
    batches = _stream(3)
    runs = [_run(batches) for _ in range(2)]
    for a, b in zip(*runs):
        counts = [{k: v["syncs"] for k, v in st[spans.KEY].items()}
                  for st in (a, b)]
        assert counts[0] == counts[1]
        # the search loops once per beam step; the commit reads its arrays
        # back in one copy and uploads its plan in one
        assert counts[0]["search"] > 0 and counts[0]["insert.discover"] > 0
        assert counts[0]["insert.commit"] == 2


def test_no_record_no_keys_and_no_ring_entry():
    pipe = FoldPipeline(FoldConfig(**FOLD), device="cpu")
    tok, ln = _stream(1)[0]
    sig = pipe.signatures(tok, ln)
    be = pipe.backend
    ring = spans.recent()
    with spans.span("alone", "t_alone") as sp:
        spans.sync()
        be.state, _ = hnsw_insert_batch(
            be.hnsw_cfg, be.state, sig.bitmaps, sig.pcs,
            np.zeros(len(ln), np.int32), np.ones(len(ln), bool))
    assert sp.entry is None and spans._open is None
    res = pipe.dedup_step(sig)            # no timers: no record either
    assert res.keep.shape == (len(ln),) and spans._open is None
    assert spans.recent() == ring


def test_nested_spans_count_in_the_innermost():
    stats = {}
    with spans.span("outer", record=stats):
        spans.sync()
        with spans.span("inner", "t_inner"):
            spans.sync()
            spans.sync()
        with spans.span("outer", record=stats):   # the open record again
            spans.sync()
    got = {k: v["syncs"] for k, v in stats[spans.KEY].items()}
    assert got == {"outer": 2, "inner": 2}
    assert stats["t_inner"] == stats[spans.KEY]["inner"]["s"] >= 0
    kept = {}
    with spans.span("outer", record=kept, attach=False):
        with spans.span("inner", "t_inner"):
            spans.sync()
    assert list(kept) == ["t_inner"]


def test_fused_route_keeps_the_reference_keys():
    fold = dict(FOLD, capacity=512, tau=0.7, threshold_space="minhash")
    port = make_pipeline("hnsw_sharded", FoldConfig(**fold), device="cpu")  # foldlint: disable=F131 (the port's factories add device)
    b1, b2 = _stream(2, seed=3)
    timers = {}
    port.dedup_step(port.signatures(*b1), timers=timers)
    assert sorted(timers) == ["t_fused_step", "t_in_batch", "t_insert",
                              "t_search"]
    _, stats = port.process_batch(*b2)
    assert spans.KEY not in stats and "t_fused_step" in stats


@pytest.mark.parametrize("depth", [0, 2])
def test_dispatch_and_hold_make_the_wall(depth):
    pipe = FoldPipeline(FoldConfig(**FOLD), device="cpu")
    outs = []
    ex = PipelinedExecutor(pipe, depth=depth, on_outcome=outs.append,
                           timers_every=2)
    batcher = MicroBatcher(max_batch=32, max_wait_ms=0.0)
    tok, ln = _stream(1, batch=100)[0]
    batcher.add_many(range(1000, 1100), tok, ln)
    sent = batcher.drain(force=True)
    for mb in sent:
        ex.submit(mb)
    ex.drain()
    assert len(outs) == len(sent) == 4
    ring = {r["first_id"]: r for r in spans.recent() if "first_id" in r}
    for out in outs:
        assert out.dispatch_s + out.held_s == out.wall_s
        assert out.dispatch_s > 0 and out.held_s > 0
        r = ring[int(out.batch.doc_ids[0])]
        assert r["dispatch_s"] == out.dispatch_s and r["held_s"] == out.held_s
        assert r["docs"] == out.batch.n_docs and r["wait_s"] >= 0
    # a sampled batch's timers are its record, and its spans join the ring
    sampled = [o for o in outs if o.stage_times]
    assert sampled
    for o in sampled:
        rec = o.stage_times[spans.KEY]
        assert set(rec) >= {"step", "in_batch", "search", "insert",
                            *PHASES}
        assert ring[int(o.batch.doc_ids[0])][spans.KEY] is rec


def test_service_records_every_micro_batch():
    svc = DedupService(ServiceConfig(fold=FoldConfig(**FOLD), device="cpu",  # foldlint: disable=F141 (the port's ServiceConfig adds device)
                                     max_batch=32, max_wait_ms=0.0,
                                     stage_timer_every=2))
    tok, ln = _stream(1, batch=80)[0]
    first = svc.next_doc_id
    seen = []
    svc.outcome_hooks.append(seen.append)
    svc.submit(tok, ln)
    svc.flush()
    ring = {r["first_id"]: r for r in spans.recent() if "first_id" in r}
    assert sum(o.batch.n_docs for o in seen) == 80
    assert int(seen[0].batch.doc_ids[0]) == first
    for o in seen:
        r = ring[int(o.batch.doc_ids[0])]
        assert r["dispatch_s"] + r["held_s"] == o.wall_s
    assert "t_insert_ms" in svc.stats()["latency_ms"]
