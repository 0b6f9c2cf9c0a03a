"""The readers of the program's spans and sync counts, on synthetic
records: the value each should give, and None where the program keeps no
record (as a program without `repro_torch.spans` keeps none)."""
from __future__ import annotations

import sys
import types

import numpy as np
import pytest

from foldbench import bench
from foldbench.metrics import _spans

INGEST = ["insert.discover_ms", "insert.merge_ms", "insert.commit_ms",
          "search.syncs", "insert.syncs"]
SERVICE = ["executor.dispatch_ms", "executor.held_ms", "batcher.wait_ms"]


def _batch(i):
    return {"t_insert": 0.1, "spans": {
        "batch": {"s": 0.2, "syncs": 4},
        "search": {"s": 0.01, "syncs": 10 + i},
        "insert": {"s": 0.1, "syncs": 1},
        "insert.discover": {"s": 0.06 + 0.002 * i, "syncs": 100},
        "insert.merge": {"s": 0.004, "syncs": 1},
        "insert.commit": {"s": 0.03, "syncs": 10}}}


def test_ingest_readers():
    n = _spans.SYNC_BATCHES + 4
    rec = {"stages": [_batch(i) for i in range(n)]}
    mean_i = (n - 1) / 2
    assert bench.read_metric("insert.discover_ms", rec) == pytest.approx(
        (0.06 + 0.002 * mean_i) * 1e3)
    assert bench.read_metric("insert.merge_ms", rec) == pytest.approx(4.0)
    assert bench.read_metric("insert.commit_ms", rec) == pytest.approx(30.0)
    # the sync counts read the window's first batches only
    first = (_spans.SYNC_BATCHES - 1) / 2
    assert bench.read_metric("search.syncs", rec) == pytest.approx(10 + first)
    assert bench.read_metric("insert.syncs", rec) == 112


@pytest.mark.parametrize("name", INGEST)
def test_ingest_readers_read_nothing_without_spans(name):
    assert bench.read_metric(name, {}) is None
    assert bench.read_metric(name, {"stages": []}) is None
    old = [{"t_insert": 0.1}, _batch(0)]        # a batch with no record
    assert bench.read_metric(name, {"stages": old}) is None


def _service(monkeypatch, ring):
    prog = types.ModuleType("repro_torch.spans")
    prog.recent = lambda: list(ring)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", prog)


def _micro(first, n):
    return {"ids": np.arange(first, first + n), "wall_s": 0.5}


def test_service_readers(monkeypatch):
    ring = [{"first_id": 0, "docs": 8, "wait_s": 0.9, "dispatch_s": 9.0,
             "held_s": 9.0},                    # a warm-up batch
            {"spans": {}},                      # a process_batch's record
            {"first_id": 8, "docs": 10, "wait_s": 0.004, "dispatch_s": 0.2,
             "held_s": 0.3},
            {"first_id": 18, "docs": 30, "wait_s": 0.008, "dispatch_s": 0.1,
             "held_s": 0.5}]
    _service(monkeypatch, ring)
    rec = {"micro": [_micro(8, 10), _micro(18, 30)]}
    assert bench.read_metric("executor.dispatch_ms", rec) == \
        pytest.approx(150.0)
    assert bench.read_metric("executor.held_ms", rec) == pytest.approx(400.0)
    assert bench.read_metric("batcher.wait_ms", rec) == \
        pytest.approx((0.004 * 10 + 0.008 * 30) / 40 * 1e3)


@pytest.mark.parametrize("name", SERVICE)
def test_service_readers_read_nothing_without_every_record(name,
                                                           monkeypatch):
    rec = {"micro": [_micro(8, 10), _micro(18, 30)]}
    monkeypatch.delitem(sys.modules, "repro_torch.spans", raising=False)
    assert bench.read_metric(name, rec) is None
    # one of the window's micro-batches has fallen out of the ring
    _service(monkeypatch, [{"first_id": 18, "docs": 30, "wait_s": 0.0,
                            "dispatch_s": 0.1, "held_s": 0.1}])
    assert bench.read_metric(name, rec) is None
    assert bench.read_metric(name, {}) is None
