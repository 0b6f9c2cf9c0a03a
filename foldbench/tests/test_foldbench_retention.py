"""The retention window's cell at a test's size: the `retention` driver
runs the program's `LifecycleManager` after every batch, the `window`
reference judges it, a sound run is correct and its control is not, and
two faults of the lifecycle make `correct` false: an expiry that deletes
nothing (`index_gap`) and a search that returns tombstoned slots
(`unjustified`). The window is cut to two batches and the watermark to 1%
of the 4,096 slots, so that documents expire and the index compacts within
a test's window; the readers of the lifecycle's spans against synthetic
records."""
from __future__ import annotations

import pytest

from foldbench import bench
from foldbench.metrics import _spans
from foldbench.tests._tiny import tiny_run

CELL = "fold-ttl-256k.cc-recrawl"
LIFECYCLE = {"lifecycle": {"ttl_batches": 2, "compact_watermark": 0.01,
                           "max_live_docs": None}}
PREFILL = 128                   # four batches: documents expire in it
KEEPS_GHOSTS = {"lifecycle": {**LIFECYCLE["lifecycle"],
                              "compact_watermark": 1.0}}
READERS = ["lifecycle.expire_ms", "lifecycle.compact_ms",
           "lifecycle.compact_rows", "lifecycle.syncs", "insert.reused"]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("retention")


def _run(cache, **kw):
    kw.setdefault("config_update", LIFECYCLE)
    return tiny_run(CELL, cache, seconds=kw.pop("seconds", 4.0),
                    prefill_docs=PREFILL, **kw)


def test_sound_run_is_correct_and_its_control_is_not(cache):
    r = _run(cache, control=True, trace=True)
    assert r["correct"], r["checks"]
    assert r["checks"]["index_gap"]["value"] == 0
    assert not r["control"]["correct"], r["control"]
    assert r["control"]["checks"]["unjustified"]["value"] > 0
    m = r["metrics"]
    assert {"lifecycle.expire_ms", "lifecycle.syncs",
            "insert.reused"} <= set(m)
    assert m["lifecycle.syncs"]["value"] > 0
    entry = next(p for p in cache.iterdir() if p.is_dir())
    assert (entry / "lifecycle_00000000.npz").is_file()


def _deletes_nothing(pipe):
    pipe.backend.delete = lambda ids: 0


def _finds_tombstones(monkeypatch):
    def plant(pipe):
        from repro_torch.core import hnsw
        monkeypatch.setattr(hnsw, "_mask_dead_sorted",
                            lambda state, ids, d: (ids, d))
    return plant


def test_expiry_that_deletes_nothing_is_not_correct(cache):
    r = _run(cache, on_ready=_deletes_nothing)
    assert not r["correct"], r["checks"]
    assert r["checks"]["index_gap"]["value"] > 0


def test_search_that_returns_tombstones_is_not_correct(tmp_path,
                                                       monkeypatch):
    # no compaction, so that expired documents stay in the graph
    r = _run(tmp_path, config_update=KEEPS_GHOSTS, seconds=6.0,
             on_ready=_finds_tombstones(monkeypatch))
    assert not r["correct"], r["checks"]
    assert r["checks"]["unjustified"]["value"] > 0


def _batch(expire, compact=None, reused=None):
    spans = {"batch": {"s": 0.2, "syncs": 4},
             "insert": {"s": 0.1, "syncs": 1},
             "lifecycle.expire": {"s": expire, "syncs": 4, "expired": 9}}
    if reused is not None:
        spans["insert"]["reused"] = reused
    if compact is not None:
        spans["lifecycle.compact"] = {"s": compact, "syncs": 2,
                                      "rows": int(compact * 1e4),
                                      "reclaimed": 50}
    return {"t_insert": 0.1, "spans": spans}


def test_lifecycle_readers():
    n = _spans.SYNC_BATCHES + 4
    stages = [_batch(0.001 * (i + 1), reused=i) for i in range(n)]
    stages[3] = _batch(0.004, compact=0.5, reused=3)
    stages[9] = _batch(0.010, compact=0.3, reused=9)
    rec = {"stages": stages}
    mean_expire = sum(0.001 * (i + 1) for i in range(n)) / n * 1e3
    assert bench.read_metric("lifecycle.expire_ms", rec) == pytest.approx(
        mean_expire)
    assert bench.read_metric("lifecycle.compact_ms", rec) == pytest.approx(
        400.0)
    assert bench.read_metric("lifecycle.compact_rows", rec) == 4000
    assert bench.read_metric("lifecycle.syncs", rec) == 4
    assert bench.read_metric("insert.reused", rec) == pytest.approx(
        (n - 1) / 2)
    rec = {"stages": [_batch(0.001) for _ in range(3)]}
    assert bench.read_metric("lifecycle.compact_ms", rec) is None
    assert bench.read_metric("lifecycle.compact_rows", rec) is None
    assert bench.read_metric("insert.reused", rec) is None


@pytest.mark.parametrize("name", READERS)
def test_lifecycle_readers_read_nothing_without_spans(name):
    assert bench.read_metric(name, {}) is None
    assert bench.read_metric(name, {"stages": []}) is None
    plain = {"t_insert": 0.1, "spans": {"insert": {"s": 0.1, "syncs": 1}}}
    assert bench.read_metric(name, {"stages": [plain, plain]}) is None
