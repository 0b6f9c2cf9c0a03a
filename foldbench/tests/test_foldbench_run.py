"""A whole run of each cell at a size the CPU holds: the result line's
fields, and `correct` false under each fault the cells can have
(`foldbench/faults.py`), planted in the timed path once the prefill is
restored. The control is tested in `test_foldbench_control.py`."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from foldbench import bench
from foldbench.faults import FAULTS
from foldbench.tests._tiny import tiny_run

CELLS = [c["name"] for c in bench.load_spec()["workloads"]]
# every cell can have these; an unlinked insert shows only where the window
# duplicates documents admitted after it was planted, as cc-ingest's stream
# does at a test's size (its duplicates come from the last 4,096 documents)
EVERY_CELL = ["unchanged_state", "half_batch", "altered_answer",
              "no_search_hits"]
UNLINKED_CELLS = ["fold-hnsw-256k.cc-ingest"]
# a search that finds nothing still lets the in-batch sweep catch a batch's
# own duplicates; a longer history keeps those few beside the index's
PREFILL_DOCS = {"no_search_hits": 256}
TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("prefill")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, cache):
    r = tiny_run(cell, cache, control=True)
    assert list(r)[:5] == TOP_KEYS and list(r)[-1] == "checks"
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    spec = bench.load_spec()
    want = {m["name"] for m in bench.cell_metrics(spec, cell, False)}
    assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) in ({"value", "max"}, {"value", "min"})
    assert set(r["control"]) == {"correct", "checks", "counts"}
    json.dumps(r)


@pytest.mark.parametrize("fault", EVERY_CELL)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_in_the_timed_path_is_not_correct(cell, fault, cache):
    r = tiny_run(cell, cache, seconds=3.0, on_ready=FAULTS[fault],
                 prefill_docs=PREFILL_DOCS.get(fault, 32))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", UNLINKED_CELLS)
def test_unlinked_insert_is_not_correct(cell, cache):
    # long enough that most of the window's duplicates are of documents
    # admitted after the fault was planted, on a loaded machine too: the
    # fault shows from the window's 8th batch on, and beside two busy
    # processes a batch takes over a second
    r = tiny_run(cell, cache, seconds=12.0,
                 on_ready=FAULTS["unlinked_insert"])
    assert not r["correct"], r["checks"]
    assert r["checks"]["recall"]["value"] < r["checks"]["recall"]["min"]


def test_every_fault_is_tested():
    assert set(FAULTS) == set(EVERY_CELL) | {"unlinked_insert"}


def test_traced_run_reports_per_layer_metrics_and_breakdown(cache):
    cell = CELLS[0]
    r = tiny_run(cell, cache, trace=True)
    assert r["correct"], r["checks"]
    spec = bench.load_spec()
    allowed = {m["name"] for m in bench.cell_metrics(spec, cell, True)}
    assert set(r["metrics"]) <= allowed
    assert {"stage.signature_ms", "stage.insert_ms"} <= set(r["metrics"])
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(r)[-1] == "checks"


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, os.path.join(bench.ROOT, "foldbench", "run.py"),
         "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=bench.ROOT,
        env=env, timeout=120)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_judge_counts_each_guarantee():
    from foldbench.reference import exact
    g = torch.Generator().manual_seed(0)
    bits = (torch.rand((6, 64), generator=g) < 0.2).float()
    bits[1] = bits[0]                      # an in-batch duplicate of row 0
    bits[4] = bits[2]                      # row 4 repeats row 2
    pcs = bits.sum(1).to(torch.int64)
    batches = [(bits[:3], pcs[:3]), (bits[3:], pcs[3:])]
    keeps, kibs = exact.exact_pipeline(batches, 0.7)
    assert keeps[0].tolist() == [True, False, True]
    assert keeps[1].tolist() == [True, False, True]
    good = exact.judge(batches, keeps, 1, 0.7)
    assert good["batch_dup_kept"] == good["unjustified"] == 0
    assert good["recall"] == 1.0
    bad = exact.judge(batches, [keeps[0], np.array([False, True, True])],
                      1, 0.7)
    assert bad["unjustified"] == 1 and bad["recall"] == 0.0
    missing = exact.judge(batches, [keeps[0], None], 1, 0.7)
    assert missing["missing"] == 3
