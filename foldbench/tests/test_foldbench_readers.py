"""The readers of the window's own clock, on synthetic records: the value
each should give, and None where the run holds nothing for it to read."""
from __future__ import annotations

import pytest

from foldbench import bench


def test_closed_loop_rate_is_every_document_over_the_whole_window():
    rec = {"window_start": 10.0, "done": [10.5, 11.0, 13.0],
           "docs": [512, 512, 256]}
    assert bench.read_metric("entry.docs_per_s", rec) == pytest.approx(
        1280 / 3.0)


def test_request_tail_is_the_95th_percentile_of_every_request():
    rec = {"latency_s": [i / 1000 for i in range(1, 101)]}
    assert bench.read_metric("entry.request_p95_ms", rec) == pytest.approx(
        95.05)


def test_served_rate_runs_to_the_last_verdict():
    rec = {"window_start": 100.0, "served": {"docs": 7200, "last": 130.5}}
    assert bench.read_metric("served_docs_per_s", rec) == pytest.approx(
        7200 / 30.5)


@pytest.mark.parametrize("name", ["entry.docs_per_s", "entry.request_p95_ms",
                                  "served_docs_per_s"])
def test_window_readers_read_nothing_without_their_record(name):
    assert bench.read_metric(name, {"window_start": 0.0}) is None
    empty = {"window_start": 0.0, "done": [], "docs": [], "latency_s": [],
             "served": {"docs": 0, "last": 0.0}}
    assert bench.read_metric(name, empty) is None
