"""The port's examples against the reference's: quickstart, service and
cluster (`examples/*_torch.py` against `examples/*.py`), the defaults of
all six, and the device rule of all six.

Each reference example runs in this process from its own source, with its
size literals rewritten to the small sizes below (`_torch_examples_util.
run_reference`: the table `FLAGS` names the literal behind each flag of the
port example), so the JAX package is driven through the very calls of the
example. The port example runs with the same sizes as flags and
`--device cpu`. Both batching clocks and both cluster writers' tenant
clocks are frozen at 0 (`freeze_clocks`), so micro-batches, snapshots and
QPS rejections do not depend on the wall clock, and the reference's
periodic snapshots are written synchronously (`sync_reference_snapshots`:
its rotation races its own asynchronous write, ROADMAP.md hazard F, and
under load keeps one snapshot instead of two). What the two print must
then be equal line for line, once the wall-clock fields (docs/s, qps, p99
batch ms) are masked: every drop, admit and corpus count, recall and FP,
grow events, snapshot names, the dpk line, epochs, rejections, evictions,
probe and replay counts and tenant counters.

Sizes: quickstart 2 cycles x 64 docs at capacity 1,024; service 24 waves
x 16 docs from capacity 256 (one micro-batch a wave: it grows once and
takes 3 snapshots, of which the newest 2 stay; the dpk part keeps the
example's 512 docs at 2,048 slots); cluster 3 waves x 64 docs,
the greedy tenant's burst 16 and the budgeted tenant's allowance 24, so
greedy is rejected in waves 1 and 2 and budgeted evicts.
"""
from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_examples_util import (FLAGS, freeze_clocks,  # noqa: E402
                                  load_example, mask_clock, port_defaults,
                                  reference_literals, run_example,
                                  run_reference, size_flags,
                                  sync_reference_snapshots)

SMALL = {
    "quickstart": {"cycles": 2, "batch": 64, "capacity": 1024},
    "service_demo": {"waves": 24, "docs_per_wave": 16, "capacity": 256},
    "cluster_demo": {"waves": 3, "per_wave": 64, "capacity": 4096,
                     "burst": 16, "max_live_docs": 24},
}


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_port_defaults_are_the_reference_literals(name):
    ours = port_defaults(name)
    assert ours.pop("device") is None       # None: the card
    want = reference_literals(name)
    assert set(ours) == set(FLAGS[name])
    for dest, ref_name in FLAGS[name].items():
        assert ours[dest] == want[ref_name], (name, dest)


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_port_example_raises_without_a_card(name, monkeypatch):
    mod = load_example(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])


@pytest.mark.parametrize("name", sorted(SMALL))
def test_port_example_prints_the_reference_counts(name, monkeypatch):
    freeze_clocks(monkeypatch)
    sync_reference_snapshots(monkeypatch)
    sizes = SMALL[name]
    want = run_reference(name, sizes)
    got = run_example(name, size_flags(sizes) + ["--device", "cpu"])["text"]
    assert mask_clock(got).splitlines() == mask_clock(want).splitlines()
    if name == "service_demo":
        assert "grown 1x, 3 snaps" in got
        assert "['step_00000002', 'step_00000003']" in got
    if name == "cluster_demo":
        assert "'greedy' rejected (qps_quota" in got
        assert "evicted=0" not in got.splitlines()[-2]   # budgeted evicted
