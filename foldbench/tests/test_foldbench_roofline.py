"""Each kernel's count of work at known shapes, and the readers of the
kernel and device metrics on a hand-made trace record."""
from __future__ import annotations

import pytest

from foldbench import bench
from foldbench.roofline import k1_minhash, k2_jaccard, peaks
from foldbench.trace import reduce

FOLD = {"num_hashes": 112, "T": 4096}


def test_k1_counts():
    # 512 docs padded to 384 tokens, 112 lanes, 100,000 valid shingles
    assert k1_minhash.work(512, 384, 112, 100_000) == (
        512 * 384 * 4 + 112 * 4 + 512 * 112 * 4, 12 * 100_000 * 112)


def test_k2_counts():
    assert k2_jaccard.work(512, 512, 128) == (
        2 * 512 * 128 * 4 + 2 * 512 * 4 + 512 * 512 * 4,
        3 * 512 * 512 * 128 + 6 * 512 * 512)
    assert k2_jaccard.work(3, 5, 2) == (3 * 8 + 5 * 8 + 12 + 20 + 60,
                                       3 * 3 * 5 * 2 + 6 * 15)


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 67e12 / 4) == pytest.approx(1.0)
    assert peaks.least_seconds(3.35e12, 2 * 67e12 / 4) == pytest.approx(2.0)


def _events():
    k1 = "void minhash_kernel<7>(unsigned int const*)"
    k2 = "void bitmap_tile<0>(unsigned int const*)"
    ev = []
    for i, (name, ts, dur) in enumerate([(k1, 100, 10), (k2, 105, 10),
                                         (k1, 200, 20), (k2, 300, 10)]):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                   "dur": dur, "tid": 7})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::nonzero",
               "ts": 110, "dur": 150, "tid": 1})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::item",
               "ts": 250, "dur": 40, "tid": 1})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
               "ts": 99, "dur": 1, "tid": 1})
    ev.append({"ph": "X", "cat": "cuda_runtime",
               "name": "cudaMemcpyAsync", "ts": 98, "dur": 1, "tid": 1})
    return ev


def test_trace_reduction_and_readers():
    tr = reduce(_events(), window_s=1e-3)
    assert tr["busy_s"] == pytest.approx(45e-6)      # [100,115) [200,220) ..
    assert tr["device_ops"] == 2
    # gaps: 115-200 (mid 157.5: nonzero), 220-300 (mid 260: item, inner)
    assert dict(tr["idle_gaps"]) == pytest.approx(
        {"aten::nonzero": 85e-6, "aten::item": 80e-6})
    tr.update(units=2, shapes=[{"B": 4, "L": 8, "valid_shingles": 20}] * 2)
    rec = {"trace": tr, "fold": FOLD}
    k1 = bench.read_metric("k1_minhash_roofline", rec)
    least = 2 * peaks.least_seconds(*k1_minhash.work(4, 8, 112, 20))
    assert k1 == pytest.approx(least / 30e-6 * 100)
    k2 = bench.read_metric("k2_jaccard_roofline", rec)
    least = 2 * peaks.least_seconds(*k2_jaccard.work(4, 4, 128))
    assert k2 == pytest.approx(least / 20e-6 * 100)
    assert bench.read_metric("device.idle_share", rec) == pytest.approx(
        1 - 45e-6 / 1e-3)
    assert bench.read_metric("device.ops_per_batch", rec) == 1.0


def test_roofline_reader_reads_nothing_without_one_event_per_batch():
    tr = reduce(_events()[:3], window_s=1e-3)
    tr.update(units=2, shapes=[{"B": 4, "L": 8, "valid_shingles": 20}] * 2)
    rec = {"trace": tr, "fold": FOLD}
    assert bench.read_metric("k2_jaccard_roofline", rec) is None
    assert bench.read_metric("k1_minhash_roofline", {"fold": FOLD}) is None
