"""The control comes out not correct: the control of each cell's own
reference (for `exact`, the exact pipeline on 16-bit MinHash lanes, the
integer precision below the configurations' 32-bit lanes), put in the
program's place and judged as the program is, beside what a sound program
gives (the reference's `truth`), on each cell's own
traffic at a size a test run holds. On the card the same control is run at
each cell's own size by `foldbench/control.py`."""
from __future__ import annotations

import pytest

from foldbench import bench
from foldbench.traffic.generate import Stream, load_mix, prefill_batches

CELLS = [c["name"] for c in bench.load_spec()["workloads"]]
PREFILL = {"docs": 2048, "batch_docs": 512, "seed": 11}
WINDOW_DOCS = 3072


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    spec = bench.load_spec()
    c = next(x for x in spec["workloads"] if x["name"] == cell)
    config = bench.load_config(c["config"])
    mix = load_mix(c["traffic"])
    batch = mix.get("batch_docs") or config["service"]["max_batch"]
    docs = [[t[i, :ln[i]] for i in range(len(ln))]
            for t, ln in prefill_batches(mix, PREFILL)]
    first = len(docs)
    stream = Stream(mix, PREFILL, 2**31 + 77)
    docs += [stream.docs(batch) for _ in range(WINDOW_DOCS // batch)]
    fold = config["fold"]
    reference = bench.load_piece("reference",
                                 config.get("reference", "exact"))
    verdicts, live = reference.truth(docs, fold, config, device="cpu")
    sound, ctrl = reference.compare(docs, verdicts, first, fold, config,
                                    {"index_count": live}, device="cpu",
                                    control=True)
    assert bench._passes(bench._checks(sound, config["limits"])), sound
    assert ctrl is not None
    assert not bench._passes(bench._checks(ctrl, config["limits"])), ctrl
