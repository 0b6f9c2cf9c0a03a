"""The traffic: the frozen corpus copy equals the program's, and the
generator gives every seed the same work, as its mix file says."""
from __future__ import annotations

import numpy as np
import pytest

from foldbench.traffic import corpus as frozen
from foldbench.traffic.generate import (Stream, load_mix, prefill_batches,
                                        request_pool, units)

PRESETS = sorted(frozen.DATASET_PRESETS)
PREFILL = {"docs": 96, "batch_docs": 32, "seed": 5}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
@pytest.mark.parametrize("preset", PRESETS)
def test_corpus_copy_equals_the_programs(preset, seed):
    import dataclasses

    from repro_torch.data import corpus as program
    assert (dataclasses.asdict(frozen.DATASET_PRESETS[preset])
            == dataclasses.asdict(program.DATASET_PRESETS[preset]))
    a = frozen.SyntheticCorpus(dataclasses.replace(
        frozen.DATASET_PRESETS[preset], seed=seed))
    b = program.SyntheticCorpus(dataclasses.replace(
        program.DATASET_PRESETS[preset], seed=seed))
    for n in (17, 40, 3):
        for x, y in zip(a.next_batch(n), b.next_batch(n)):
            np.testing.assert_array_equal(x, y)


def _docs(mix, seed, n):
    return Stream(mix, PREFILL, seed).docs(n)


@pytest.mark.parametrize("name", ["cc-ingest", "cc-recrawl", "rn-open"])
def test_same_seed_same_documents_other_seed_other(name):
    mix = load_mix(name)
    a, b, c = (_docs(mix, s, 64) for s in (2**31 + 9, 2**31 + 9, 4))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(len(x) == len(y) and np.array_equal(x, y)
                   for x, y in zip(a, c))


def test_stream_continues_the_prefill():
    mix = load_mix("cc-ingest")
    whole = frozen.SyntheticCorpus(frozen.CorpusConfig(
        **{**frozen.DATASET_PRESETS["common_crawl"].__dict__, "seed": 5}))
    pre = prefill_batches(mix, PREFILL)
    assert sum(len(ln) for _, ln in pre) == PREFILL["docs"]
    for tokens, lengths in pre:
        t, ln, _ = whole.next_batch(len(lengths))
        np.testing.assert_array_equal(tokens, t)
        np.testing.assert_array_equal(lengths, ln)


def _edits(docs, old, rate):
    """For each doc, whether it is an old doc of its length with between 1
    and max(1, int(rate * length)) tokens changed."""
    out = []
    for d in docs:
        m = max(1, int(rate * len(d)))
        same = [o for o in old if len(o) == len(d)]
        diff = [int((o != d).sum()) for o in same]
        out.append(any(1 <= x <= m for x in diff))
    return np.array(out)


def test_recrawl_share_and_edit_range():
    mix = load_mix("cc-recrawl")
    pre = {"docs": 512, "batch_docs": 512, "seed": 5}
    every = Stream({**mix, "recrawl_share": 1.0}, pre, 1)
    assert _edits(every.docs(300), every.old, mix["recrawl_sub_rate"]).all()
    stream = Stream(mix, pre, 1)
    share = _edits(stream.docs(1000), stream.old,
                   mix["recrawl_sub_rate"]).mean()
    # fresh documents are never such edits, but for a rare duplicate of a
    # prefill document in the preset's history
    assert mix["recrawl_share"] - 0.05 < share < mix["recrawl_share"] + 0.1


@pytest.mark.parametrize("seed", [1, 2**31 + 1])
def test_open_loop_same_sizes_and_gaps_for_every_seed(seed):
    mix = load_mix("rn-open")
    arrivals, sizes = request_pool(mix, 30.0, seed, 0)
    base_arrivals, base_sizes = request_pool(mix, 30.0, 0, 0)
    assert sorted(sizes) == sorted(base_sizes)
    assert np.allclose(sorted(np.diff(arrivals, prepend=0)),
                       sorted(np.diff(base_arrivals, prepend=0)))
    assert arrivals[-1] < 30.0 and np.all(np.diff(arrivals) >= 0)
    law = mix["request_docs"]
    if law["dist"] == "fixed":
        assert (sizes == law["docs"]).all()
    else:
        assert sizes.min() >= law["min"] and sizes.max() <= law["max"]
    rate = sizes.sum() / 30.0
    assert abs(rate - mix["rate_docs_per_s"]) < 0.15 * mix["rate_docs_per_s"]


def test_units_start_with_the_warmup_then_the_window():
    mix = load_mix("rn-open")
    it = units(mix, PREFILL, 3, 2.0, 1.0)
    kind, tokens, lengths = next(it)
    assert kind == "warmup" and len(lengths) == mix["warmup_docs"]
    rest = list(it)
    assert all(u[0] == "request" for u in rest)
    t = [u[1] for u in rest]
    assert t == sorted(t) and t[-1] < 3.0 and any(x >= 2.0 for x in t)
    closed = units(load_mix("cc-ingest"), PREFILL, 3, 1.0, 0.0)
    assert next(closed)[0] == "warmup"
    assert next(closed)[1].shape[0] == load_mix("cc-ingest")["batch_docs"]
