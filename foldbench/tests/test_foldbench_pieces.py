"""Drivers and references found by name, the default reference's entry
point against the counts `exact.judge` gives, the prefill's cache key and
a driver's own prefill files, and a toy retention window (a driver and a
reference kept under `tests/toy/`) run through the same lookup: the seam
carries deletion."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from foldbench import bench, prefill
from foldbench.reference import exact
from foldbench.reference.signatures import batch_signatures
from foldbench.tests._tiny import tiny, tiny_run
from foldbench.traffic.generate import Stream, load_mix, prefill_batches

CONFIGS = [c["name"] for c in bench.load_spec()["configs"]]
TOY = bench.HERE / "tests" / "toy"
INGEST = "fold-hnsw-256k.cc-ingest"
WINDOW = {"driver": "window", "reference": "window", "window": {"batches": 2}}


# the configurations this benchmark started with; one added later brings
# its own driver and reference, which `test_foldbench_spec.py` finds
@pytest.mark.parametrize("name,driver", [("fold-hnsw-256k", "pipeline"),
                                         ("fold-service-256k", "service")])
def test_each_configuration_resolves_to_its_files(name, driver):
    config = bench.load_config(name)
    mod = bench.load_piece("drivers", config["driver"])
    assert mod.__file__ == str(bench.HERE / "drivers" / f"{driver}.py")
    assert callable(mod.drive)
    reference = bench.load_piece("reference", config.get("reference",
                                                         "exact"))
    assert reference.__file__ == str(bench.HERE / "reference" / "exact.py")
    assert callable(reference.compare) and callable(reference.truth)


@pytest.mark.parametrize("key", ["driver", "reference"])
def test_unknown_name_fails_with_the_path(key, tmp_path):
    spec, config, mix = tiny(INGEST)
    config[key] = "nosuch"
    kind = "drivers" if key == "driver" else "reference"
    with pytest.raises(FileNotFoundError) as err:
        bench.run(INGEST, 1, 1.0, False, device="cpu", spec=spec,
                  config=config, mix=mix, cache=tmp_path,
                  log=lambda msg: None)
    assert str(bench.HERE / kind / "nosuch.py") in str(err.value)


_CANNED = """import numpy as np


def drive(ctx):
    n = ctx["config"]["prefill"]["docs"]
    return {"host": {}, "queue_wait_s": 0.0, "attempted": 0, "failed": 0,
            "prefill_keep": np.ones(n, bool), "first_judged": 0,
            "batches": [], "index_count": n}
"""


def test_reference_without_a_control_fails(tmp_path):
    for kind in ("drivers", "reference"):
        (tmp_path / kind).mkdir()
    (tmp_path / "drivers" / "canned.py").write_text(_CANNED)
    (tmp_path / "reference" / "nocontrol.py").write_text(
        "def compare(*args, **kwargs):\n    return {}, None\n")
    spec, config, mix = tiny(INGEST)
    config.update(driver="canned", reference="nocontrol")
    with pytest.raises(ValueError, match="no control counts"):
        bench.run(INGEST, 1, 1.0, False, device="cpu", spec=spec,
                  config=config, mix=mix, cache=tmp_path / "cache",
                  control=True, log=lambda msg: None, pieces=tmp_path)


def _recorded(mix_name: str, seed: int):
    """(documents per batch, first judged batch): a 64-doc prefill in two
    batches, a warm-up batch, then six judged batches of 24."""
    mix = load_mix(mix_name)
    pre = {"docs": 64, "batch_docs": 32, "seed": 3}
    docs = [[t[i, :ln[i]] for i in range(len(ln))]
            for t, ln in prefill_batches(mix, pre)]
    stream = Stream(mix, pre, seed)
    docs += [stream.docs(24) for _ in range(7)]
    return docs, 3


@pytest.mark.parametrize("mix,seed", [("cc-ingest", 2**31 + 1),
                                      ("cc-recrawl", 5)])
def test_default_reference_equals_judge(mix, seed):
    docs, first = _recorded(mix, seed)
    fold = bench.load_config(CONFIGS[0])["fold"]
    tau = fold["tau"]
    batches = batch_signatures(docs, fold, "cpu")
    keeps = exact.exact_pipeline(batches, tau)[0]
    verdicts = [k.copy() for k in keeps]
    verdicts[4][:3] = ~verdicts[4][:3]          # three verdicts altered
    verdicts[5] = None                           # a batch never answered
    admitted = sum(int(np.asarray(v, bool).sum()) for v in verdicts)
    rec = {"index_count": admitted + 7, "missing_docs": 2}
    judged, ctrl = exact.compare(docs, verdicts, first, fold, {}, rec,
                                 device="cpu", control=True)
    want = exact.judge(batches, verdicts, first, tau)
    want["missing"] += 2
    want["index_gap"] = 7
    assert judged == want
    assert judged["missing"] == 24 + 2
    low = batch_signatures(docs, fold, "cpu", exact.CONTROL_LANE_BITS)
    cwant = exact.judge(batches, exact.exact_pipeline(low, tau)[0], first,
                        tau)
    cwant["index_gap"] = 0
    assert ctrl == cwant
    assert exact.compare(docs, verdicts, first, fold, {}, rec,
                         device="cpu")[1] is None
    sound, live = exact.truth(docs, fold, {}, device="cpu")
    assert [k.tolist() for k in sound] == [k.tolist() for k in keeps]
    assert live == sum(int(k.sum()) for k in keeps)


def test_toy_reference_judges_its_truth_and_control():
    docs, first = _recorded("cc-recrawl", 5)
    config = {**bench.load_config(CONFIGS[0]), **WINDOW}
    fold = config["fold"]
    reference = bench.load_piece("reference", "window", TOY)
    verdicts, live = reference.truth(docs, fold, config, device="cpu")
    judged, ctrl = reference.compare(docs, verdicts, first, fold, config,
                                     {"index_count": live}, device="cpu",
                                     control=True)
    assert judged["docs"] == 6 * 24 and judged["recall"] == 1.0
    for name in ("missing", "batch_dup_kept", "unjustified", "missed",
                 "index_gap"):
        assert judged[name] == 0, name
    assert ctrl is not None and set(ctrl) == set(judged)
    assert ctrl["docs"] == judged["docs"]


@pytest.fixture(scope="module")
def window_cache(tmp_path_factory):
    return tmp_path_factory.mktemp("window")


def test_toy_window_run_is_correct(window_cache):
    r = tiny_run(INGEST, window_cache, config_update=WINDOW, pieces=TOY)
    assert r["correct"], r["checks"]
    assert r["checks"]["index_gap"]["value"] == 0
    entry = next(p for p in window_cache.iterdir() if p.is_dir())
    assert (entry / "window.npz").is_file()


def _skip_one_delete(pipe):
    """The backend's first delete that has slots to delete does nothing."""
    be = pipe.backend
    delete, skipped = be.delete, []

    def once(ids):
        if not skipped and len(ids):
            skipped.append(ids)
            return 0
        return delete(ids)

    be.delete = once


def test_toy_window_skipped_delete_is_not_correct(window_cache):
    r = tiny_run(INGEST, window_cache, config_update=WINDOW, pieces=TOY,
                 on_ready=_skip_one_delete)
    assert not r["correct"], r["checks"]
    assert r["checks"]["index_gap"]["value"] > 0


def test_cache_key_follows_what_builds_the_prefill():
    _, config, mix = tiny(INGEST)
    base = prefill.cache_key(config, mix)
    for key, value in [("driver", "window"), ("reference", "window"),
                       ("window", {"batches": 3}),
                       ("fold", {**config["fold"], "ef_search": 32})]:
        assert prefill.cache_key({**config, key: value}, mix) != base, key
    for key in prefill.PROSE:
        assert prefill.cache_key({**config, key: ["other"]}, mix) == base, key


class _Pipe:
    """Enough of a pipeline for `ensure` and `restore`."""

    def __init__(self):
        self.seen, self.restored = 0, None

    def process_batch(self, tokens, lengths):
        self.seen += len(lengths)
        return np.ones(len(lengths), bool), {}

    def save(self, directory, step):
        (Path(directory) / "snapshot").mkdir(parents=True)

    def restore(self, directory):
        self.restored = directory


def test_extra_prefill_files_round_trip(tmp_path):
    _, config, mix = tiny(INGEST, prefill_docs=64)
    steps, got = [], {}

    def step(pipe, tokens, lengths):
        steps.append(len(lengths))
        return pipe.process_batch(tokens, lengths)

    def save(pipe, directory):
        assert not (directory / "meta.json").exists()
        np.save(directory / "ledger.npy", np.arange(pipe.seen))

    def load(pipe, entry):
        got["ledger"] = np.load(entry / "ledger.npy")

    entry = prefill.ensure(config, mix, tmp_path, _Pipe, lambda msg: None,
                           step=step, save_extra=save)
    assert steps == [32, 32]
    assert (entry / "meta.json").is_file()
    pipe = _Pipe()
    keep = prefill.restore(pipe, entry, load)
    assert pipe.restored == str(entry) and keep.shape == (64,)
    assert got["ledger"].tolist() == list(range(64))
    # a second call finds the entry and builds nothing
    assert prefill.ensure(config, mix, tmp_path, _Pipe, lambda msg: None,
                          step=step, save_extra=save) == entry
    assert steps == [32, 32]
