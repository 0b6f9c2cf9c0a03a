"""The slice end to end: the port's FoldPipeline on the CPU against the JAX
FoldPipeline (use_kernel=False, which tests/test_kernels.py holds equal to
the Pallas kernels) must give identical keep masks and identical HNSW
states after every batch, with the defaults and with each option on
(select_heuristic, batched_insert=False, verify_minhash, exact_filter).
Also the device rule, the registry, and the lifecycle calls delegated
through the pipeline."""
import numpy as np
import pytest
import torch

from repro.core.dedup import FoldConfig as JaxFoldConfig
from repro.core.dedup import FoldPipeline as JaxFoldPipeline
from repro.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro_torch.core.dedup import FoldConfig, FoldPipeline
from repro_torch.core.hnsw import state_to_numpy
from repro_torch.index import available, make, make_pipeline

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)

SMALL = dict(capacity=1024, M=8, M0=16, ef_construction=32, ef_search=32)


@pytest.mark.parametrize("cached", [True, False])
@pytest.mark.parametrize("threshold_space", ["bitmap", "minhash"])
def test_fold_pipeline_matches_jax_batch_for_batch(threshold_space, cached):
    jax_pipe = JaxFoldPipeline(JaxFoldConfig(
        use_kernel=False, threshold_space=threshold_space, cached=cached,
        **SMALL))
    pipe = FoldPipeline(FoldConfig(threshold_space=threshold_space,
                                   cached=cached, **SMALL), device="cpu")
    corpus = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    for b in range(3):
        tokens, lengths, _ = corpus.next_batch(64)
        jkeep, jstats = jax_pipe.process_batch(tokens, lengths)
        keep, stats = pipe.process_batch(tokens, lengths)
        np.testing.assert_array_equal(keep, np.asarray(jkeep), err_msg=f"batch {b}")
        for key in ("n_batch_drop", "n_index_drop", "n_insert", "count",
                    "n_overflow"):
            assert stats[key] == jstats[key], (b, key)
        got = state_to_numpy(pipe.state)
        for field, exp in jax_pipe.state._asdict().items():
            np.testing.assert_array_equal(got[field], np.asarray(exp),
                                          err_msg=f"batch {b} {field}")
    assert stats["count"] > 0 and stats["n_batch_drop"] + stats["n_index_drop"] > 0


@pytest.mark.parametrize("cached", [True, False])
def test_in_batch_dedup_matches_jax(cached):
    from repro.core.dedup import fold_signatures as jax_fold_signatures
    from repro.core.dedup import in_batch_dedup as jax_in_batch_dedup
    from repro.core.hashing import hash_seeds as jax_hash_seeds
    from repro_torch.core.dedup import in_batch_dedup

    tokens, lengths, _ = SyntheticCorpus(DATASET_PRESETS["common_crawl"]
                                         ).next_batch(96)
    _, bitmaps, pcs = jax_fold_signatures(JaxFoldConfig(use_kernel=False),
                                          jax_hash_seeds(112), tokens, lengths)
    exp = jax_in_batch_dedup(bitmaps, pcs, 0.7, use_kernel=False, cached=cached)
    got = in_batch_dedup(torch.from_numpy(np.array(bitmaps).view(np.int32)),
                         torch.from_numpy(np.array(pcs)), 0.7, cached=cached)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert not got.numpy().all()       # the preset plants in-batch duplicates


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        FoldPipeline(FoldConfig(**SMALL))
    with pytest.raises(RuntimeError, match="no GPU"):
        make_pipeline("hnsw", FoldConfig(**SMALL))
    from repro_torch.core.hashing import hash_seeds
    from repro_torch.core.minhash import default_seeds
    for seeds in (hash_seeds, default_seeds):
        with pytest.raises(RuntimeError, match="no GPU"):
            seeds(8)
        assert seeds(8, device="cpu").device.type == "cpu"
    assert FoldPipeline(FoldConfig(**SMALL), device="cpu").device.type == "cpu"


def test_registry_serves_hnsw_and_refuses_unported_keys():
    """Every reference key is ported now (`hnsw_sharded` last); an unknown
    key still raises."""
    assert available() == ("brute", "dpk", "flat_lsh", "hnsw", "hnsw_raw",
                           "hnsw_sharded", "prefix_filter")
    # the port's factories take `device`; foldlint's factory table is keyed
    # by registry key and holds the reference's factories
    be = make("hnsw", FoldConfig(**SMALL), device="cpu")  # foldlint: disable=F131
    assert be.name == "hnsw" and be.capacity == 1024
    brute = make("brute", FoldConfig(**SMALL), device="cpu")  # foldlint: disable=F131
    assert brute.name == "brute" and brute.capacity == 1024
    assert brute.sig_spec.needs == frozenset({"sigs"})
    for key in ("hnsw_raw", "dpk", "flat_lsh", "prefix_filter"):
        be = make(key, FoldConfig(**SMALL), device="cpu")  # foldlint: disable=F131
        assert be.name == key and be.capacity == 1024
    sh = make("hnsw_sharded", FoldConfig(**SMALL), shards=2, device="cpu")  # foldlint: disable=F131
    assert sh.name == "hnsw_sharded" and sh.capacity == 2 * 1024
    with pytest.raises(KeyError):
        make("no_such_backend")


def _stream(n_batches, size=48, repeat=False):
    """Common Crawl preset batches; repeat=True appends a batch that
    re-sends rows of the first two, so the exact front door hits."""
    corpus = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    out = [corpus.next_batch(size)[:2] for _ in range(n_batches)]
    if repeat:
        (t0, l0), (t1, l1) = out[0], out[1]
        h = size // 2
        out.append((np.concatenate([t0[:h], t1[:size - h]]),
                    np.concatenate([l0[:h], l1[:size - h]])))
    return out


def _assert_same_pipelines(jax_pipe, pipe, batches):
    for b, (tokens, lengths) in enumerate(batches):
        jkeep, jstats = jax_pipe.process_batch(tokens, lengths)
        keep, stats = pipe.process_batch(tokens, lengths)
        np.testing.assert_array_equal(keep, np.asarray(jkeep),
                                      err_msg=f"batch {b}")
        for key, exp in jstats.items():
            if not key.startswith("t_"):
                assert stats[key] == exp, (b, key)
        got = state_to_numpy(pipe.state)
        for field, exp in jax_pipe.state._asdict().items():
            np.testing.assert_array_equal(got[field], np.asarray(exp),
                                          err_msg=f"batch {b} {field}")
    return stats


@pytest.mark.parametrize("option", ["verify_minhash", "select_heuristic",
                                    "batched_insert", "exact_filter"])
def test_unported_options_raise_by_name(option):
    """Each option that the first slices refused by name now runs: the
    port's FoldPipeline with it equals the JAX one batch for batch (keep
    masks, stats, HNSWState). The exact-filter stream ends in a batch of
    repeated rows, so the front door hits."""
    value = option != "batched_insert"
    jax_pipe = JaxFoldPipeline(JaxFoldConfig(use_kernel=False,
                                             **{**SMALL, option: value}))
    pipe = FoldPipeline(FoldConfig(**{**SMALL, option: value}), device="cpu")
    stats = _assert_same_pipelines(
        jax_pipe, pipe, _stream(3, repeat=option == "exact_filter"))
    if option == "exact_filter":
        assert stats["n_exact_hits"] > 0
    if option == "verify_minhash":
        assert pipe.backend.tau_index == pipe.cfg.tau


def test_lifecycle_calls_not_ported_raise(tmp_path):
    """save, restore, delete and compact, once refused by name, now match
    the JAX pipeline: the same tombstones, the same compacted state and
    the same snapshot bytes, and a restored pipeline gives the same next
    verdicts."""
    cfg = {**SMALL, "capacity": 256}
    jax_pipe = JaxFoldPipeline(JaxFoldConfig(use_kernel=False, **cfg))
    pipe = FoldPipeline(FoldConfig(**cfg), device="cpu")
    batches = _stream(3)
    _assert_same_pipelines(jax_pipe, pipe, batches[:2])
    kill = np.flatnonzero(np.asarray(jax_pipe.state.node_level) >= 0)[::3]
    assert pipe.delete(kill) == jax_pipe.delete(kill) == len(kill)
    assert pipe.deleted == len(kill) and pipe.dead_fraction == len(kill) / 256
    assert pipe.compact()["reclaimed"] == jax_pipe.compact()["reclaimed"]
    pipe.save(str(tmp_path / "t"), 1)
    jax_pipe.save(str(tmp_path / "j"), 1)
    for name in ("arrays.msgpack", "MANIFEST.json"):
        assert ((tmp_path / "t" / "step_00000001" / name).read_bytes()
                == (tmp_path / "j" / "step_00000001" / name).read_bytes())
    fresh = FoldPipeline(FoldConfig(**cfg), device="cpu")
    assert fresh.restore(str(tmp_path / "j")) == 1
    _assert_same_pipelines(jax_pipe, fresh, batches[2:])
    pipe.grow(2048)
    assert pipe.capacity == 2048 and pipe.state.vectors.shape[0] == 2048


def test_overflow_is_refused_not_dropped():
    pipe = FoldPipeline(FoldConfig(**{**SMALL, "capacity": 16}), device="cpu")
    tokens, lengths, _ = SyntheticCorpus(DATASET_PRESETS["lm1b"]).next_batch(32)
    with pytest.raises(RuntimeError, match="index full"):
        pipe.process_batch(tokens, lengths)
