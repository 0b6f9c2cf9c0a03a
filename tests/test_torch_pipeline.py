"""The slice end to end: the port's FoldPipeline on the CPU against the JAX
FoldPipeline (use_kernel=False, which tests/test_kernels.py holds equal to
the Pallas kernels) must give identical keep masks and identical HNSW
states after every batch. Also the device rule, the registry and the
options that are not ported yet."""
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
    assert available() == ("hnsw",)
    # the port's factory takes `device`; foldlint's factory table is keyed
    # by registry key and holds the reference's "hnsw" factory
    be = make("hnsw", FoldConfig(**SMALL), device="cpu")  # foldlint: disable=F131
    assert be.name == "hnsw" and be.capacity == 1024
    for key in ("hnsw_raw", "brute"):
        with pytest.raises(NotImplementedError, match=key):
            make(key, FoldConfig(**SMALL), device="cpu")
    with pytest.raises(KeyError):
        make("no_such_backend")


@pytest.mark.parametrize("option", ["verify_minhash", "select_heuristic",
                                    "batched_insert", "exact_filter"])
def test_unported_options_raise_by_name(option):
    value = option != "batched_insert"
    cfg = FoldConfig(**{**SMALL, option: value})
    match = "_insert_one" if option == "batched_insert" else option
    with pytest.raises(NotImplementedError, match=match):
        FoldPipeline(cfg, device="cpu")


def test_lifecycle_calls_not_ported_raise():
    pipe = FoldPipeline(FoldConfig(**SMALL), device="cpu")
    for call, name in ((lambda: pipe.backend.save("x", 0), "save"),
                       (lambda: pipe.backend.restore("x"), "restore"),
                       (lambda: pipe.backend.delete(np.arange(2)), "delete"),
                       (lambda: pipe.backend.compact(), "compact")):
        with pytest.raises(NotImplementedError, match=name):
            call()
    pipe.grow(2048)
    assert pipe.capacity == 2048 and pipe.state.vectors.shape[0] == 2048


def test_overflow_is_refused_not_dropped():
    pipe = FoldPipeline(FoldConfig(**{**SMALL, "capacity": 16}), device="cpu")
    tokens, lengths, _ = SyntheticCorpus(DATASET_PRESETS["lm1b"]).next_batch(32)
    with pytest.raises(RuntimeError, match="index full"):
        pipe.process_batch(tokens, lengths)
