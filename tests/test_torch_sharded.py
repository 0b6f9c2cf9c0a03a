"""The port's `hnsw_sharded` at one shard, held in-process against the port's
own `hnsw` and against the JAX package's `hnsw_sharded` (JAX sees one CPU
device here, so its sharded backend also runs one shard): keep masks,
step-② survivors and index states batch for batch under each insert
option, the pipeline's `fused_step` route and its timers, the read-only
query, snapshot bytes both ways, the shard-layout refusal, and the
factory's options. The 4-shard comparison against JAX on virtual devices
is tests/test_torch_sharded_jax.py."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.dedup import FoldConfig as JaxFoldConfig
from repro.core.hnsw import HNSWState as JaxHNSWState
from repro.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro.index import accepted_opts as jax_accepted_opts
from repro.index import make_pipeline as jax_make_pipeline
from repro_torch.core.dedup import FoldConfig
from repro_torch.core.hnsw import HNSWState, hnsw_init, state_to_numpy
from repro_torch.core.sharded import (sharded_init, stack_states,
                                      unstack_states)
from repro_torch.index import accepted_opts, make, make_pipeline, validate_opts
from repro_torch.index.backends.sharded import ShardedDedupBackend
from repro_torch.train import checkpoint as ckpt

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)

FOLD = dict(capacity=512, M=8, M0=16, ef_construction=32, ef_search=32,
            tau=0.7, threshold_space="minhash")


def _stream(n_batches, batch=96, seed=0):
    src = SyntheticCorpus(dataclasses.replace(
        DATASET_PRESETS["common_crawl"], seed=seed))
    return [src.next_batch(batch)[:2] for _ in range(n_batches)]


def _jax_states(pipe) -> dict:
    return {f: np.asarray(getattr(pipe.backend.states, f))
            for f in JaxHNSWState._fields}


@pytest.mark.parametrize("opts", [
    {}, {"select_heuristic": True}, {"reuse_search": False},
    {"batched_insert": False}], ids=["default", "heuristic", "no_reuse",
                                      "per_doc"])
def test_one_shard_equals_hnsw_and_jax_batch_for_batch(opts):
    """At shards=1 the fused step is the single-graph algorithm: keep,
    keep_in and the state equal the port's `hnsw` and JAX's
    `hnsw_sharded` after every batch (ragged batches included)."""
    single = make_pipeline("hnsw", FoldConfig(**FOLD, **opts), device="cpu")  # foldlint: disable=F131 (the port's factories add device)
    sharded = make_pipeline("hnsw_sharded", FoldConfig(**FOLD, **opts),
                            shards=1, device="cpu")  # foldlint: disable=F131 (the port's factories add device)
    jax_pipe = jax_make_pipeline("hnsw_sharded",
                                 cfg=JaxFoldConfig(**FOLD, **opts), shards=1)
    for i, (t, ln) in enumerate(_stream(2) + _stream(1, batch=61, seed=1)):
        got = [p.dedup_step(p.signatures(t, ln))
               for p in (single, sharded, jax_pipe)]
        keeps = [np.asarray(r.keep) for r in got]
        keep_ins = [np.asarray(r.keep_in_batch) for r in got]
        assert np.array_equal(keeps[0], keeps[1]), i
        assert np.array_equal(keeps[1], keeps[2]), i
        assert np.array_equal(keep_ins[0], keep_ins[1]), i
        assert np.array_equal(keep_ins[1], keep_ins[2]), i
        one = state_to_numpy(single.backend.state)
        mine = stack_states(sharded.backend.states)._asdict()
        ref = _jax_states(jax_pipe)
        for f in HNSWState._fields:
            np.testing.assert_array_equal(mine[f][0], one[f], err_msg=f)
            np.testing.assert_array_equal(mine[f], ref[f], err_msg=f)
    assert single.inserted == sharded.inserted == jax_pipe.inserted > 0
    assert sharded.backend.stats() == jax_pipe.backend.stats()


def test_fused_step_route_timers_and_query_as_jax():
    """dedup_step routes a fused backend around the split stages: with
    timers the split stages read 0 and t_fused_step is recorded, as in
    JAX; the step surfaces neighbor ids -1 / sims -inf; the read-only
    query reaches the merged search and gives JAX's ids and sims."""
    b1, b2 = _stream(2, seed=3)
    port = make_pipeline("hnsw_sharded", FoldConfig(**FOLD), device="cpu")  # foldlint: disable=F131 (the port's factories add device)
    jax_pipe = jax_make_pipeline("hnsw_sharded", cfg=JaxFoldConfig(**FOLD))
    timers, jtimers = {}, {}
    res = port.dedup_step(port.signatures(*b1), timers=timers)
    jax_pipe.dedup_step(jax_pipe.signatures(*b1), timers=jtimers)
    assert sorted(timers) == sorted(jtimers) == [
        "t_fused_step", "t_in_batch", "t_insert", "t_search"]
    assert timers["t_in_batch"] == timers["t_search"] == \
        timers["t_insert"] == 0.0 and timers["t_fused_step"] > 0
    assert (res.ids == -1).all() and torch.isneginf(res.sims).all()
    keep, stats = port.process_batch(*b2)
    jkeep, jstats = jax_pipe.process_batch(*b2)
    assert np.array_equal(keep, np.asarray(jkeep))
    for k in ("n_batch_drop", "n_index_drop", "n_insert", "count",
              "n_overflow"):
        assert stats[k] == jstats[k], k
    assert "t_fused_step" in stats
    q, jq = port.query(*b1), jax_pipe.query(*b1)
    np.testing.assert_array_equal(q.is_dup, np.asarray(jq.is_dup))
    np.testing.assert_array_equal(q.ids, np.asarray(jq.ids))
    np.testing.assert_array_equal(q.sims.view(np.uint32),
                                  np.asarray(jq.sims).view(np.uint32))
    assert q.is_dup.all()
    with pytest.raises(NotImplementedError, match="fused_step"):
        port.backend.batch_sim(port.signatures(*b1))


def test_one_shard_snapshot_bytes_equal_both_ways(tmp_path):
    """A 1-shard snapshot after deletes is the same bytes in both packages,
    and each restores the other's into the same verdicts."""
    b1, b2 = _stream(2, seed=4)
    port = make_pipeline("hnsw_sharded", FoldConfig(**FOLD), device="cpu")  # foldlint: disable=F131 (the port's factories add device)
    jax_pipe = jax_make_pipeline("hnsw_sharded", cfg=JaxFoldConfig(**FOLD))
    logs = []
    for p in (port, jax_pipe):
        p.backend.track_slots = True
        p.process_batch(*b1)
        logs.append(np.concatenate(p.backend.pop_slot_log()))
        assert p.delete(logs[-1][::4]) == len(logs[-1][::4])
    assert np.array_equal(*logs)
    slots = logs[0]
    port.save(str(tmp_path / "port"), step=2)
    jax_pipe.save(str(tmp_path / "jax"), step=2)
    for name in ("arrays.msgpack", "MANIFEST.json"):
        assert (tmp_path / "port" / "step_00000002" / name).read_bytes() == \
            (tmp_path / "jax" / "step_00000002" / name).read_bytes(), name
    back = make_pipeline("hnsw_sharded", FoldConfig(**FOLD), device="cpu")  # foldlint: disable=F131 (the port's factories add device)
    jback = jax_make_pipeline("hnsw_sharded", cfg=JaxFoldConfig(**FOLD))
    assert back.restore(str(tmp_path / "jax")) == 2
    assert jback.restore(str(tmp_path / "port")) == 2
    assert back.inserted == jback.inserted == port.inserted
    assert back.deleted == jback.deleted == len(slots[::4])
    want = port.process_batch(*b2)[0]
    assert np.array_equal(back.process_batch(*b2)[0], want)
    assert np.array_equal(np.asarray(jback.process_batch(*b2)[0]), want)


def test_restore_refuses_fewer_shards_with_the_reference_message(tmp_path):
    """Scale-in is refused (per-shard graphs cannot be merged) with the
    JAX package's message, word for word: a 2-shard snapshot onto one
    shard, in both packages."""
    port2 = make_pipeline("hnsw_sharded", FoldConfig(**FOLD), shards=2,
                          device="cpu")  # foldlint: disable=F131 (the port's factories add device)
    port2.process_batch(*_stream(1, seed=5)[0])
    port2.save(str(tmp_path), step=1)
    msgs = []
    for pipe in (make_pipeline("hnsw_sharded", FoldConfig(**FOLD),
                               device="cpu"),  # foldlint: disable=F131 (the port's factories add device)
                 jax_make_pipeline("hnsw_sharded",
                                   cfg=JaxFoldConfig(**FOLD))):
        with pytest.raises(ValueError, match="cannot be merged") as ei:
            pipe.restore(str(tmp_path))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        port2.restore(str(tmp_path / "nothing_here"))


def test_restore_refuses_a_snapshot_of_another_geometry(tmp_path):
    """The manifest's per-shard capacity and the saved arrays must agree,
    or the restore names both shapes."""
    cfg = FoldConfig(**FOLD)
    st = stack_states(sharded_init(cfg.hnsw(), 2, "cpu"))
    ckpt.save(str(tmp_path), 1, {"states": st, "batches": np.int32(0)},
              extra={"capacity": 256, "shards": 2, "axis": "data"})
    pipe = make_pipeline("hnsw_sharded", cfg, shards=2, device="cpu")  # foldlint: disable=F131 (the port's factories add device)
    with pytest.raises(ValueError, match="snapshot geometry"):
        pipe.restore(str(tmp_path))


def test_stack_and_unstack_round_trip():
    """stack_states gives the reference's stacked layout (a leading shard
    axis, uint32 vectors); unstack_states restores per-shard tensors."""
    cfg = FoldConfig(**FOLD).hnsw()
    pipe = make_pipeline("hnsw_sharded", FoldConfig(**FOLD), shards=3,
                         device="cpu")  # foldlint: disable=F131 (the port's factories add device)
    pipe.process_batch(*_stream(1, seed=6)[0])
    st = stack_states(pipe.backend.states)
    assert st.vectors.dtype == np.uint32 and st.vectors.shape == (
        3, cfg.capacity, cfg.words)
    assert st.count.shape == (3,) and st.count.sum() == pipe.inserted
    back = unstack_states(st, "cpu")
    for a, b in zip(back, pipe.backend.states):
        for f in HNSWState._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    empty = stack_states([hnsw_init(cfg, "cpu")])
    assert empty.entry.tolist() == [-1] and empty.count.tolist() == [0]


def test_factory_options_device_shard_count_and_exports():
    """The factory takes the reference's options (FoldConfig overrides
    through **opts) with `device` in place of `mesh`; shards=None is one
    shard; typo'd options raise naming the accepted keys; no card and no
    device means cuda, which raises. The service package re-exports the
    backend, as the reference's does."""
    assert set(accepted_opts("hnsw_sharded")) - {"device"} == \
        set(jax_accepted_opts("hnsw_sharded")) - {"mesh"}
    be = make("hnsw_sharded", FoldConfig(**FOLD), shards=3, device="cpu",  # foldlint: disable=F131
              ef_search=48, axis="shards")
    assert isinstance(be, ShardedDedupBackend)
    assert be.cfg.ef_search == 48 and be.nshards == 3 and be.axis == "shards"
    assert be.capacity == 3 * FOLD["capacity"]
    assert make("hnsw_sharded", device="cpu").nshards == 1  # foldlint: disable=F131
    validate_opts("hnsw_sharded", {"shards": 2, "ef_search": 64,
                                   "device": "cpu"})
    with pytest.raises(ValueError, match="accepted keys") as ei:
        validate_opts("hnsw_sharded", {"sharsd": 2})
    assert "sharsd" in str(ei.value)
    with pytest.raises(ValueError, match="at least one shard"):
        ShardedDedupBackend(FoldConfig(**FOLD), shards=0, device="cpu")
    import repro.service as jax_service
    import repro_torch.service as service
    from repro_torch.service import index_manager
    assert service.ShardedDedupBackend is ShardedDedupBackend
    assert index_manager.ShardedDedupBackend is ShardedDedupBackend
    assert sorted(service.__all__) == sorted(jax_service.__all__)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="found no GPU"):
            make("hnsw_sharded", FoldConfig(**FOLD), shards=2)  # foldlint: disable=F131


def test_grow_keeps_every_subgraph_and_global_ids():
    """grow(total) re-pads every shard to ceil(total / nshards) slots: the
    graphs and the merged search's global ids are unchanged, and a
    smaller target is a no-op."""
    pipe = make_pipeline("hnsw_sharded", FoldConfig(**FOLD), shards=3,
                         device="cpu")  # foldlint: disable=F131 (the port's factories add device)
    b1, b2 = _stream(2, seed=7)
    pipe.process_batch(*b1)
    before = stack_states(pipe.backend.states)
    q0 = pipe.query(*b2)
    pipe.grow(100)
    assert pipe.capacity == 3 * FOLD["capacity"]
    pipe.grow(3 * FOLD["capacity"] + 1)
    assert pipe.capacity == 3 * (FOLD["capacity"] + 1)
    after = stack_states(pipe.backend.states)
    cap = FOLD["capacity"]
    np.testing.assert_array_equal(after.vectors[:, :cap], before.vectors)
    np.testing.assert_array_equal(after.neighbors[:, :, :cap],
                                  before.neighbors)
    assert (after.node_level[:, cap:] == -1).all()
    q1 = pipe.query(*b2)
    np.testing.assert_array_equal(q0.ids, q1.ids)
    np.testing.assert_array_equal(q0.sims, q1.sims)
