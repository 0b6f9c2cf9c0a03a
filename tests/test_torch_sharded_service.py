"""The port's serving layer on `hnsw_sharded` (ServiceConfig(shards>1)):
the service's verdicts and index equal a process_batch loop over its own
micro-batches (padded, masked), its lifecycle (growth across every shard,
snapshot, restore, deletion) round-trips, the executor serves the fused
step at any depth with sampled `t_fused_step` timers, a cluster writer's
published epochs restore on replicas that answer as the writer does
(tombstones included, budget evictions through the routed delete), and
the capacity guard refuses with a grow() hint. At one shard each is held
against the JAX package in-process (JAX sees one CPU device here); the
4-shard service against JAX is in tests/test_torch_sharded_jax.py."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.cluster import ClusterConfig as JaxClusterConfig
from repro.cluster import DedupCluster as JaxDedupCluster
from repro.core.dedup import FoldConfig as JaxFoldConfig
from repro.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro.index import make_pipeline as jax_make_pipeline
from repro.service import DedupService as JaxDedupService
from repro.service import ServiceConfig as JaxServiceConfig
from repro_torch.cluster import ClusterConfig, DedupCluster, TenantSpec
from repro_torch.core.dedup import FoldConfig
from repro_torch.core.sharded import stack_states
from repro_torch.index import make_pipeline
from repro_torch.service import DedupService, ServiceConfig

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)

FOLD = dict(capacity=256, M=8, M0=16, ef_construction=32, ef_search=32,
            tau=0.7, threshold_space="minhash")
SVC = dict(max_batch=32, max_wait_ms=0.0, batch_buckets=(32,), max_len=64,
           stage_timer_every=0)


def _batch(n=64, seed=0, dataset="lm1b"):
    src = SyntheticCorpus(dataclasses.replace(DATASET_PRESETS[dataset],
                                              seed=seed))
    return src.next_batch(n)[:2]


def _chunks(n, seed):
    src = SyntheticCorpus(dataclasses.replace(
        DATASET_PRESETS["common_crawl"], seed=seed))
    rng = np.random.default_rng(seed)
    return [src.next_batch(int(rng.integers(1, 50)))[:2] for _ in range(n)]


def _verdicts(svc, tickets):
    return [(v.doc_id, v.admitted, v.reason, v.neighbor_id,
             int(np.float32(v.similarity).view(np.uint32)))
            for t in tickets for v in svc.results(t)]


def _states_equal(a, b):
    sa, sb = stack_states(a.backend.states), stack_states(b.backend.states)
    for f in sa._fields:
        np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f),
                                      err_msg=f)


@pytest.mark.parametrize("shards", [1, 4])
def test_service_equals_process_batch_loop_over_its_micro_batches(shards):
    """Ragged requests make micro-batches padded to 32 rows (valid=False
    tails), which the backend pads again to a multiple of nshards: the
    service's verdicts and index equal a process_batch loop over the valid
    rows of the same micro-batches; at one shard they also equal the JAX
    service's, similarity bits included."""
    port = DedupService(ServiceConfig(fold=FoldConfig(**FOLD), shards=shards,
                                      backend="hnsw_sharded", device="cpu",  # foldlint: disable=F141 (the port's ServiceConfig adds device)
                                      **SVC))
    emitted = []
    port.outcome_hooks.append(lambda o: emitted.append(o.batch))
    chunks = _chunks(6, seed=2)
    tickets = [port.submit(t, ln) for t, ln in chunks]
    port.flush()
    got = _verdicts(port, tickets)
    assert any(mb.n_docs < mb.shape[0] for mb in emitted)
    ref = make_pipeline("hnsw_sharded", FoldConfig(**FOLD), shards=shards,
                        device="cpu")  # foldlint: disable=F131 (the port's factories add device)
    keep = np.concatenate([ref.process_batch(mb.tokens[:mb.n_docs],
                                             mb.lengths[:mb.n_docs])[0]
                           for mb in emitted])
    order = np.concatenate([mb.doc_ids[:mb.n_docs] for mb in emitted])
    assert np.array_equal(keep, np.asarray([v[1] for v in got])[order])
    _states_equal(ref, port.pipeline)
    assert all(v[3] == -1 for v in got)       # the fused step's neighbors
    if shards == 1:
        jax_svc = JaxDedupService(JaxServiceConfig(
            fold=JaxFoldConfig(**FOLD), backend="hnsw_sharded", **SVC))
        jt = [jax_svc.submit(t, ln) for t, ln in chunks]
        jax_svc.flush()
        assert got == _verdicts(jax_svc, jt)
        assert port.stats()["counters"] == jax_svc.stats()["counters"]


@pytest.mark.parametrize("depth", [0, 2])
def test_executor_serves_the_fused_step_at_any_depth(depth):
    """The executor drives the fused backend like any other: pipeline
    depth changes no verdict, and a sampled batch records t_fused_step
    (the split stages read 0), as JAX's service does at one shard."""
    chunks = _chunks(4, seed=3)
    out = {}
    for shards in (1, 4):
        svc = DedupService(ServiceConfig(
            fold=FoldConfig(**FOLD), shards=shards, backend="hnsw_sharded",
            device="cpu", **dict(SVC, stage_timer_every=2),  # foldlint: disable=F141 (the port's ServiceConfig adds device)
            pipeline_depth=depth))
        out[shards] = (_verdicts(svc, [svc.submit(t, ln)
                                       for t, ln in chunks]),
                       svc.stats()["latency_ms"])
    jax_svc = JaxDedupService(JaxServiceConfig(
        fold=JaxFoldConfig(**FOLD), backend="hnsw_sharded",
        pipeline_depth=depth, **dict(SVC, stage_timer_every=2)))
    jt = [jax_svc.submit(t, ln) for t, ln in chunks]
    assert out[1][0] == _verdicts(jax_svc, jt)
    lat = out[1][1]
    assert lat["t_fused_step_ms"]["n"] >= 1 and lat["t_insert_ms"]["max"] == 0
    assert {k: h["n"] for k, h in lat.items()} == {
        k: h["n"] for k, h in jax_svc.stats()["latency_ms"].items()}
    assert "t_fused_step_ms" in out[4][1]
    assert sum(v[1] for v in out[4][0]) > 0


def test_service_grow_snapshot_restore_delete_roundtrip(tmp_path):
    """The reference's lifecycle round trip at 4 shards: watermark growth
    across every shard, a coordinated snapshot, restore into a fresh
    service, then the deletion contract through global slot ids."""
    def build():
        return DedupService(ServiceConfig(
            fold=FoldConfig(**dict(FOLD, capacity=32)), shards=4,
            snapshot_dir=str(tmp_path), device="cpu", **SVC))  # foldlint: disable=F141 (the port's ServiceConfig adds device)

    svc = build()
    src = SyntheticCorpus(dataclasses.replace(DATASET_PRESETS["lm1b"],
                                              seed=11, max_len=64))
    batches = [src.next_batch(32)[:2] for _ in range((32 * 4) // 32 + 2)]
    for t, ln in batches:
        svc.submit(t, ln)
    svc.flush()
    assert svc.stats()["index"]["grow_events"] >= 1
    assert svc.pipeline.backend.hnsw_cfg.capacity > 32
    step = svc.index_manager.snapshot()
    assert step >= 1
    svc2 = build()
    assert svc2.index_manager.restore_latest() == step
    pipe = svc2.pipeline
    assert pipe.inserted == svc.pipeline.inserted
    _states_equal(pipe, svc.pipeline)
    assert pipe.process_batch(*batches[0])[0].sum() == 0
    pipe.backend.track_slots = True
    t, ln = _batch(32, seed=12)
    keep = pipe.process_batch(t, ln)[0]
    slots = np.concatenate(pipe.backend.pop_slot_log())
    assert len(set((slots % 4).tolist())) == 4      # every shard admitted
    n0 = pipe.inserted
    assert pipe.delete(slots) == len(slots) == int(keep.sum())
    assert pipe.inserted == n0 - len(slots)
    assert pipe.process_batch(t, ln)[0].sum() == int(keep.sum())


@pytest.mark.parametrize("shards", [1, 4])
def test_cluster_writer_replica_epoch_roundtrip(tmp_path, shards):
    """Writer -> replica epochs on the sharded backend: published stacked
    snapshots restore on replicas whose merged-search answers equal the
    writer's, tombstones included (global interleaved ids); at one shard
    they equal a JAX cluster's answers too."""
    def run(ns, cfg_cls, svc_cls, cluster_cls, path, **dev):
        scfg = svc_cls(fold=cfg_cls(**FOLD), backend="hnsw_sharded",
                       shards=shards, snapshot_dir=str(path), **SVC, **dev)
        cl = cluster_cls(ns(service=scfg, n_replicas=2))
        t, ln = _batch(64, seed=13)
        cl.results(cl.submit(t, ln))
        pipe = cl.writer.service.pipeline
        ids = np.asarray(pipe.backend.search(pipe.signatures(t, ln))[0])
        live = np.unique(ids[ids >= 0])
        kill = live[::2]
        assert pipe.delete(kill) == len(kill)
        assert cl.publish() >= 1
        assert cl.refresh_replicas() == 2
        qw = cl.writer.query(t, ln)
        assert qw.is_dup.any() and not qw.is_dup.all()
        for r in cl.replicas:
            qr = r.query(t, ln)
            assert r.epoch == cl.writer.epoch
            assert np.array_equal(qw.is_dup, qr.is_dup)
            assert np.array_equal(qw.ids, qr.ids)
            assert np.array_equal(np.asarray(qw.sims).view(np.uint32),
                                  np.asarray(qr.sims).view(np.uint32))
        return qw, kill

    qw, kill = run(ClusterConfig, FoldConfig, ServiceConfig, DedupCluster,
                   tmp_path / "port", device="cpu")
    if shards == 4:
        assert len(set((kill % 4).tolist())) > 1     # deletes were routed
    else:
        jq, jkill = run(JaxClusterConfig, JaxFoldConfig, JaxServiceConfig,
                        JaxDedupCluster, tmp_path / "jax")
        assert np.array_equal(kill, jkill)
        for a, b in zip(qw[:3], jq[:3]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_tenant_budget_evicts_through_the_routed_delete(tmp_path):
    """A live-doc budget on a 4-shard writer evicts the tenant's oldest
    docs through delete by global id: every eviction lands, the budget
    holds, and a replica of the published epoch answers as the writer."""
    from repro_torch.cluster import ClusterWriter, ReadReplica
    scfg = ServiceConfig(fold=FoldConfig(**FOLD), shards=4,
                         snapshot_dir=str(tmp_path), device="cpu", **SVC)  # foldlint: disable=F141 (the port's ServiceConfig adds device)
    w = ClusterWriter(ClusterConfig(service=scfg, tenants=(
        TenantSpec("budget", max_live_docs=40),)))
    for i in range(4):
        w.submit(*_batch(32, seed=20 + i), tenant="budget")
    w.flush()
    ten = w.stats()["cluster"]["tenants"]["budget"]
    pipe = w.service.pipeline
    assert ten["evicted"] > 0 and pipe.deleted == ten["evicted"]
    assert ten["live_docs"] <= 40 and pipe.inserted == ten["live_docs"]
    w.publish()
    r = ReadReplica(scfg)
    assert r.refresh()
    probe = _batch(48, seed=21)
    qw, qr = w.query(*probe), r.query(*probe)
    assert np.array_equal(qw.is_dup, qr.is_dup)
    assert np.array_equal(qw.ids, qr.ids)


@pytest.mark.parametrize("shards", [1, 4])
def test_capacity_guard_refuses_with_a_grow_hint(shards):
    """A batch that could overflow any shard is refused before anything
    changes, naming grow(); after grow() the same batch lands. At one
    shard the refusal is the JAX package's, word for word."""
    cfg = dict(FOLD, capacity=40)
    pipe = make_pipeline("hnsw_sharded", FoldConfig(**cfg), shards=shards,
                         device="cpu")  # foldlint: disable=F131 (the port's factories add device)
    pipe.process_batch(*_batch(24 * shards, seed=30))
    before = stack_states(pipe.backend.states)
    big = _batch(64 * shards, seed=31)
    with pytest.raises(RuntimeError, match="sharded index full") as ei:
        pipe.process_batch(*big)
    assert "grow()" in str(ei.value)
    after = stack_states(pipe.backend.states)
    for f in before._fields:
        np.testing.assert_array_equal(getattr(before, f), getattr(after, f))
    if shards == 1:
        jpipe = jax_make_pipeline("hnsw_sharded", cfg=JaxFoldConfig(**cfg))
        jpipe.process_batch(*_batch(24, seed=30))
        with pytest.raises(RuntimeError) as jei:
            jpipe.process_batch(*big)
        assert str(ei.value) == str(jei.value)
    pipe.grow(4 * pipe.capacity)
    keep = pipe.process_batch(*big)[0]
    assert keep.sum() > 0 and pipe.inserted == int(
        before.count.sum()) + int(keep.sum())
