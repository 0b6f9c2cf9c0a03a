"""The PyTorch port's cluster layer held against the JAX package, case for
case with tests/test_cluster.py: manifests (byte-identical JSON),
epoch resume, replica skip/lag/degrade, the router's fallback and
staleness gate, tenant QPS quotas (exact retry-after on an injected
clock), queue-full admission and live-doc budget eviction give equal
verdicts, counters, query results and states in both packages; and a
replica of either package serves an epoch the other package's writer
published exactly as that writer's own `query` does."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.cluster import Backpressure as JaxBackpressure
from repro.cluster import ClusterConfig as JaxClusterConfig
from repro.cluster import ClusterManifest as JaxClusterManifest
from repro.cluster import ClusterWriter as JaxClusterWriter
from repro.cluster import DedupCluster as JaxDedupCluster
from repro.cluster import ReadReplica as JaxReadReplica
from repro.cluster import TenantSpec as JaxTenantSpec
from repro.cluster import TokenBucket as JaxTokenBucket
from repro.cluster import publish_manifest as jax_publish_manifest
from repro.core import hnsw as J
from repro.core.dedup import FoldConfig as JaxFoldConfig
from repro.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro.index import accepted_opts as jax_accepted_opts
from repro.index import make_pipeline as jax_make_pipeline
from repro.service import DedupService as JaxDedupService
from repro.service import LogHistogram as JaxLogHistogram
from repro.service import ServiceConfig as JaxServiceConfig
from repro_torch.cluster import (MANIFEST_NAME, Backpressure, ClusterConfig,
                                 ClusterManifest, ClusterWriter, DedupCluster,
                                 ReadReplica, TenantSpec, TokenBucket,
                                 publish_manifest, read_manifest)
from repro_torch.core import hnsw as T
from repro_torch.core.dedup import FoldConfig
from repro_torch.index import accepted_opts, make_pipeline, validate_opts
from repro_torch.service import DedupService, LogHistogram, ServiceConfig

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)

CFG = dict(capacity=512, M=8, M0=16, ef_construction=32, ef_search=32,
           threshold_space="minhash")

# one name space per package, so each scenario is written once
JAX = dict(FoldConfig=JaxFoldConfig, ServiceConfig=JaxServiceConfig,
           ClusterConfig=JaxClusterConfig, ClusterWriter=JaxClusterWriter,
           DedupCluster=JaxDedupCluster, ReadReplica=JaxReadReplica,
           TenantSpec=JaxTenantSpec, Backpressure=JaxBackpressure,
           DedupService=JaxDedupService, device={})
PORT = dict(FoldConfig=FoldConfig, ServiceConfig=ServiceConfig,
            ClusterConfig=ClusterConfig, ClusterWriter=ClusterWriter,
            DedupCluster=DedupCluster, ReadReplica=ReadReplica,
            TenantSpec=TenantSpec, Backpressure=Backpressure,
            DedupService=DedupService, device={"device": "cpu"})


def _batch(n=64, seed=0):
    src = SyntheticCorpus(dataclasses.replace(DATASET_PRESETS["lm1b"],
                                              seed=seed))
    return src.next_batch(n)[:2]


def _scfg(P, d, fold=None, **kw):
    base = dict(fold=P["FoldConfig"](**(fold or CFG)), backend="hnsw",
                max_batch=32, max_wait_ms=0.0, batch_buckets=(32,),
                max_len=64, stage_timer_every=0, snapshot_dir=str(d))
    base.update(kw)
    base.update(P["device"])
    return P["ServiceConfig"](**base)


def _both(tmp_path, scenario):
    """Run scenario(P, dir) for each package in its own directory."""
    return (scenario(JAX, tmp_path / "jax"), scenario(PORT, tmp_path / "port"))


def _assert_query_equal(got, want):
    for field in ("is_dup", "ids", "exact_hit"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    np.testing.assert_array_equal(np.asarray(got.sims).view(np.uint32),
                                  np.asarray(want.sims).view(np.uint32))


def _verdict_tuples(vs):
    return [(v.doc_id, v.admitted, v.reason, v.neighbor_id,
             int(np.float32(v.similarity).view(np.uint32))) for v in vs]


def _assert_states_equal(port_pipe, jax_pipe):
    got = T.state_to_numpy(port_pipe.backend.state)
    for field in J.HNSWState._fields:
        np.testing.assert_array_equal(
            got[field], np.asarray(getattr(jax_pipe.backend.state, field)),
            err_msg=field)


class _Clock:
    """An injected clock that moves only when told to."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


# ----------------------------------------------------------------- manifest
def test_manifest_round_trip_corruption_and_bytes_as_jax(tmp_path):
    d = tmp_path / "port"
    assert read_manifest(str(d)) is None                 # cold directory
    fields = dict(epoch=3, step=128, count=100, backend="hnsw",
                  published_unix=1.0, extra={"exact_entries": 7})
    m = ClusterManifest(**fields)
    publish_manifest(str(d), m)
    jax_publish_manifest(str(tmp_path / "jax"), JaxClusterManifest(**fields))
    assert (d / MANIFEST_NAME).read_bytes() == \
        (tmp_path / "jax" / MANIFEST_NAME).read_bytes()
    assert read_manifest(str(d)) == m
    assert read_manifest(str(tmp_path / "jax")) == m     # reads the JAX file
    (d / MANIFEST_NAME).write_text("{not json")
    assert read_manifest(str(d)) is None


def test_writer_epoch_resumes_across_restart_as_jax(tmp_path):
    def run(P, d):
        scfg = _scfg(P, d)
        w1 = P["ClusterWriter"](P["ClusterConfig"](service=scfg,
                                                   n_replicas=0))
        t, ln = _batch(32, seed=1)
        v1 = w1.results(w1.submit(t, ln))
        e1 = w1.publish()
        w2 = P["ClusterWriter"](P["ClusterConfig"](service=scfg,
                                                   n_replicas=0))
        t2, l2 = _batch(32, seed=2)
        v2 = w2.results(w2.submit(t2, l2))
        return (e1, w2.epoch, w2.publish(), _verdict_tuples(v1 + v2),
                w2.service.index_manager.committed_steps())
    want, got = _both(tmp_path, run)
    assert got == want
    assert got[:3] == (1, 1, 2)
    # a port writer resumes past the epoch a JAX writer published
    w3 = ClusterWriter(ClusterConfig(service=_scfg(PORT, tmp_path / "jax"),
                                     n_replicas=0))
    assert w3.epoch == 2 and w3.publish() == 3


# ----------------------------------------------------------------- replicas
def test_replica_skips_to_newest_epoch_and_counts_lag_as_jax(tmp_path):
    def run(P, d):
        scfg = _scfg(P, d)
        w = P["ClusterWriter"](P["ClusterConfig"](service=scfg, n_replicas=0))
        r = P["ReadReplica"](scfg)
        t, ln = _batch(32, seed=3)
        w.results(w.submit(t, ln))
        w.publish()
        out = [r.refresh(), r.epoch]
        for seed in (4, 5, 6):
            t2, l2 = _batch(16, seed=seed)
            w.results(w.submit(t2, l2))
            w.publish()
        out += [r.refresh(), r.epoch, r.epochs_skipped, r.epochs_behind,
                r.refresh(), r.stats()["cluster"]["count"]]
        return out, r.query(t, ln), w.query(t, ln)
    (want, jq, jw), (got, q, qw) = _both(tmp_path, run)
    assert got == want
    assert got[:7] == [True, 1, True, 4, 2, 0, False]
    _assert_query_equal(q, jq)
    _assert_query_equal(q, qw)


def test_replica_degrades_when_published_step_rotated_as_jax(tmp_path):
    def run(P, d):
        scfg = _scfg(P, d)
        w = P["ClusterWriter"](P["ClusterConfig"](service=scfg, n_replicas=0))
        r = P["ReadReplica"](scfg)
        t, ln = _batch(32, seed=7)
        w.results(w.submit(t, ln))
        w.publish()
        assert r.refresh() and r.epoch == 1
        before = r.pipeline
        pub = publish_manifest if P is PORT else jax_publish_manifest
        Man = ClusterManifest if P is PORT else JaxClusterManifest
        pub(str(d), Man(epoch=9, step=10 ** 9, count=0, backend="hnsw",
                        published_unix=0.0))
        out = [r.refresh(), r.refresh_failures, r.pipeline is before,
               r.epoch, r.epochs_behind]
        return out, r.stats()["counters"]
    want, got = _both(tmp_path, run)
    assert got == want
    assert got[0] == [False, 1, True, 1, 8]


def test_router_fallback_cold_then_round_robin_as_jax(tmp_path):
    def run(P, d):
        cl = P["DedupCluster"](P["ClusterConfig"](service=_scfg(P, d),
                                                  n_replicas=2))
        t, ln = _batch(32, seed=8)
        cl.results(cl.submit(t, ln))
        cold = cl.query(t, ln)                 # nothing published yet
        out = [bool(cold.is_dup.all()),
               cl.metrics.snapshot()["counters"]["query_fallback_writer"]]
        cl.publish()
        out.append(cl.refresh_replicas())
        warm = [cl.query(t[:4], ln[:4]) for _ in range(4)]
        out += [r.metrics.snapshot()["counters"]["queries"]
                for r in cl.replicas]
        out.append(cl.metrics.snapshot()["counters"])
        return out, cold, warm
    (want, jcold, jwarm), (got, cold, warm) = _both(tmp_path, run)
    assert got == want
    assert got[:5] == [True, 1, 2, 2, 2]
    _assert_query_equal(cold, jcold)
    for g, w in zip(warm, jwarm):
        _assert_query_equal(g, w)


def test_router_staleness_gate_routes_around_lagging_replicas_as_jax(
        tmp_path):
    def run(P, d):
        cl = P["DedupCluster"](P["ClusterConfig"](
            service=_scfg(P, d), n_replicas=1, max_staleness_epochs=1))
        t, ln = _batch(32, seed=9)
        cl.results(cl.submit(t, ln))
        cl.publish()
        out = [cl.refresh_replicas()]
        for seed in (10, 11):
            t2, l2 = _batch(16, seed=seed)
            cl.results(cl.submit(t2, l2))
            cl.publish()
        out.append(cl.writer.epoch - cl.replicas[0].epoch)
        before = cl.replicas[0].metrics.snapshot()["counters"].get(
            "queries", 0)
        q = cl.query(t[:4], ln[:4])
        out.append(cl.replicas[0].metrics.snapshot()["counters"].get(
            "queries", 0) - before)
        out.append(cl.metrics.snapshot()["counters"]["query_fallback_writer"])
        return out, q
    (want, jq), (got, q) = _both(tmp_path, run)
    assert got == want == [1, 2, 0, 1]
    _assert_query_equal(q, jq)


# ------------------------------------------------------------------ tenancy
def test_token_bucket_eta_matches_jax():
    """Continuous refill and the exact retry-after on an injected clock."""
    clocks = [_Clock(), _Clock()]
    b = TokenBucket(3.0, burst=8, clock=clocks[0])
    jb = JaxTokenBucket(3.0, burst=8, clock=clocks[1])
    for step, n in ((0.0, 5), (0.1, 4), (0.25, 2), (1.0, 8), (0.0, 1),
                    (3.0, 9)):
        for c in clocks:
            c.t += step
        assert b.try_take(n) == jb.try_take(n)
        assert b.eta(n) == jb.eta(n)
        assert b._tokens == jb._tokens


def test_qps_quota_rejects_only_the_greedy_tenant_as_jax(tmp_path):
    """An over-quota tenant is rejected with the same exact retry-after
    hint, and the other tenant's admission is the same in both."""
    def run(P, d):
        clock = _Clock()
        w = P["ClusterWriter"](P["ClusterConfig"](
            service=_scfg(P, d), n_replicas=0,
            tenants=(P["TenantSpec"]("bulk"),
                     P["TenantSpec"]("greedy", qps=1.0, burst=8))),
            clock=clock)
        t, ln = _batch(8, seed=12)
        v = w.results(w.submit(t, ln, tenant="greedy"))  # drains the burst
        clock.t += 0.25
        with pytest.raises(P["Backpressure"]) as ei:
            w.submit(t, ln, tenant="greedy")
        t2, l2 = _batch(32, seed=13)
        v += w.results(w.submit(t2, l2, tenant="bulk"))
        c = w.stats()["cluster"]
        return (ei.value.reason, ei.value.tenant, ei.value.retry_after_s,
                _verdict_tuples(v), c["tenants"], c["pending_ownership"])
    want, got = _both(tmp_path, run)
    assert got == want
    assert got[:3] == ("qps_quota", "greedy", 7.75)
    assert got[4]["greedy"]["rejected_qps"] == 8
    assert got[4]["bulk"]["admitted"] > 0 and got[5] == 0


def test_queue_full_backpressure_never_burns_quota_as_jax(tmp_path):
    def run(P, d):
        clock = _Clock()
        w = P["ClusterWriter"](P["ClusterConfig"](
            service=_scfg(P, d, max_pending_docs=32, retry_after_s=0.125),
            n_replicas=0,
            tenants=(P["TenantSpec"]("t0", qps=1e6, burst=64),)),
            clock=clock)
        t, ln = _batch(32, seed=14)
        tk = w.submit(t, ln, tenant="t0")
        big = _batch(64, seed=15)
        with pytest.raises(P["Backpressure"]) as ei:
            w.submit(big[0], big[1], tenant="t0")
        rejected = w.stats()["cluster"]["tenants"]["t0"]["rejected_queue"]
        v = w.results(tk)                          # drain the queue first
        t3, l3 = _batch(31, seed=16)
        v += w.results(w.submit(t3, l3, tenant="t0"))   # no Backpressure
        return (ei.value.reason, ei.value.retry_after_s, rejected,
                _verdict_tuples(v), w.stats()["cluster"]["tenants"],
                w.stats()["counters"])
    want, got = _both(tmp_path, run)
    assert got == want
    assert got[:3] == ("queue_full", 0.125, 64)
    assert got[4]["t0"]["rejected_qps"] == 0


def test_live_doc_budget_evicts_oldest_without_touching_others_as_jax(
        tmp_path):
    """Budget evictions go through the deletion contract identically: the
    same tenant ledgers, evictions, index state and read verdicts."""
    def run(P, d):
        cl = P["DedupCluster"](P["ClusterConfig"](
            service=_scfg(P, d), n_replicas=0,
            tenants=(P["TenantSpec"]("capped", max_live_docs=8),
                     P["TenantSpec"]("free"))))
        w = cl.writer
        tc, lc = _batch(32, seed=17)
        tf, lf = _batch(32, seed=18)
        v = w.results(w.submit(tf, lf, tenant="free"))
        v += w.results(w.submit(tc, lc, tenant="capped"))
        return (_verdict_tuples(v), w.stats()["cluster"]["tenants"],
                w.stats()["counters"], w.query(tf, lf), w.query(tc, lc),
                w.service.pipeline)
    (want, jten, jc, jqf, jqc, jpipe), (got, ten, c, qf, qc, pipe) = \
        _both(tmp_path, run)
    assert got == want and ten == jten and c == jc
    assert ten["capped"]["live_docs"] <= 8
    assert ten["capped"]["evicted"] == \
        ten["capped"]["admitted"] - ten["capped"]["live_docs"] > 0
    assert ten["free"]["evicted"] == 0
    _assert_query_equal(qf, jqf)
    _assert_query_equal(qc, jqc)
    assert qf.is_dup.all() and not qc.is_dup.all()
    _assert_states_equal(pipe, jpipe)
    assert pipe.deleted == jpipe.deleted > 0


@pytest.mark.parametrize("case", ["budgets_vs_lifecycle",
                                  "exact_filter_vs_lifecycle"])
def test_exclusive_options_refused_as_jax(tmp_path, case):
    def run(P, d):
        with pytest.raises(ValueError) as ei:
            if case == "budgets_vs_lifecycle":
                P["ClusterWriter"](P["ClusterConfig"](
                    service=_scfg(P, d, max_live_docs=64), n_replicas=0,
                    tenants=(P["TenantSpec"]("t", max_live_docs=8),)))
            else:
                P["DedupService"](_scfg(
                    P, d, fold=dict(CFG, exact_filter=True), ttl_steps=4))
        return str(ei.value).replace("repro_torch.", "repro.")
    want, got = _both(tmp_path, run)
    assert got == want
    assert ("slot-log consumer" if case == "budgets_vs_lifecycle"
            else "exact_filter") in got


# --------------------------------------------------------- exact-dup filter
def test_exact_filter_short_circuits_and_snapshots_as_jax(tmp_path):
    """Byte-identical resubmits short-circuit at the front door with the
    same verdicts; the filter snapshots with the index, and a restored
    pipeline of either package replays through the exact path."""
    fold = dict(CFG, exact_filter=True)

    def run(P, d):
        svc = P["DedupService"](_scfg(P, d, fold=fold))
        t, ln = _batch(32, seed=19)
        first = svc.results(svc.submit(t, ln))
        second = svc.results(svc.submit(t, ln))
        st = svc.stats()["index"]
        svc.flush()
        step = svc.index_manager.snapshot(sync=True)
        return (_verdict_tuples(first + second), st["exact_hits"],
                st["exact_entries"], step)
    want, got = _both(tmp_path, run)
    assert got == want
    verdicts, hits, entries, step = got
    admitted = [v for v in verdicts[:32] if v[1]]
    assert admitted and hits >= len(admitted) == entries
    for v0, v in zip(verdicts[:32], verdicts[32:]):
        if v0[1]:
            assert v[2] == "exact_dup" and v[3] == v0[0]
            assert v[4] == np.float32(1.0).view(np.uint32)
    t, ln = _batch(32, seed=19)
    for src in ("jax", "port"):
        pipe = make_pipeline("hnsw", cfg=FoldConfig(**fold), device="cpu")  # foldlint: disable=F131 (the port's factories take device)
        assert pipe.restore(str(tmp_path / src), step) == step
        keep, stats = pipe.process_batch(t, ln)
        assert not keep.any()
        assert stats["n_exact_hits"] == len(t) and stats["t_search"] == 0.0
    jpipe = jax_make_pipeline("hnsw", cfg=JaxFoldConfig(**fold))
    assert jpipe.restore(str(tmp_path / "port"), step) == step
    assert jpipe.process_batch(t, ln)[1]["n_exact_hits"] == len(t)


# ------------------------------------------------------------ metrics/opts
def test_log_histogram_quantiles_match_jax():
    """The same observations give the same bucket counts and bit-equal
    quantiles and summary; the quantiles stay within the bucket error."""
    h, jh = LogHistogram(), JaxLogHistogram()
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.lognormal(mean=2.0, sigma=1.5, size=20_000),
                           [0.0, 5e-4, 1e-3, 1e5, 3e5]])
    for v in vals:
        h.observe(float(v))
        jh.observe(float(v))
    np.testing.assert_array_equal(h.counts, jh.counts)
    for q in (0.0, 0.001, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert h.quantile(q) == jh.quantile(q), q
    assert h.summary() == jh.summary()
    s = h.summary()
    for q, key in ((0.5, "p50"), (0.99, "p99")):
        exact = float(np.quantile(vals, q))
        assert abs(s[key] - exact) / exact < 0.13, (key, s[key], exact)
    assert LogHistogram().summary() == JaxLogHistogram().summary() == {"n": 0}


def test_backend_opts_validated_with_accepted_keys_as_jax():
    """The accepted sets are the reference's plus the port's `device`, and
    an unknown key raises with the same message."""
    for key in ("hnsw", "brute"):
        assert set(accepted_opts(key)) - {"device"} == \
            set(jax_accepted_opts(key)), key
        assert "device" in accepted_opts(key)
    assert "query_chunk" in accepted_opts("hnsw")
    validate_opts("hnsw", {"query_chunk": 64, "device": "cpu"})
    for backend in ("hnsw", "brute"):
        msgs = []
        for P in (JAX, PORT):
            with pytest.raises(ValueError) as ei:
                P["DedupService"](P["ServiceConfig"](
                    fold=P["FoldConfig"](**CFG), backend=backend,
                    backend_opts={"quey_chunk": 64}, stage_timer_every=0,
                    **P["device"]))
            msgs.append(str(ei.value).split("accepted keys: "))
        (jhead, jkeys), (head, keys) = msgs
        assert head == jhead and "quey_chunk" in head
        assert set(keys.split(", ")) - {"device"} == \
            set(jkeys.split(", ")) - {"(none)"}


# ------------------------------------------------------ across the packages
@pytest.mark.parametrize("writer_pkg", ["jax", "port"])
def test_replica_serves_the_other_packages_published_epoch(tmp_path,
                                                           writer_pkg):
    """A replica of one package refreshed from the other package's
    ClusterWriter gives that writer's own query result at each epoch."""
    W, R = (JAX, PORT) if writer_pkg == "jax" else (PORT, JAX)
    scfg = _scfg(W, tmp_path)
    w = W["ClusterWriter"](W["ClusterConfig"](service=scfg, n_replicas=0))
    r = R["ReadReplica"](_scfg(R, tmp_path))
    probe, probe_len = _batch(24, seed=21)
    for seed in (22, 23):
        t, ln = _batch(32, seed=seed)
        w.results(w.submit(t, ln))
        epoch = w.publish()
        assert r.refresh() and r.epoch == epoch
        assert r.pipeline.inserted == w.service.pipeline.inserted
        for q_tok, q_len in ((probe, probe_len), (t, ln)):
            _assert_query_equal(r.query(q_tok, q_len), w.query(q_tok, q_len))
    assert r.stats()["cluster"]["epochs_behind"] == 0
