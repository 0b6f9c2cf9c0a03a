"""The PyTorch port's serving layer held against the JAX package, case for
case with tests/test_service.py: the same seeded traffic through the JAX
`DedupService` (and its batcher, executor and index manager) and the
port's, on the CPU, must give equal emitted micro-batches, `DocVerdict`
lists (similarity as the same f32 bits), counters, grow events,
committed snapshot steps, snapshot bytes and `HNSWState` after `flush`.
Wall-clock fields (`batch_ms`, `qps`, `wall_s`) are left out."""
import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import hnsw as J
from repro.core.bitmap import pack_bitmaps, popcount
from repro.core.dedup import FoldConfig as JaxFoldConfig
from repro.core.dedup import FoldPipeline as JaxFoldPipeline
from repro.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro.service import DedupService as JaxDedupService
from repro.service import IndexManager as JaxIndexManager
from repro.service import MicroBatcher as JaxMicroBatcher
from repro.service import PipelinedExecutor as JaxPipelinedExecutor
from repro.service import ServiceConfig as JaxServiceConfig
from repro.service import pow2_buckets as jax_pow2_buckets
from repro.service.batcher import MicroBatch as JaxMicroBatch
from repro_torch.core import hnsw as T
from repro_torch.core.dedup import FoldConfig, FoldPipeline
from repro_torch.service import (DedupService, IndexManager, MicroBatch,
                                 MicroBatcher, PipelinedExecutor,
                                 ServiceConfig, pow2_buckets)

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)

FC = dict(capacity=2048, ef_construction=32, ef_search=32,
          threshold_space="minhash")
SMALL = dict(capacity=128, M=8, M0=16, ef_construction=16, ef_search=16,
             threshold_space="minhash")


def _docs(n, seed=0, lo=8, hi=300):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 50_000, rng.integers(lo, hi)).astype(np.uint32)
            for _ in range(n)]


def _fresh_program_caches():
    """Empty both packages' program caches (JAX's process-wide jit caches
    and the port's signature sets; the JAX side recompiles): a service's
    compiled_programs then counts its own programs, whatever ran earlier
    in the process."""
    for fn in (J.hnsw_search, J.hnsw_insert_batch, J.hnsw_delete,
               J.hnsw_compact, T.hnsw_search, T.hnsw_insert_batch,
               T.hnsw_delete, T.hnsw_compact):
        fn.clear_cache()


def _services(fold, **svc):
    """The JAX service and the port's (on the CPU) from one config, with
    fresh program caches."""
    _fresh_program_caches()
    jax_svc = JaxDedupService(JaxServiceConfig(fold=JaxFoldConfig(**fold),
                                               **svc))
    port = DedupService(ServiceConfig(fold=FoldConfig(**fold), device="cpu",  # foldlint: disable=F141 (the port's ServiceConfig adds device)
                                      **svc))
    return jax_svc, port


def _pipes(fold):
    return JaxFoldPipeline(JaxFoldConfig(**fold)), FoldPipeline(
        FoldConfig(**fold), device="cpu")


def _assert_verdicts_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.doc_id, g.admitted, g.reason, g.neighbor_id) == \
            (w.doc_id, w.admitted, w.reason, w.neighbor_id), (g, w)
        assert np.float32(g.similarity).view(np.uint32) == \
            np.float32(w.similarity).view(np.uint32), (g, w)


def _assert_states_equal(port_pipe, jax_pipe):
    got = T.state_to_numpy(port_pipe.backend.state)
    for field in J.HNSWState._fields:
        np.testing.assert_array_equal(
            got[field], np.asarray(getattr(jax_pipe.backend.state, field)),
            err_msg=field)


def _assert_stats_equal(port, jax_svc):
    """Counters, index accounting and batching equal; latency histograms
    hold the same keys and counts (their values are wall clock)."""
    g, w = port.stats(), jax_svc.stats()
    assert g["counters"] == w["counters"]
    for key in ("backend", "count", "capacity", "occupancy", "grow_events",
                "snapshots", "n_deleted", "dead_fraction", "backend_stats"):
        assert g["index"][key] == w["index"][key], key
    gb, wb = dict(g["batching"]), dict(w["batching"])
    # the caches were emptied when the services were made: each count is
    # its package's programs since then, the port's delta and JAX's
    assert gb.pop("compiled_programs") == wb.pop("compiled_programs")
    assert gb == wb
    assert {k: h["n"] for k, h in g["latency_ms"].items()} == \
        {k: h["n"] for k, h in w["latency_ms"].items()}


# ------------------------------------------------------------------ batcher
def _drive_batcher(mk, case):
    """One batcher scenario; returns (emitted batches, batcher)."""
    if case == "bucketed":
        b = mk(max_batch=64, max_wait_ms=0.0, len_buckets=(64, 128, 256),
               batch_buckets=(16, 32, 64), max_len=256)
        rng = np.random.default_rng(0)
        out = []
        for doc_id, doc in enumerate(_docs(500, lo=1, hi=400)):
            b.add(doc_id, doc)
            if rng.random() < 0.3:
                out.extend(b.drain())
        out.extend(b.drain(force=True))
        return out, b
    if case == "full_batches":
        b = mk(max_batch=8, max_wait_ms=1e9, batch_buckets=(8,))
        for i, d in enumerate(_docs(20)):
            b.add(i, d)
        first = b.drain()
        assert b.pending == 4
        return first + b.drain(force=True), b
    if case == "max_len_300":
        b = mk(max_batch=8, max_wait_ms=0.0, max_len=300, batch_buckets=(8,))
        b.add(0, np.arange(1000, dtype=np.uint32))
        return b.drain(force=True), b
    if case == "requeue":
        b = mk(max_batch=16, max_wait_ms=0.0, batch_buckets=(4, 16))
        for i, d in enumerate(_docs(37, seed=5)):
            b.add(i, d)
        out = b.drain()
        for mb in reversed(out[1:]):
            b.requeue(mb)
        return out[:1] + b.drain(force=True), b
    assert case == "backpressure"
    b = mk(max_batch=8, max_wait_ms=1e9, batch_buckets=(8,), max_pending=5)
    for i, d in enumerate(_docs(9, seed=6)):
        try:
            b.add(i, d)
        except RuntimeError as e:     # Backpressure
            assert "queue_full" in str(e)
    assert not b.would_accept(1) and b.rejected == 4
    return b.drain(force=True), b


@pytest.mark.parametrize("case", ["bucketed", "full_batches", "max_len_300",
                                  "requeue", "backpressure"])
def test_batcher_matches_jax(case):
    """Same docs, same drain pattern: the emitted micro-batches (tokens,
    lengths, valid, doc ids, n_docs), shapes, truncation and rejection
    counts are equal; padding sits after every real row."""
    got, gb = _drive_batcher(MicroBatcher, case)
    want, wb = _drive_batcher(JaxMicroBatcher, case)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for field in MicroBatch._fields:
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field), err_msg=field)
            assert np.asarray(getattr(g, field)).dtype == \
                np.asarray(getattr(w, field)).dtype, field
        assert g.valid[: g.n_docs].all() and not g.valid[g.n_docs:].any()
    assert gb.emitted_shapes == wb.emitted_shapes
    assert (gb.truncated, gb.rejected, gb.pending) == \
        (wb.truncated, wb.rejected, wb.pending)
    if case == "bucketed":
        ids = np.concatenate([mb.doc_ids[mb.valid] for mb in got])
        assert sorted(ids.tolist()) == list(range(500)) and gb.truncated > 0


def test_pow2_buckets_match_jax():
    for lo, hi in ((32, 512), (32, 300), (32, 16), (1, 1), (5, 4097)):
        assert pow2_buckets(lo, hi) == jax_pow2_buckets(lo, hi)
    assert pow2_buckets(32, 300) == (32, 64, 128, 256, 300)


# ------------------------------------------------- pipelined == sequential
@pytest.mark.parametrize("depth", [0, 2])
def test_pipelined_equals_sequential_and_jax(depth):
    """The port's executor equals its own blocking process_batch loop and
    the JAX executor over the same micro-batches: keep, keep_in_batch, ids
    and sims per batch, and the final HNSWState."""
    src = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    batches = [src.next_batch(96)[:2] for _ in range(4)]

    seq = FoldPipeline(FoldConfig(**FC), device="cpu")
    keep_seq = np.concatenate(
        [seq.process_batch(t, ln)[0] for t, ln in batches])

    jax_pipe, pipe = _pipes(FC)
    got, want = [], []
    ex = PipelinedExecutor(pipe, depth=depth, on_outcome=got.append)
    jex = JaxPipelinedExecutor(jax_pipe, depth=depth, on_outcome=want.append)
    for t, ln in batches:
        B = t.shape[0]
        parts = (t.astype(np.uint32), ln, np.ones(B, bool),
                 np.arange(B, dtype=np.int64), B)
        ex.submit(MicroBatch(*parts))
        jex.submit(JaxMicroBatch(*parts))
        assert ex.inflight == jex.inflight <= depth
    ex.drain()
    jex.drain()
    assert np.array_equal(np.concatenate([o.keep for o in got]), keep_seq)
    for g, w in zip(got, want):
        for field in ("keep", "keep_in_batch", "ids", "sims"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field), err_msg=field)
            assert getattr(g, field).dtype == getattr(w, field).dtype
    _assert_states_equal(pipe, jax_pipe)
    _assert_states_equal(seq, jax_pipe)


# ----------------------------------------------------------------- growth
def test_hnsw_grow_preserves_search_as_jax():
    rng = np.random.default_rng(0)
    sigs = rng.integers(0, 2**32, (300, 112), dtype=np.uint32)
    bm = pack_bitmaps(jnp.asarray(sigs), T=4096)
    pcs = popcount(bm)
    cfg = J.HNSWConfig(capacity=512, words=128, M=8, M0=16,
                       ef_construction=32, ef_search=32, max_level=3)
    st, _ = J.hnsw_insert_batch(cfg, J.hnsw_init(cfg), bm, pcs,
                                jnp.asarray(J.sample_levels(300, cfg)),
                                jnp.ones(300, bool))
    tcfg = T.HNSWConfig(**cfg._asdict())
    tst = T.state_from_numpy({k: np.array(v) for k, v in st._asdict().items()},
                             "cpu")
    cfg2, st2 = J.hnsw_grow(cfg, st, 2048)
    tcfg2, tst2 = T.hnsw_grow(tcfg, tst, 2048)
    assert tcfg2.capacity == cfg2.capacity == 2048
    got = T.state_to_numpy(tst2)
    for field in J.HNSWState._fields:
        np.testing.assert_array_equal(got[field],
                                      np.asarray(getattr(st2, field)))
    q = torch.from_numpy(np.asarray(bm[:64]).view(np.int32).copy())
    ids0, sims0 = T.hnsw_search(tcfg, tst, q, k=4)
    ids1, sims1 = T.hnsw_search(tcfg2, tst2, q, k=4)
    jids, jsims = J.hnsw_search(cfg2, st2, bm[:64], k=4)
    np.testing.assert_array_equal(ids1.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(sims1.numpy(), np.asarray(jsims))
    np.testing.assert_array_equal(ids0.numpy(), ids1.numpy())


@pytest.mark.parametrize("case", ["past_initial_capacity",
                                  "headroom_smaller_than_batch"])
def test_service_growth_matches_jax(case):
    """Growth past the initial capacity (also when the headroom under the
    watermark is smaller than a batch): equal verdicts, grow events,
    counters and HNSWState; every admitted verdict is in the index."""
    if case == "past_initial_capacity":
        fold, svc, n_batches, B = SMALL, dict(
            max_batch=32, max_wait_ms=0.0, batch_buckets=(32,),
            grow_watermark=0.75, growth_factor=2.0), 12, 32
    else:
        fold, svc, n_batches, B = dict(SMALL, capacity=256), dict(
            max_batch=128, max_wait_ms=0.0, batch_buckets=(128,),
            grow_watermark=0.85, growth_factor=2.0), 4, 128
    jax_svc, port = _services(fold, **svc)
    src = SyntheticCorpus(DATASET_PRESETS["lm1b"])   # ~2% dups: fills fast
    for _ in range(n_batches):
        tok, ln = src.next_batch(B)[:2]
        tj, tt = jax_svc.submit(tok, ln), port.submit(tok, ln)
        assert tj == tt
    jax_svc.flush()
    port.flush()
    got = [v for i in range(n_batches) for v in port.results((i * B,
                                                               (i + 1) * B))]
    want = [v for i in range(n_batches)
            for v in jax_svc.results((i * B, (i + 1) * B))]
    _assert_verdicts_equal(got, want)
    s = port.stats()
    assert sum(v.admitted for v in got) == s["index"]["count"] > \
        fold["capacity"]
    assert s["index"]["grow_events"] >= 1
    assert port.index_manager.grow_events == jax_svc.index_manager.grow_events
    _assert_stats_equal(port, jax_svc)
    _assert_states_equal(port.pipeline, jax_svc.pipeline)


class _StubPipe:                         # just the lifecycle surface
    capacity, inserted = 128, 120        # past the 108-doc watermark

    def __init__(self):
        self.grows = []

    def grow(self, cap):
        self.grows.append(cap)
        self.capacity = cap


@pytest.mark.parametrize("factor,max_cap,inserted,incoming", [
    (1.005, 160, 155, 32),               # +1-per-step loop, then refuse
    (2.0, 160, None, 64),                # a partial clamp refuses too
])
def test_growth_refusal_matches_jax(factor, max_cap, inserted, incoming):
    """A near-1 growth factor does not spin, and a max_capacity ceiling
    refuses rather than silently dropping 'admitted' docs: both managers
    grow through the same capacities and refuse with the same message."""
    runs = []
    for Mgr in (IndexManager, JaxIndexManager):
        pipe = _StubPipe()
        mgr = Mgr(pipe, grow_watermark=0.85, growth_factor=factor,
                  max_capacity=max_cap)
        mgr._known_count = pipe.inserted     # as after a prior sync
        grew = None
        if inserted is not None:
            grew = mgr.maybe_grow(incoming=0)
            pipe.inserted = inserted
        with pytest.raises(RuntimeError, match="index full") as ei:
            mgr.maybe_grow(incoming=incoming)
        runs.append((grew, pipe.grows, pipe.capacity, str(ei.value),
                     mgr.grow_events))
    assert runs[0] == runs[1]
    assert runs[0][2] == max_cap


def test_pump_requeues_batches_on_refusal_as_jax():
    """When growth is refused mid-pump, un-dispatched docs return to the
    batcher queue in both packages, with the same counts."""
    jax_svc, port = _services(SMALL, max_batch=64, max_wait_ms=0.0,
                              batch_buckets=(64,), grow_watermark=0.85,
                              max_capacity=128)
    src = SyntheticCorpus(DATASET_PRESETS["lm1b"])  # ~2% dups: fills fast
    batches = [src.next_batch(64)[:2] for _ in range(4)]
    errs = []
    for svc in (jax_svc, port):
        with pytest.raises(RuntimeError, match="index full") as ei:
            for tok, ln in batches:
                svc.submit(tok, ln)
        errs.append(str(ei.value))
        svc.executor.drain()
    assert errs[0] == errs[1]
    assert port.batcher.pending == jax_svc.batcher.pending >= 64
    admitted = port.stats()["counters"].get("admitted", 0)
    assert admitted == port.backend.inserted <= 128
    _assert_stats_equal(port, jax_svc)
    _assert_states_equal(port.pipeline, jax_svc.pipeline)


# -------------------------------------------------------------- snapshots
def _jax_rotation_as_port(monkeypatch):
    """Keep the JAX IndexManager's own in-flight async step out of the
    listing its rotation reads, as the port's IndexManager does. The
    reference counts a background write that commits before the listing
    both as listed and as in flight, and rotates one step too many: a
    race that shows under load. The patch lives for one test; the JAX
    package itself is unchanged."""
    import repro.train.checkpoint as jckpt
    inflight: set = set()
    save_async, wait_pending = jckpt.save_async, jckpt.wait_pending
    list_steps = jckpt.list_steps

    def save_async_noted(ckpt_dir, step, tree, **kw):
        inflight.add((os.path.abspath(ckpt_dir), step))
        return save_async(ckpt_dir, step, tree, **kw)

    def wait_pending_cleared():
        wait_pending()
        inflight.clear()

    def list_committed(ckpt_dir):
        return [s for s in list_steps(ckpt_dir)
                if (os.path.abspath(ckpt_dir), s) not in inflight]

    monkeypatch.setattr(jckpt, "save_async", save_async_noted)
    monkeypatch.setattr(jckpt, "wait_pending", wait_pending_cleared)
    monkeypatch.setattr(jckpt, "list_steps", list_committed)


@pytest.mark.parametrize("key,max_snapshots", [
    ("hnsw", 1), ("hnsw", 2), ("hnsw", 3), ("hnsw_sharded", 2)])
def test_rotation_keeps_max_snapshots_when_async_write_commits_first(
        tmp_path, monkeypatch, key, max_snapshots):
    """An async snapshot whose write commits before the rotation lists the
    directory (forced here: save_async writes synchronously) is not
    counted twice: the port lands on exactly max_snapshots committed
    steps after every batch, the newest ones."""
    from repro_torch.index import make_pipeline
    from repro_torch.train import checkpoint as ckpt
    real_save = ckpt.save

    def save_now(ckpt_dir, step, tree, *, extra=None):
        real_save(ckpt_dir, step, tree, extra=extra)

    monkeypatch.setattr(ckpt, "save_async", save_now)
    opts = {"shards": 2} if key == "hnsw_sharded" else {}
    pipe = make_pipeline(key, FoldConfig(**SMALL), device="cpu", **opts)
    mgr = IndexManager(pipe, snapshot_dir=str(tmp_path), snapshot_every=1,
                       max_snapshots=max_snapshots)
    src = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    for i in range(1, 5):
        pipe.process_batch(*src.next_batch(16)[:2])
        mgr.after_batch()
        want = tuple(range(max(1, i - max_snapshots + 1), i + 1))
        assert mgr.committed_steps() == want, i
    assert sorted(os.listdir(tmp_path)) == [
        f"step_{s:08d}" for s in range(5 - max_snapshots, 5)]


def test_snapshot_rotation_roundtrip_as_jax(tmp_path, monkeypatch):
    """Rotation keeps the same committed steps, and each package restores
    its latest step into a fresh pipeline that replays as the donor."""
    _jax_rotation_as_port(monkeypatch)
    src = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    b1, b2, b3 = (src.next_batch(96)[:2] for _ in range(3))
    for tag, (pipe, Mgr), fresh in (
            ("jax", (JaxFoldPipeline(JaxFoldConfig(**FC)), JaxIndexManager),
             lambda: JaxFoldPipeline(JaxFoldConfig(**FC))),
            ("port", (FoldPipeline(FoldConfig(**FC), device="cpu"),
                      IndexManager),
             lambda: FoldPipeline(FoldConfig(**FC), device="cpu"))):
        d = str(tmp_path / tag)
        mgr = Mgr(pipe, snapshot_dir=d, snapshot_every=1, max_snapshots=2)
        for b in (b1, b2, b3):
            pipe.process_batch(*b)
            mgr.after_batch()
        mgr.wait_snapshots()
        assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
        assert mgr.committed_steps() == (2, 3)
        keep_ref, _ = pipe.process_batch(*b1)      # replay: all dups
        pipe2 = fresh()
        assert Mgr(pipe2, snapshot_dir=d).restore_latest() == 3
        assert pipe2.inserted == pipe.inserted
        assert np.array_equal(pipe2.process_batch(*b1)[0], keep_ref)
    for step in ("step_00000002", "step_00000003"):
        for name in ("arrays.msgpack", "MANIFEST.json"):
            assert (tmp_path / "port" / step / name).read_bytes() == \
                (tmp_path / "jax" / step / name).read_bytes(), (step, name)


def test_service_snapshots_byte_identical_to_jax(tmp_path, monkeypatch):
    """The torch service and the JAX service rotate snapshots over the same
    stream (async writes, max_snapshots=2): the same steps commit, and
    each committed step's arrays.msgpack and MANIFEST.json are the same
    bytes; a restarted manager resumes past them in both."""
    _jax_rotation_as_port(monkeypatch)
    dirs = {tag: str(tmp_path / tag) for tag in ("jax", "port")}
    svc = dict(max_batch=32, max_wait_ms=0.0, batch_buckets=(32,),
               stage_timer_every=0, snapshot_every=2, max_snapshots=2)
    _fresh_program_caches()
    jax_svc = JaxDedupService(JaxServiceConfig(
        fold=JaxFoldConfig(**FC), snapshot_dir=dirs["jax"], **svc))
    port = DedupService(ServiceConfig(
        fold=FoldConfig(**FC), snapshot_dir=dirs["port"], device="cpu", **svc))  # foldlint: disable=F141 (the port's ServiceConfig adds device)
    src = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    for _ in range(5):
        tok, ln = src.next_batch(48)[:2]
        jax_svc.submit(tok, ln)
        port.submit(tok, ln)
    jax_svc.flush()
    port.flush()
    steps = port.index_manager.committed_steps()
    assert steps == jax_svc.index_manager.committed_steps() and len(steps) == 2
    for step in steps:
        for name in ("arrays.msgpack", "MANIFEST.json"):
            path = os.path.join(f"step_{step:08d}", name)
            with open(os.path.join(dirs["port"], path), "rb") as f:
                got = f.read()
            with open(os.path.join(dirs["jax"], path), "rb") as f:
                assert got == f.read(), path
    _assert_stats_equal(port, jax_svc)
    mgr = IndexManager(FoldPipeline(FoldConfig(**FC), device="cpu"),
                       snapshot_dir=dirs["port"], max_snapshots=5)
    jmgr = JaxIndexManager(JaxFoldPipeline(JaxFoldConfig(**FC)),
                           snapshot_dir=dirs["jax"], max_snapshots=5)
    assert mgr.snapshot() == jmgr.snapshot() == steps[-1] + 1


@pytest.mark.parametrize("case", ["after_grow", "smaller_into_bigger"])
def test_restore_capacity_cases_match_jax(tmp_path, case):
    """A snapshot taken post-growth restores into a fresh small pipeline,
    and a smaller snapshot into a bigger config grows back to it: equal
    capacities, counts, states and replay verdicts in both packages."""
    small = dict(SMALL) if case == "after_grow" else dict(SMALL, capacity=256)
    src = SyntheticCorpus(DATASET_PRESETS["lm1b" if case == "after_grow"
                                          else "common_crawl"])
    b1 = src.next_batch(100)[:2]
    b2 = src.next_batch(100)[:2]
    restored = []
    for tag, mk in (("jax", lambda c: JaxFoldPipeline(JaxFoldConfig(**c))),
                    ("port", lambda c: FoldPipeline(FoldConfig(**c),
                                                    device="cpu"))):
        d = str(tmp_path / tag)
        pipe = mk(small)
        pipe.process_batch(*b1)
        if case == "after_grow":
            pipe.grow(512)
            pipe.process_batch(*b2)
        pipe.save(d, step=1)
        target = small if case == "after_grow" else dict(small, capacity=1024)
        pipe2 = mk(target)
        pipe2.restore(d, 1)
        assert pipe2.capacity == (512 if case == "after_grow" else 1024)
        assert pipe2.inserted == pipe.inserted
        replay = b2 if case == "after_grow" else b1
        keep_ref, _ = pipe.process_batch(*replay)
        keep_got, _ = pipe2.process_batch(*replay)
        assert np.array_equal(keep_got, keep_ref) and keep_got.sum() == 0
        restored.append(pipe2)
    _assert_states_equal(restored[1], restored[0])


def test_snapshot_step_resumes_past_existing_as_jax(tmp_path):
    """A restarted IndexManager does not clobber committed snapshots, and
    the port's resumes on the JAX package's directory too."""
    pipe = FoldPipeline(FoldConfig(**FC), device="cpu")
    mgr = IndexManager(pipe, snapshot_dir=str(tmp_path), max_snapshots=5)
    assert mgr.snapshot() == 1
    assert mgr.snapshot() == 2
    jmgr = JaxIndexManager(JaxFoldPipeline(JaxFoldConfig(**FC)),
                           snapshot_dir=str(tmp_path), max_snapshots=5)
    assert jmgr.snapshot() == 3
    mgr2 = IndexManager(FoldPipeline(FoldConfig(**FC), device="cpu"),
                        snapshot_dir=str(tmp_path), max_snapshots=5)
    assert mgr2.snapshot() == 4
    assert sorted(os.listdir(tmp_path))[-1] == "step_00000004"


# ------------------------------------------------------------ front API
def test_service_verdicts_and_metrics_match_jax():
    jax_svc, port = _services(FC, max_batch=64, max_wait_ms=0.0,
                              batch_buckets=(64,))
    src = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    toks, lens, _ = src.next_batch(100)
    v = {}
    for tag, svc in (("jax", jax_svc), ("port", port)):
        t1 = svc.submit(toks, lens)
        t2 = svc.submit(toks, lens)          # exact replay: all duplicates
        v[tag] = (svc.results(t1), svc.results(t2))
        with pytest.raises(KeyError):
            svc.results(t1)                  # results() pops
    _assert_verdicts_equal(v["port"][0] + v["port"][1],
                           v["jax"][0] + v["jax"][1])
    v1, v2 = v["port"]
    assert [x.doc_id for x in v1] == list(range(100))
    assert sum(x.admitted for x in v1) > 0 and sum(x.admitted for x in v2) == 0
    s = port.stats()
    assert s["counters"]["docs_in"] == s["counters"]["docs_out"] == 200
    assert s["counters"]["admitted"] == s["index"]["count"]
    assert s["latency_ms"]["batch_ms"]["n"] >= 2 and s["qps"] > 0
    _assert_stats_equal(port, jax_svc)
    _assert_states_equal(port.pipeline, jax_svc.pipeline)


def test_service_stage_timers_match_jax():
    """Every batch but the first runs in blocking timer mode: the sampled
    t_in_batch / t_search / t_insert histograms hold the same counts as the
    reference's, and the replay-duplicate verdicts are equal."""
    jax_svc, port = _services(FC, max_batch=64, max_wait_ms=0.0,
                              batch_buckets=(64,), stage_timer_every=1)
    assert port.pipeline.backend.hnsw_cfg.batched_insert
    assert port.pipeline.backend.cfg.reuse_search
    src = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    toks, lens, _ = src.next_batch(64)
    for svc in (jax_svc, port):
        svc.submit(toks, lens)
        svc.submit(toks, lens)
    _assert_verdicts_equal(port.results((0, 128)), jax_svc.results((0, 128)))
    lat = port.stats()["latency_ms"]
    for key in ("t_in_batch_ms", "t_search_ms", "t_insert_ms"):
        assert lat[key]["n"] == 1 and lat[key]["mean"] >= 0.0, key
    _assert_stats_equal(port, jax_svc)


def test_service_single_doc_requests_match_jax():
    """One-doc submits coalesce; verdicts still come back per ticket."""
    jax_svc, port = _services(FC, max_batch=16, max_wait_ms=1e9,
                              batch_buckets=(16,))
    docs = _docs(12, seed=3)
    got = []
    for svc in (jax_svc, port):
        tickets = [svc.submit([d]) for d in docs]
        assert svc.executor.inflight == 0 and svc.batcher.pending == 12
        svc.flush()
        got.append([svc.results(t)[0] for t in tickets])
    _assert_verdicts_equal(got[1], got[0])
    assert len({v.doc_id for v in got[1]}) == 12
    assert port.stats()["batching"]["compiled_shapes"] == [(16, 512)]
    _assert_stats_equal(port, jax_svc)


def test_service_config_device_and_sharding_rules():
    """ServiceConfig.device=None means cuda (raises without a card);
    shards > 1 promotes to hnsw_sharded, every shard on the service's
    device; any other backend with shards > 1 is refused;
    compiled_programs is program_cache_sizes()."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="found no GPU"):
            DedupService(ServiceConfig(fold=FoldConfig(**SMALL)))
        with pytest.raises(RuntimeError, match="found no GPU"):
            DedupService(ServiceConfig(fold=FoldConfig(**SMALL), shards=2))
    sharded = DedupService(ServiceConfig(fold=FoldConfig(**SMALL), shards=2,
                                         device="cpu"))  # foldlint: disable=F141 (the port's ServiceConfig adds device)
    be = sharded.pipeline.backend
    assert be.name == "hnsw_sharded" and be.nshards == 2
    assert be.capacity == 2 * SMALL["capacity"]
    assert all(st.vectors.device.type == "cpu" for st in be.states)
    with pytest.raises(ValueError, match="requires the 'hnsw_sharded'"):
        DedupService(ServiceConfig(fold=FoldConfig(**SMALL), shards=2,
                                   backend="brute", device="cpu"))  # foldlint: disable=F141 (the port's ServiceConfig adds device)
    port = DedupService(ServiceConfig(fold=FoldConfig(**SMALL),
                                      device="cpu"))  # foldlint: disable=F141 (the port's ServiceConfig adds device)
    assert port.pipeline.device == torch.device("cpu")
    assert port.stats()["batching"]["compiled_programs"] == \
        T.program_cache_sizes()
    assert [f.name for f in dataclasses.fields(ServiceConfig)] == [
        f.name for f in dataclasses.fields(JaxServiceConfig)] + ["device"]


def test_service_equals_process_batch_over_emitted_batches():
    """Ragged requests make padded micro-batches (B bucketed above the doc
    count): the port's service verdicts equal the JAX service's, and equal
    a process_batch loop over the valid rows of the same micro-batches,
    index state included."""
    jax_svc, port = _services(FC, max_batch=64, max_wait_ms=0.0,
                              batch_buckets=(64,), len_buckets=(512,))
    emitted = []
    port.outcome_hooks.append(lambda o: emitted.append(o.batch))
    src = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    rng = np.random.default_rng(4)
    tickets = []
    for _ in range(5):
        tok, ln = src.next_batch(int(rng.integers(1, 90)))[:2]
        tickets.append((jax_svc.submit(tok, ln), port.submit(tok, ln)))
    jax_svc.flush()
    port.flush()
    got = [v for _, t in tickets for v in port.results(t)]
    _assert_verdicts_equal(got, [v for t, _ in tickets
                                 for v in jax_svc.results(t)])
    assert any(mb.n_docs < mb.shape[0] for mb in emitted)
    _assert_stats_equal(port, jax_svc)     # before the port-only loop below
    ref = FoldPipeline(FoldConfig(**FC), device="cpu")
    keep = np.concatenate([ref.process_batch(mb.tokens[:mb.n_docs],
                                             mb.lengths[:mb.n_docs])[0]
                           for mb in emitted])
    order = np.concatenate([mb.doc_ids[:mb.n_docs] for mb in emitted])
    assert np.array_equal(keep, np.asarray([v.admitted for v in got])[order])
    _assert_states_equal(ref, jax_svc.pipeline)
