"""The port's `hnsw_sharded` at 4 shards held against the JAX package's on
4 virtual CPU devices.

JAX fixes its device count when it starts, so the reference runs ONCE, in
a subprocess with `--xla_force_host_platform_device_count=8` (the 4-shard
runs use the first 4 devices; the scale-out restore needs 8), as
tests/test_dist.py runs its sharded programs. Both sides run the same
scenario, written once below over a per-package name space: a 4-shard
pipeline through ragged, padded and masked batches, merged search and
query, delete by global id, compact, free-slot reuse, the capacity
guard's refusal, grow, snapshots (byte-equal, restored across the
packages, scale-out 4 -> 8, scale-in 4 -> 2 refused), the core step with
cross-shard ties, `sub_batches=2` and `masked=False`, and the service at
`shards=4`. The port runs first; the subprocess restores the port's
snapshot and writes every result to `tmp_path` as npz. Integers and f32
must be exactly equal."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.dedup import FoldConfig
from repro_torch.data.corpus import DATASET_PRESETS, SyntheticCorpus

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

FOLD = dict(capacity=128, M=8, M0=16, ef_construction=32, ef_search=32,
            tau=0.7, threshold_space="minhash")
SHARDS = 4
# batch sizes of the stream: ragged sizes pad to a multiple of 4
SIZES = (64, 62, 64, 61, 64, 64, 64, 64)
REASONS = ("admitted", "batch_dup", "index_dup", "exact_dup")


# ------------------------------------------------------------- the data
def _data() -> dict:
    """Seeded inputs of the scenario, made with the port's corpus copy
    (the same tokens as the reference's corpus) and handed to both
    sides."""
    src = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    d = {}
    for i, n in enumerate(SIZES):
        d[f"b{i}_tok"], d[f"b{i}_len"] = src.next_batch(n)[:2]
    d["valid"] = np.random.default_rng(0).random(SIZES[2]) < 0.8
    d["probe_tok"], d["probe_len"] = src.next_batch(40)[:2]
    d["big_tok"], d["big_len"] = src.next_batch(512)[:2]
    # 32 distinct docs, each twice in a row: rows 2i and 2i+1 land on
    # different shards, so every search for them ties across shards
    t, ln = src.next_batch(32)[:2]
    d["tie_tok"], d["tie_len"] = np.repeat(t, 2, axis=0), np.repeat(ln, 2)
    d["tieq_tok"], d["tieq_len"] = t, ln
    for i in range(2):
        d[f"sub{i}_tok"], d[f"sub{i}_len"] = src.next_batch(64)[:2]
    svc = SyntheticCorpus(dataclasses.replace(
        DATASET_PRESETS["common_crawl"], seed=5))
    rng = np.random.default_rng(6)
    n_chunks = 0
    for i in range(6):
        d[f"svc{i}_tok"], d[f"svc{i}_len"] = svc.next_batch(
            int(rng.integers(1, 60)))[:2]
        n_chunks += 1
    d["svc_chunks"] = np.int64(n_chunks)
    return d


def _pair(d, name):
    return d[f"{name}_tok"], d[f"{name}_len"]


# ------------------------------------------------- per-package name spaces
def _port_ns() -> dict:
    from repro_torch.core import sharded as S
    from repro_torch.core.dedup import bitmap_tau
    from repro_torch.core.hnsw import sample_levels
    from repro_torch.index import make_pipeline
    from repro_torch.service import DedupService, ServiceConfig
    return dict(
        FoldConfig=FoldConfig, bitmap_tau=bitmap_tau,
        sample_levels=sample_levels, DedupService=DedupService,
        ServiceConfig=ServiceConfig, dev={"device": "cpu"},
        make_pipeline=make_pipeline,
        stacked=lambda states: S.stack_states(states)._asdict(),
        init=lambda hcfg, n: S.sharded_init(hcfg, n, "cpu"),
        step=lambda hcfg, n, **kw: S.make_sharded_dedup_step(hcfg, n, **kw),
        search=lambda hcfg, n, **kw: S.make_sharded_search(hcfg, n, **kw),
        levels=torch.from_numpy)


def _jax_ns() -> dict:
    import jax
    import jax.numpy as jnp

    from repro.core import sharded as S
    from repro.core.dedup import FoldConfig as JFoldConfig
    from repro.core.dedup import bitmap_tau
    from repro.core.hnsw import HNSWState, sample_levels
    from repro.index import make_pipeline
    from repro.service import DedupService, ServiceConfig

    def mesh(n):
        return jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("data",))

    return dict(
        FoldConfig=JFoldConfig, bitmap_tau=bitmap_tau,
        sample_levels=sample_levels, DedupService=DedupService,
        ServiceConfig=ServiceConfig, dev={}, make_pipeline=make_pipeline,
        stacked=lambda states: {f: np.asarray(getattr(states, f))
                                for f in HNSWState._fields},
        init=lambda hcfg, n: S.sharded_init(hcfg, mesh(n)),
        step=lambda hcfg, n, **kw: jax.jit(
            S.make_sharded_dedup_step(hcfg, mesh(n), **kw)),
        search=lambda hcfg, n, **kw: jax.jit(
            S.make_sharded_search(hcfg, mesh(n), **kw)),
        levels=jnp.asarray)


# --------------------------------------------------------- the scenario
def _scenario(ns: dict, d: dict, work: str, tag: str,
              other_snap: str | None = None) -> tuple[dict, dict]:
    """Everything both packages must agree on. Returns (arrays, strings);
    snapshots go to <work>/snap_<tag>."""
    out, msgs = {}, {}
    cfg = ns["FoldConfig"](**FOLD)

    def mk(shards, c=cfg):
        return ns["make_pipeline"]("hnsw_sharded", cfg=c, shards=shards,
                                   **ns["dev"])

    def put(prefix, states):
        for f, a in ns["stacked"](states).items():
            out[f"{prefix}_{f}"] = np.asarray(a)

    def step(pipe, name, valid=None):
        res = pipe.dedup_step(pipe.signatures(*_pair(d, name)), valid=valid)
        out[f"{name}_keep"] = np.asarray(res.keep)
        out[f"{name}_keep_in"] = np.asarray(res.keep_in_batch)
        out[f"{name}_ids"] = np.asarray(res.ids)
        logs = pipe.backend.pop_slot_log()
        if logs:
            out[f"{name}_slots"] = np.concatenate(logs)
        put(name, pipe.backend.states)

    # the stream: ragged (padded) batches, one masked
    pipe = mk(SHARDS)
    be = pipe.backend
    be.track_slots = True
    for i in range(4):
        step(pipe, f"b{i}", d["valid"] if i == 2 else None)
    # merged search and the read-only query
    ids, sims = be.search(pipe.signatures(*_pair(d, "probe")))
    out["search_ids"], out["search_sims"] = np.asarray(ids), np.asarray(sims)
    q = pipe.query(*_pair(d, "probe"))
    out["query_is_dup"], out["query_ids"] = q.is_dup, q.ids
    out["query_sims"] = q.sims
    # delete by global id (routed id % nshards), idempotent; compact
    slots = np.concatenate([out[f"b{i}_slots"] for i in range(4)])
    kill = np.concatenate([slots[::3], [-5, 10**6, slots[0]]])
    out["n_del"] = np.int64(pipe.delete(kill))
    out["n_del_again"] = np.int64(pipe.delete(kill))
    out["dead_fraction"] = np.float64(pipe.dead_fraction)
    info = pipe.compact()
    out["reclaimed"], out["free"] = np.int64(info["reclaimed"]), \
        np.int64(info["free"])
    width = max(len(f) for f in be._free)
    free = np.full((SHARDS, width), -1, np.int64)
    for s, f in enumerate(be._free):
        free[s, :len(f)] = f
    out["free_lists"] = free
    put("compact", be.states)
    # free-slot reuse, then the capacity guard's refusal and grow()
    step(pipe, "b4")
    step(pipe, "b5")
    try:
        pipe.process_batch(*_pair(d, "big"))
        msgs["refuse"] = "no refusal"
    except RuntimeError as e:
        msgs["refuse"] = str(e)
    put("refused", be.states)
    pipe.grow(1024)
    out["grown_capacity"] = np.int64(pipe.capacity)
    put("grown", be.states)
    keep, _ = pipe.process_batch(*_pair(d, "big"))
    out["big_keep"] = keep
    out["big_slots"] = np.concatenate(be.pop_slot_log())
    put("big", be.states)
    msgs["stats"] = json.dumps(be.stats(), sort_keys=True)
    msgs["pipe_stats"] = json.dumps(pipe.stats_schema())
    # snapshots: own restore, the other package's, scale-out, scale-in
    snap = os.path.join(work, f"snap_{tag}")
    pipe.save(snap, step=1)
    again = mk(SHARDS)
    assert again.restore(snap) == 1
    put("restored", again.backend.states)
    step(again, "b6")
    if other_snap is not None:
        cross = mk(SHARDS)
        assert cross.restore(other_snap) == 1
        put("cross", cross.backend.states)
    wide = mk(2 * SHARDS)
    assert wide.restore(snap) == 1
    out["wide_inserted"] = np.int64(wide.inserted)
    put("wide", wide.backend.states)
    step(wide, "b7")
    try:
        mk(SHARDS // 2).restore(snap)
        msgs["scale_in"] = "no refusal"
    except ValueError as e:
        msgs["scale_in"] = str(e)
    # the core step: cross-shard ties in the merged search
    hcfg = cfg.hnsw()
    sig = pipe.signatures(*_pair(d, "tie"))
    states = ns["init"](hcfg, SHARDS)
    core = ns["step"](hcfg, SHARDS, tau=1.5, k=4)
    states, keep = core(states, sig.bitmaps, sig.pcs, ns["levels"](
        ns["sample_levels"](64, hcfg, seed=7)))
    out["tie_keep"] = np.asarray(keep)
    put("tie", states)
    qs = pipe.signatures(*_pair(d, "tieq"))
    ids, sims = ns["search"](hcfg, SHARDS, k=4)(states, qs.bitmaps, qs.pcs)
    out["tie_ids"], out["tie_sims"] = np.asarray(ids), np.asarray(sims)
    # the core step with sub_batches=2 and masked=False
    states = ns["init"](hcfg, SHARDS)
    core = ns["step"](hcfg, SHARDS, tau=ns["bitmap_tau"](cfg), k=4,
                      sub_batches=2)
    for i in range(2):
        s = pipe.signatures(*_pair(d, f"sub{i}"))
        states, keep = core(states, s.bitmaps, s.pcs, ns["levels"](
            ns["sample_levels"](64, hcfg, seed=i + 1)))
        out[f"sub{i}_keep"] = np.asarray(keep)
    put("sub", states)
    try:
        ns["step"](hcfg, SHARDS, tau=0.5, sub_batches=2, free_slots=True)
        msgs["sub_free"] = "no refusal"
    except ValueError as e:
        msgs["sub_free"] = str(e)
    # the service at shards=4
    svc = ns["DedupService"](ns["ServiceConfig"](
        fold=cfg, shards=SHARDS, max_batch=32, max_wait_ms=0.0,
        batch_buckets=(32,), stage_timer_every=0, **ns["dev"]))
    tickets = [svc.submit(*_pair(d, f"svc{i}"))
               for i in range(int(d["svc_chunks"]))]
    svc.flush()
    rows = [(v.doc_id, v.admitted, REASONS.index(v.reason), v.neighbor_id,
             int(np.float32(v.similarity).view(np.uint32)))
            for t in tickets for v in svc.results(t)]
    out["svc_verdicts"] = np.asarray(rows, np.int64)
    st = svc.stats()
    msgs["svc_counters"] = json.dumps(st["counters"], sort_keys=True)
    msgs["svc_index"] = json.dumps(
        {k: st["index"][k] for k in ("backend", "count", "capacity",
                                     "grow_events", "backend_stats")},
        sort_keys=True)
    put("svc", svc.pipeline.backend.states)
    return out, msgs


def _jax_main(work: str) -> None:
    """The subprocess's entry point: the JAX side of the scenario."""
    d = dict(np.load(os.path.join(work, "inputs.npz")))
    out, msgs = _scenario(_jax_ns(), d, work, "jax",
                          other_snap=os.path.join(work, "snap_port"))
    np.savez(os.path.join(work, "jax.npz"), **out)
    with open(os.path.join(work, "jax.json"), "w") as f:
        json.dump(msgs, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port arrays, port strings, JAX arrays, JAX strings, work dir)."""
    work = str(tmp_path_factory.mktemp("sharded_jax"))
    d = _data()
    np.savez(os.path.join(work, "inputs.npz"), **d)
    port, port_msgs = _scenario(_port_ns(), d, work, "port")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([SRC, HERE]))
    code = ("import sys, test_torch_sharded_jax as t; "
            "t._jax_main(sys.argv[1])")
    r = subprocess.run([sys.executable, "-c", code, work], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    jax = dict(np.load(os.path.join(work, "jax.npz")))
    with open(os.path.join(work, "jax.json")) as f:
        jax_msgs = json.load(f)
    return port, port_msgs, jax, jax_msgs, work, d


def _equal(port, jax, *prefixes):
    """Every array whose key starts with one of `prefixes` is present on
    both sides and bit-equal (f32 compared as its bits)."""
    keys = sorted(k for k in jax if k.startswith(prefixes))
    assert keys and keys == sorted(k for k in port if k.startswith(prefixes))
    for k in keys:
        a, b = np.asarray(port[k]), np.asarray(jax[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=k)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("batch", ["b0", "b1", "b2", "b3"])
def test_stream_keep_masks_and_states_match_jax(runs, batch):
    """Ragged (62, 61 rows: padded to a multiple of 4) and masked batches:
    keep, keep_in, the slot log and every per-shard state equal JAX's."""
    port, _, jax, _, _, d = runs
    _equal(port, jax, f"{batch}_")
    assert port[f"{batch}_keep"].shape == (len(d[f"{batch}_len"]),)
    # the fused step keeps its merged neighbors to itself, as in JAX
    assert port[f"{batch}_keep"].any() and (port[f"{batch}_ids"] == -1).all()


def test_stream_spreads_over_every_shard(runs):
    """Round-robin admission: each shard holds about a quarter."""
    port = runs[0]
    counts = port["b3_count"]
    assert counts.shape == (SHARDS,) and counts.min() > 0
    assert counts.sum() == sum(port[f"b{i}_keep"].sum() for i in range(4))


def test_merged_search_and_query_match_jax(runs):
    """The merged top-k: global interleaved ids (local * 4 + shard), sims
    and the query verdicts, equal to JAX's."""
    port, _, jax, _, _, _ = runs
    _equal(port, jax, "search_", "query_")
    ids = port["search_ids"]
    assert (ids >= 0).any() and ((ids % SHARDS) != 0).any()


def test_delete_compact_and_free_lists_match_jax(runs):
    """delete by global id (routed id % nshards; negative, out-of-range and
    repeated ids ignored; idempotent), compact's reclaimed count, the
    per-shard free lists and the compacted states."""
    port, _, jax, _, _, _ = runs
    _equal(port, jax, "n_del", "dead_fraction", "reclaimed", "free",
           "compact_")
    assert port["n_del"] > 0 and port["n_del_again"] == 0


@pytest.mark.parametrize("batch", ["b4", "b5"])
def test_free_slot_reuse_matches_jax(runs, batch):
    """After compact, each shard's reclaimed slots are consumed first:
    keep masks, slot logs and states equal JAX's."""
    port, _, jax, _, _, _ = runs
    _equal(port, jax, f"{batch}_")
    freed = {int(s) * SHARDS + sh for sh, row in
             enumerate(runs[0]["free_lists"]) for s in row if s >= 0}
    if batch == "b4":
        assert freed & set(port["b4_slots"].tolist())


def test_capacity_refusal_grow_and_landing_match_jax(runs):
    """A 512-doc batch at 128 slots per shard is refused with the
    reference's message and a grow() hint, mutating nothing; after
    grow(1024) it lands exactly as in JAX."""
    port, pm, jax, jm, _, _ = runs
    assert pm["refuse"] == jm["refuse"]
    assert "grow()" in pm["refuse"] and "sharded index full" in pm["refuse"]
    _equal(port, jax, "refused_", "grown", "big_")
    for f in ("vectors", "count", "neighbors"):
        np.testing.assert_array_equal(port[f"refused_{f}"],
                                      port[f"b5_{f}"])
    assert port["grown_capacity"] == 1024
    assert pm["stats"] == jm["stats"] and pm["pipe_stats"] == jm["pipe_stats"]


def test_snapshot_bytes_equal_and_cross_restore(runs):
    """The port's 4-shard snapshot is byte for byte JAX's (arrays and
    manifest); each package restores the other's into the states its own
    restore gives, and the restored index admits the next batch as JAX's
    does."""
    port, _, jax, _, work, _ = runs
    for name in ("arrays.msgpack", "MANIFEST.json"):
        with open(os.path.join(work, "snap_port", "step_00000001",
                               name), "rb") as f:
            got = f.read()
        with open(os.path.join(work, "snap_jax", "step_00000001",
                               name), "rb") as f:
            assert got == f.read(), name
    _equal(port, jax, "restored_", "b6_")
    # the port restores JAX's snapshot; JAX restored the port's
    from repro_torch.core.sharded import stack_states
    from repro_torch.index import make_pipeline
    pipe = make_pipeline("hnsw_sharded", FoldConfig(**FOLD), shards=SHARDS,
                         device="cpu")  # foldlint: disable=F131 (the port's factories add device)
    assert pipe.restore(os.path.join(work, "snap_jax")) == 1
    for f, a in stack_states(pipe.backend.states)._asdict().items():
        np.testing.assert_array_equal(a, jax[f"restored_{f}"], err_msg=f)
        np.testing.assert_array_equal(jax[f"cross_{f}"], a, err_msg=f)
    keep = pipe.dedup_step(pipe.signatures(*_pair(runs[5], "b6"))).keep
    np.testing.assert_array_equal(np.asarray(keep), jax["b6_keep"])


def test_scale_out_restore_and_scale_in_refusal_match_jax(runs):
    """4 -> 8 shards: the saved sub-graphs land on shards 0-3, shards 4-7
    start empty, and admission continues over all 8 as in JAX; 4 -> 2 is
    refused with the reference's message."""
    port, pm, jax, jm, _, _ = runs
    _equal(port, jax, "wide_", "b7_")
    assert port["wide_count"][SHARDS:].sum() == 0
    np.testing.assert_array_equal(port["wide_count"][:SHARDS],
                                  port["big_count"])
    assert port["b7_count"][SHARDS:].sum() > 0
    assert pm["scale_in"] == jm["scale_in"]
    assert "cannot be merged" in pm["scale_in"]


def test_core_step_cross_shard_ties_match_jax(runs):
    """Each doc twice in a row (rows 2i, 2i+1 on different shards): the
    merged top-k breaks the 1.0 ties as lax.top_k does, lower shard
    first."""
    port, _, jax, _, _, _ = runs
    _equal(port, jax, "tie_")
    ids, sims = port["tie_ids"], port["tie_sims"]
    assert (sims[:, 0] == 1.0).all() and (sims[:, 1] == 1.0).all()
    assert ((ids[:, 0] % SHARDS) < (ids[:, 1] % SHARDS)).all()


def test_core_step_sub_batches_unmasked_match_jax(runs):
    """sub_batches=2 with masked=False (the two-output step) gives JAX's
    keep masks and states; free_slots with sub_batches > 1 is refused with
    the reference's message."""
    port, pm, jax, jm, _, _ = runs
    _equal(port, jax, "sub0_", "sub1_", "sub_")
    assert pm["sub_free"] == jm["sub_free"]
    assert "incompatible" in pm["sub_free"]


def test_service_at_four_shards_matches_jax(runs):
    """DedupService(ServiceConfig(shards=4)) on ragged requests: verdicts
    (similarity bits included), counters, index stats and states."""
    port, pm, jax, jm, _, _ = runs
    _equal(port, jax, "svc_")
    assert pm["svc_counters"] == jm["svc_counters"]
    assert pm["svc_index"] == jm["svc_index"]
    assert json.loads(pm["svc_index"])["backend"] == "hnsw_sharded"
