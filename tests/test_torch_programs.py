"""The port's program analysis held against the JAX package's:

  * the port registers the reference's 11 program specs, by name;
  * each spec's interface (the port's checked-in golden, which
    tests/test_torch_analysis.py holds equal to a fresh run) equals the
    reference's traced interface under the fixed mapping: uint32 <-> int32
    bit patterns, and the sharded step's (S, ...) stacked state <-> the
    port's list of S per-shard states;
  * each spec's argument and output bytes equal the reference's goldens
    (tools/foldprog/fingerprints);
  * `abstract_state` is the reference's state geometry, allocating nothing;
  * `program_cache_sizes()` moves as the reference's jit caches do under
    the same bucketed service drive, a replay adds nothing, and the
    service reports it.

The reference's interface comes from `jax.make_jaxpr` of each spec's maker
(`repro.analysis.analyze._trace`); its analyzer is not used here.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import default_specs as jax_default_specs
from repro.analysis.analyze import _aval_str, _trace
from repro.core import hnsw as J
from repro.core.dedup import FoldConfig as JaxFoldConfig
from repro.service import DedupService as JaxDedupService
from repro.service import ServiceConfig as JaxServiceConfig
from repro_torch.analysis import default_specs
from repro_torch.analysis import gate
from repro_torch.core import hnsw as T
from repro_torch.core.dedup import FoldConfig
from repro_torch.core.sharded import make_sharded_dedup_step, sharded_init
from repro_torch.service import DedupService, ServiceConfig
from repro_torch.service.batcher import default_batch_buckets

ROOT = Path(__file__).resolve().parents[1]
JAX_GOLDENS = ROOT / "tools" / "foldprog" / "fingerprints"
NAMES = [s.name for s in default_specs()]
SHARDED = "hnsw_sharded/fused_step"


def test_spec_names_equal_the_references():
    assert NAMES == [s.name for s in jax_default_specs()]
    assert len(NAMES) == 11


@pytest.fixture(scope="module")
def jax_interfaces():
    """name -> (in avals, out avals) of the reference's traced program."""
    out = {}
    for spec in jax_default_specs():
        fn, args, kwargs = spec.make()
        closed = _trace(fn, args, kwargs)
        out[spec.name] = ([_aval_str(v.aval) for v in closed.jaxpr.invars],
                          [_aval_str(v.aval) for v in closed.jaxpr.outvars])
    return out


def _as_port(avals: list[str], stacked: int = 0) -> list[str]:
    """The reference's avals under the mapping: uint32 as int32 bits; the
    first `stacked` avals lose their leading shard dimension of 1."""
    out = []
    for i, a in enumerate(avals):
        dtype, dims = a[:-1].split("[")
        dtype = "int32" if dtype == "uint32" else dtype
        if i < stacked:
            assert dims.split(",")[0] == "1", a
            dims = ",".join(dims.split(",")[1:])
        out.append(f"{dtype}[{dims}]")
    return out


@pytest.mark.parametrize("name", NAMES)
def test_interface_equals_the_reference(jax_interfaces, name):
    ref_in, ref_out = jax_interfaces[name]
    leaves = len(T.HNSWState._fields) if name == SHARDED else 0
    golden = gate.load_golden(name)
    assert golden["in_avals"] == _as_port(ref_in, leaves)
    assert golden["out_avals"] == _as_port(ref_out, leaves)
    assert golden["interface64"] == [] and golden["f64"] == []


@pytest.mark.parametrize("name", NAMES)
def test_bytes_equal_the_reference_goldens(name):
    ref = json.loads((JAX_GOLDENS / (name.replace("/", "__") + ".json"))
                     .read_text())["memory"]
    port = gate.load_golden(name)["memory"]
    for key in ("argument_bytes", "output_bytes"):
        assert port[key] == ref[key], key
    assert port["temp_bytes"] is None      # written on the CPU


@pytest.mark.parametrize("metric", ["bitmap_jaccard", "minhash_jaccard"])
def test_abstract_state_is_the_references(metric):
    cfg = FoldConfig(capacity=8192).hnsw()
    if metric != "bitmap_jaccard":
        cfg = cfg._replace(metric=metric, words=FoldConfig().num_hashes)
    jcfg = JaxFoldConfig(capacity=8192).hnsw()._replace(
        metric=cfg.metric, words=cfg.words)
    got = T.abstract_state(cfg)
    assert all(t.device.type == "meta" for t in got)
    want = J.abstract_state(jcfg)
    assert [f"{str(t.dtype)[6:]}[{','.join(map(str, t.shape))}]"
            for t in got] == _as_port([_aval_str(a) for a in want])


def test_program_cache_counts_signatures_without_reading_data():
    cfg = FoldConfig(capacity=96, T=256, M=4, M0=8, ef_construction=8,
                     ef_search=8).hnsw()
    state = T.hnsw_init(cfg, "cpu")
    q = torch.zeros((3, cfg.words), dtype=torch.int32)
    T.hnsw_search.clear_cache()
    T.hnsw_search(cfg, state, q, k=2)
    T.hnsw_search(cfg, state, q + 1, k=2)          # same signature
    assert T.program_cache_sizes()["search"] == 1
    T.hnsw_search(cfg, state, q[:2], k=2)          # another shape
    T.hnsw_search(cfg, state, q, k=3)              # another static k
    T.hnsw_search(cfg, state, q, 2)                # positional, as jit keys
    assert T.program_cache_sizes()["search"] == 4
    T.hnsw_search.clear_cache()
    assert T.program_cache_sizes()["search"] == 0


def test_sharded_step_adds_no_entry_point_signature():
    """The reference's fused step is one shard_map program whose inner
    calls are traced: it moves none of the four jit caches. Neither does
    the port's."""
    fold = FoldConfig(capacity=96, T=256, M=4, M0=8, ef_construction=8,
                      ef_search=8)
    cfg = fold.hnsw()
    step = make_sharded_dedup_step(cfg, 2, tau=0.5)
    rng = np.random.default_rng(0)
    bm = torch.from_numpy(rng.integers(0, 2**31, (8, cfg.words),
                                       dtype=np.int64).astype(np.int32))
    pcs = T.popc(bm).sum(-1).to(torch.int32)
    before = T.program_cache_sizes()
    states, keep = step(sharded_init(cfg, 2, "cpu"), bm, pcs,
                        torch.zeros(8, dtype=torch.int32))
    assert int(states[0].count) + int(states[1].count) == int(keep.sum()) > 0
    assert T.program_cache_sizes() == before


def _drive(svc, buckets, rng):
    for b in buckets:
        docs = [rng.integers(0, 50_000, 24).astype(np.uint32)
                for _ in range(b)]
        svc.submit(docs)
        svc.flush()          # materialize at exactly this bucket shape


def test_service_program_cache_deltas_match_jax():
    """tests/test_foldprog.py's drive, on both packages: every bucketed
    batch shape adds one search and one insert signature in each, a
    replay adds none, and stats() reports the counters. Deletes of 3, 4
    and 5 ids then add one delete signature per power of two (4 and 8)
    in each, as the backend pads ids to the next power of two."""
    torch.set_num_threads(1)
    buckets = default_batch_buckets(16)
    svc_kw = dict(max_batch=16, len_buckets=(32,), max_len=32,
                  pipeline_depth=1, stage_timer_every=0)
    # an unusual capacity: these entries are this test's, whatever ran
    # earlier in the process
    fold = dict(capacity=2944, T=1024)
    deltas = {}
    for tag, svc, sizes in (
            ("jax", JaxDedupService(JaxServiceConfig(
                fold=JaxFoldConfig(**fold), **svc_kw)), J.program_cache_sizes),
            ("port", DedupService(ServiceConfig(
                fold=FoldConfig(**fold), device="cpu", **svc_kw)),  # foldlint: disable=F141 (the port's ServiceConfig adds device)
             T.program_cache_sizes)):
        assert svc.batcher.batch_buckets == buckets
        rng = np.random.default_rng(0)
        before = sizes()
        _drive(svc, buckets, rng)
        after = sizes()
        snap = svc.stats()["batching"]
        assert snap["compiled_programs"] == after, tag
        assert {s[0] for s in snap["compiled_shapes"]} == set(buckets), tag
        _drive(svc, buckets, rng)            # replay: every shape seen
        assert sizes() == after, tag
        backend, first = svc.pipeline.backend, 0
        for n in (3, 4, 5):
            assert backend.delete(np.arange(first, first + n)) == n, tag
            first += n
        after = sizes()
        assert snap["compiled_programs"]["delete"] + 2 == after["delete"], tag
        deltas[tag] = {k: after[k] - before[k] for k in after}
    assert deltas["port"] == deltas["jax"]
    assert deltas["port"]["search"] == deltas["port"]["insert"] == len(buckets)
    assert deltas["port"]["delete"] == 2
    assert deltas["port"]["compact"] == 0
