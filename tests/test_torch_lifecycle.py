"""Deletion, compaction and the retention policy of the PyTorch port held
against the JAX package: `hnsw_delete` then `hnsw_compact` (with and
without the selection heuristic) then an insert into the freed slots give
identical states, and `LifecycleManager`'s TTL and max_live_docs ledgers
delete the same slots batch for batch."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import hnsw as J
from repro.core.bitmap import pack_bitmaps, popcount
from repro.core.dedup import FoldConfig as JaxFoldConfig
from repro.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro.index import make_pipeline as jax_make_pipeline
from repro.lifecycle import LifecycleManager as JaxLifecycleManager
from repro_torch.core import hnsw as T
from repro_torch.core.dedup import FoldConfig
from repro_torch.index import make_pipeline
from repro_torch.lifecycle import LifecycleManager

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)


def _vectors(n, seed=0, H=112):
    rng = np.random.default_rng(seed)
    sigs = rng.integers(0, 2**32, (n, H), dtype=np.uint64).astype(np.uint32)
    for i in range(4, n):
        if rng.random() < 0.4:
            sigs[i] = sigs[rng.integers(0, i)]
            lanes = rng.choice(H, rng.integers(0, 8), replace=False)
            sigs[i, lanes] = rng.integers(0, 2**32, len(lanes), dtype=np.uint64)
    vecs = np.asarray(pack_bitmaps(jnp.asarray(sigs), T=1024))
    return vecs, np.asarray(popcount(jnp.asarray(vecs)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _assert_equal_states(tst, jst, tag=""):
    got = T.state_to_numpy(tst)
    for field in J.HNSWState._fields:
        np.testing.assert_array_equal(got[field], np.asarray(getattr(jst, field)),
                                      err_msg=f"{tag} {field}")


@pytest.mark.parametrize("heuristic", [False, True])
def test_delete_compact_then_reuse_matches_jax(heuristic):
    cfg = J.HNSWConfig(capacity=192, words=32, M=8, M0=16, ef_construction=32,
                       ef_search=32, max_level=3, select_heuristic=heuristic)
    tcfg = T.HNSWConfig(**cfg._asdict())
    vecs, pcs = _vectors(190)
    levels = J.sample_levels(190, cfg, seed=2)
    jst, _ = J.hnsw_insert_batch(cfg, J.hnsw_init(cfg), jnp.asarray(vecs[:150]),
                                 jnp.asarray(pcs[:150]),
                                 jnp.asarray(levels[:150]), jnp.ones(150, bool))
    tst = T.state_from_numpy({k: np.array(v) for k, v in jst._asdict().items()},
                             "cpu")
    # tombstone a third of the nodes, the entry point and the tail slot;
    # repeats, -1 and out-of-range ids are ignored
    kill = np.concatenate([np.arange(0, 150, 3), [int(jst.entry), 149, -1,
                                                  500, 3]]).astype(np.int32)
    jst, jn = J.hnsw_delete(cfg, jst, jnp.asarray(kill))
    tst, tn = T.hnsw_delete(tcfg, tst, torch.from_numpy(kill))
    assert int(tn) == int(jn)
    _assert_equal_states(tst, jst, "delete")
    # a search masks the tombstones
    jids, _ = J.hnsw_search(cfg, jst, jnp.asarray(vecs[:40]), k=4)
    tids, _ = T.hnsw_search(tcfg, tst, _t(vecs[:40]), k=4)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    jst, jr = J.hnsw_compact(cfg, jst)
    tst, tr = T.hnsw_compact(tcfg, tst)
    assert int(tr) == int(jr) > 0
    _assert_equal_states(tst, jst, "compact")
    # insert into the reclaimed slots first, then fresh ones
    node_level = np.asarray(jst.node_level)
    free = np.flatnonzero(node_level[:int(jst.count)] < 0).astype(np.int32)
    free_slots = np.full(40, -1, np.int32)
    free_slots[:min(40, len(free))] = free[:40]
    mask = np.ones(40, bool)
    mask[::5] = False
    jst, _ = J.hnsw_insert_batch(cfg, jst, jnp.asarray(vecs[150:]),
                                 jnp.asarray(pcs[150:]),
                                 jnp.asarray(levels[150:]), jnp.asarray(mask),
                                 free_slots=jnp.asarray(free_slots))
    tst, _ = T.hnsw_insert_batch(tcfg, tst, _t(vecs[150:]),
                                 torch.from_numpy(pcs[150:].copy()),
                                 torch.from_numpy(levels[150:]),
                                 torch.from_numpy(mask),
                                 free_slots=torch.from_numpy(free_slots))
    _assert_equal_states(tst, jst, "reuse")
    assert (np.asarray(jst.node_level)[free[:32]] >= 0).all()


def test_compact_of_a_fully_tombstoned_index_matches_jax():
    cfg = J.HNSWConfig(capacity=64, words=32, M=8, M0=16, ef_construction=16,
                       ef_search=16, max_level=3)
    tcfg = T.HNSWConfig(**cfg._asdict())
    vecs, pcs = _vectors(40, seed=3)
    jst, _ = J.hnsw_insert_batch(cfg, J.hnsw_init(cfg), jnp.asarray(vecs),
                                 jnp.asarray(pcs),
                                 jnp.asarray(J.sample_levels(40, cfg)),
                                 jnp.ones(40, bool))
    tst = T.state_from_numpy({k: np.array(v) for k, v in jst._asdict().items()},
                             "cpu")
    every = np.arange(40, dtype=np.int32)
    jst, _ = J.hnsw_delete(cfg, jst, jnp.asarray(every))
    tst, _ = T.hnsw_delete(tcfg, tst, torch.from_numpy(every))
    tids, tsims = T.hnsw_search(tcfg, tst, _t(vecs[:8]), k=4)
    assert (tids.numpy() == -1).all() and np.isneginf(tsims.numpy()).all()
    jst, _ = J.hnsw_compact(cfg, jst)
    tst, _ = T.hnsw_compact(tcfg, tst)
    _assert_equal_states(tst, jst)
    assert int(tst.entry) == -1 and int(tst.count) == 0


CFG = dict(capacity=256, M=8, M0=16, ef_construction=32, ef_search=32,
           tau=0.7, threshold_space="minhash")


def _batch(n, seed):
    src = SyntheticCorpus(dataclasses.replace(DATASET_PRESETS["lm1b"],
                                              seed=seed))
    return src.next_batch(n)[:2]


@pytest.mark.parametrize("key,policy", [
    ("hnsw", dict(ttl_steps=2, compact_watermark=0.1)),
    ("hnsw", dict(max_live_docs=70, compact_watermark=2.0)),
    ("brute", dict(ttl_steps=1, max_live_docs=50)),
])
def test_lifecycle_manager_ledgers_match_jax(key, policy):
    """TTL expiry, live-set eviction and watermark compaction delete the
    same slots and leave the same index as the JAX manager, batch for
    batch."""
    jp = jax_make_pipeline(key, JaxFoldConfig(use_kernel=False, **CFG))
    tp = make_pipeline(key, FoldConfig(**CFG), device="cpu")
    jlm = JaxLifecycleManager(jp, **policy)
    tlm = LifecycleManager(tp, **policy)
    assert tp.backend.track_slots
    for step in range(5):
        b = _batch(40, step % 3)
        jkeep, _ = jp.process_batch(*b)
        keep, _ = tp.process_batch(*b)
        np.testing.assert_array_equal(keep, np.asarray(jkeep), err_msg=str(step))
        assert tlm.after_batch() == jlm.after_batch(), step
        for name, exp in jlm.stats().items():
            if not name.startswith("t_"):
                assert tlm.stats()[name] == exp, (step, name)
        assert [(s, list(x)) for s, x in tlm._ledger] == \
            [(s, list(x)) for s, x in jlm._ledger]
        assert tp.inserted == jp.inserted and tp.deleted == jp.deleted
        if key == "hnsw":
            _assert_equal_states(tp.backend.state, jp.backend.state, str(step))
    assert tlm.n_expired + tlm.n_evicted > 0


def test_lifecycle_manager_needs_a_deletion_backend():
    pipe = make_pipeline("hnsw", FoldConfig(**CFG), device="cpu")  # foldlint: disable=F131
    pipe.backend.supports_deletion = False
    with pytest.raises(ValueError, match="supports_deletion=False"):
        LifecycleManager(pipe, ttl_steps=1)
