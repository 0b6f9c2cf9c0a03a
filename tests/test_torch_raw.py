"""The FAISS (Jaccard) / FAISS (Hamming) baseline of the PyTorch port held
against the JAX package: `_dist_rows` under both raw metrics at every
count, `hnsw_search` and `hnsw_insert_batch` over raw MinHash lanes, the
`hnsw_raw` backend's keep streams (batched, per-doc and heuristic
inserts), and its delete / compact / snapshot lifecycle with snapshot
bytes equal in both directions."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hnsw as J
from repro.core.dedup import FoldConfig as JaxFoldConfig
from repro.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro.index import make_pipeline as jax_make_pipeline
from repro_torch.core import hnsw as T
from repro_torch.core.dedup import FoldConfig
from repro_torch.index import make_pipeline

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)

METRICS = ["minhash_jaccard", "hamming"]
CFG = dict(capacity=512, M=8, M0=16, ef_construction=32, ef_search=32,
           tau=0.7)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


# ------------------------------------------------------------- distances
@pytest.mark.parametrize("w", [5, 112, 129])
def test_hamming_dist_rows_at_every_px(w):
    """dh / bits under jax.jit rounds as px * f32(1 / bits); the port
    matches at every px from 0 to 32 W."""
    cfg = J.HNSWConfig(capacity=8, words=w, metric="hamming")
    n = 32 * w + 1
    bits = np.arange(32 * w)[None, :] < np.arange(n)[:, None]   # (n, 32W)
    vecs = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
    q = np.zeros(w, np.uint32)
    pcs = np.zeros(n, np.int32)
    want = jax.jit(functools.partial(J._dist_rows, cfg))(
        jnp.asarray(q), jnp.int32(0), jnp.asarray(vecs), jnp.asarray(pcs))
    got = T._dist_rows(T.HNSWConfig(**cfg._asdict()), _t(q[None]),
                       torch.zeros(1, dtype=torch.int32), _t(vecs)[None],
                       torch.from_numpy(pcs)[None])[0]
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("h", [7, 31, 112, 128])
def test_minhash_dist_rows_at_every_count(h):
    """1 - mean(eq) under jax.jit rounds once, as fma(-count, f32(1/H), 1);
    the port matches at every count from 0 to H."""
    cfg = J.HNSWConfig(capacity=8, words=h, metric="minhash_jaccard")
    rng = np.random.default_rng(h)
    q = rng.integers(0, 2**32, h, dtype=np.uint64).astype(np.uint32)
    vecs = np.repeat(q[None], h + 1, axis=0)
    for c in range(h + 1):
        lanes = rng.permutation(h)[:h - c]     # c lanes stay equal
        vecs[c, lanes] = ~vecs[c, lanes]
    pcs = np.zeros(h + 1, np.int32)
    want = jax.jit(functools.partial(J._dist_rows, cfg))(
        jnp.asarray(q), jnp.int32(0), jnp.asarray(vecs), jnp.asarray(pcs))
    got = T._dist_rows(T.HNSWConfig(**cfg._asdict()), _t(q[None]),
                       torch.zeros(1, dtype=torch.int32), _t(vecs)[None],
                       torch.from_numpy(pcs)[None])[0]
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# ------------------------------------------------------- search + insert
def _raw_corpus(rng, n, h=112, dup_rate=0.5, max_edits=40):
    sigs = rng.integers(0, 2**32, (n, h), dtype=np.uint64).astype(np.uint32)
    for i in range(8, n):
        if rng.random() < dup_rate:
            sigs[i] = sigs[rng.integers(0, i)]
            lanes = rng.choice(h, rng.integers(0, max_edits), replace=False)
            sigs[i, lanes] = rng.integers(0, 2**32, len(lanes),
                                          dtype=np.uint64)
    return sigs


def _same_state(tst, jst, tag):
    got = T.state_to_numpy(tst)
    for field in J.HNSWState._fields:
        np.testing.assert_array_equal(got[field],
                                      np.asarray(getattr(jst, field)),
                                      err_msg=f"{tag}: {field}")


@pytest.mark.parametrize("metric", METRICS)
def test_raw_search_and_heuristic_insert_match_jax(metric):
    """Build an index over raw lanes in two batched inserts under the
    selection heuristic (its candidate-candidate distances in the raw
    metric; the plain insert runs in the backend tests below), the second
    seeded by its own search as the pipeline does, then search a regular
    batch and a tie batch of exact copies: identical states, ids and
    sims."""
    cfg = J.HNSWConfig(capacity=256, words=112, M=8, M0=16,
                       ef_construction=32, ef_search=32, max_level=3,
                       metric=metric, select_heuristic=True)
    tcfg = T.HNSWConfig(**cfg._asdict())
    rng = np.random.default_rng(len(metric))
    sigs = _raw_corpus(rng, 200)
    zeros = np.zeros(96, np.int32)
    jst, tst = J.hnsw_init(cfg), T.hnsw_init(tcfg, "cpu")
    for b, part in enumerate((sigs[:96], sigs[96:192])):
        levels = J.sample_levels(96, cfg, seed=b + 1)
        mask = rng.random(96) < 0.8
        jseed = tseed = None
        if b:
            jseed = J.hnsw_search(cfg, jst, jnp.asarray(part), k=4)[0]
            tseed = T.hnsw_search(tcfg, tst, _t(part), k=4)[0]
            np.testing.assert_array_equal(tseed.numpy(), np.asarray(jseed))
        jst, jn = J.hnsw_insert_batch(cfg, jst, jnp.asarray(part),
                                      jnp.asarray(zeros), jnp.asarray(levels),
                                      jnp.asarray(mask), seed_ids=jseed)
        tst, tn = T.hnsw_insert_batch(tcfg, tst, _t(part),
                                      torch.from_numpy(zeros),
                                      torch.from_numpy(levels),
                                      torch.from_numpy(mask), seed_ids=tseed)
        assert int(tn) == int(jn) == int(mask.sum())
        _same_state(tst, jst, f"insert {b}")
    ties = np.repeat(sigs[[0, 10, 20, 30]], 3, axis=0)
    for tag, q in (("regular", sigs[192:]), ("ties", ties)):
        jids, jsims = J.hnsw_search(cfg, jst, jnp.asarray(q), k=4)
        tids, tsims = T.hnsw_search(tcfg, tst, _t(q), k=4)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids),
                                      err_msg=tag)
        np.testing.assert_array_equal(_bits(tsims.numpy()), _bits(jsims),
                                      err_msg=tag)


# -------------------------------------------------------------- backend
def _batch(n, seed, dataset="common_crawl"):
    src = SyntheticCorpus(dataclasses.replace(DATASET_PRESETS[dataset],
                                              seed=seed))
    return src.next_batch(n)[:2]


def _pair(metric, **over):
    cfg = {**CFG, **over}
    jp = jax_make_pipeline("hnsw_raw", JaxFoldConfig(use_kernel=False, **cfg),
                           metric=metric)
    tp = make_pipeline("hnsw_raw", FoldConfig(**cfg), metric=metric,
                       device="cpu")  # foldlint: disable=F131
    jp.backend.track_slots = tp.backend.track_slots = True
    return cfg, jp, tp


def _same_step(jp, tp, batch, tag):
    """One batch through both: identical read-only search results first,
    then identical keep masks, stats, slot logs and index states."""
    jq, tq = jp.query(*batch), tp.query(*batch)
    np.testing.assert_array_equal(tq.ids, np.asarray(jq.ids), err_msg=tag)
    np.testing.assert_array_equal(_bits(tq.sims), _bits(jq.sims), err_msg=tag)
    jkeep, jstats = jp.process_batch(*batch)
    keep, stats = tp.process_batch(*batch)
    np.testing.assert_array_equal(keep, np.asarray(jkeep), err_msg=tag)
    for key, exp in jstats.items():
        if not key.startswith("t_"):
            assert stats[key] == exp, (tag, key)
    jslots, tslots = jp.backend.pop_slot_log(), tp.backend.pop_slot_log()
    assert len(jslots) == len(tslots)
    for a, b in zip(jslots, tslots):
        np.testing.assert_array_equal(b, a, err_msg=tag)
    _same_state(tp.backend.state, jp.backend.state, tag)
    return keep, (np.concatenate(tslots) if tslots else np.empty(0, np.int32))


@pytest.mark.parametrize("over", [{}, {"select_heuristic": True},
                                  {"batched_insert": False}],
                         ids=["batched", "heuristic", "per_doc"])
@pytest.mark.parametrize("metric", METRICS)
def test_hnsw_raw_keep_streams_match_jax(metric, over):
    """Four batches (the last a half-repeat of the first) through both
    packages: identical verdicts, search results and states, batch for
    batch. select_heuristic reaches neither package's raw index."""
    _, jp, tp = _pair(metric, **over)
    batches = [_batch(48, s) for s in range(3)]
    (t0, l0), (t1, l1) = batches[0], batches[1]
    width = max(t0.shape[1], t1.shape[1])
    pad = [np.pad(t, ((0, 0), (0, width - t.shape[1]))) for t in (t0, t1)]
    batches.append((np.concatenate([pad[0][:24], pad[1][24:]]),
                    np.concatenate([l0[:24], l1[24:]])))
    kept = [int(_same_step(jp, tp, b, f"batch {i}")[0].sum())
            for i, b in enumerate(batches)]
    assert kept[0] > 0 and kept[-1] < 48
    sig = tp.signatures(*batches[0])
    assert sig.bitmaps is None and sig.pcs is None
    np.testing.assert_array_equal(
        _bits(tp.backend.batch_sim(sig).numpy()),
        _bits(jp.backend.batch_sim(jp.signatures(*batches[0]))))


@pytest.mark.parametrize("metric", METRICS)
def test_hnsw_raw_lifecycle_and_snapshots_match_jax(metric, tmp_path):
    """Delete, compact (free slots), more deletes (tombstones), a batch
    into the freed slots; then save from both packages: byte-identical
    snapshots, and each package's snapshot restores into the other with
    the donor's state and next verdicts."""
    cfg, jp, tp = _pair(metric)
    _, s0 = _same_step(jp, tp, _batch(48, 0), "b0")
    _, s1 = _same_step(jp, tp, _batch(48, 1), "b1")
    assert tp.delete(s0[::3]) == jp.delete(s0[::3]) > 0
    tc, jc = tp.compact(), jp.compact()
    assert (tc["reclaimed"], tc["free"]) == (jc["reclaimed"], jc["free"])
    assert tp.delete(s1[1::4]) == jp.delete(s1[1::4]) > 0
    assert tp.backend.stats() == jp.backend.stats()
    _same_step(jp, tp, _batch(48, 0), "replay")
    jp.save(str(tmp_path / "jax"), 2)
    tp.save(str(tmp_path / "port"), 2)
    for name in ("arrays.msgpack", "MANIFEST.json"):
        assert ((tmp_path / "jax" / "step_00000002" / name).read_bytes()
                == (tmp_path / "port" / "step_00000002" / name).read_bytes())
    t2 = make_pipeline("hnsw_raw", FoldConfig(**cfg), metric=metric,
                       device="cpu")  # foldlint: disable=F131
    j2 = jax_make_pipeline("hnsw_raw", JaxFoldConfig(use_kernel=False, **cfg),
                           metric=metric)
    assert t2.restore(str(tmp_path / "jax")) == 2
    assert j2.restore(str(tmp_path / "port")) == 2
    _same_state(t2.backend.state, jp.backend.state, "jax -> port")
    _same_state(tp.backend.state, j2.backend.state, "port -> jax")
    nxt = _batch(48, 7)
    jkeep = np.asarray(jp.process_batch(*nxt)[0])
    for pipe in (t2, tp, j2):
        np.testing.assert_array_equal(np.asarray(pipe.process_batch(*nxt)[0]),
                                      jkeep)
