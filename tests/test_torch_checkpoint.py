"""The PyTorch port's checkpoints and exact-duplicate filter held against
the JAX package: the hand-written msgpack subset encodes as
`msgpack.packb` does; snapshots of `hnsw` (with verify_minhash) and
`brute`, each with tombstones or free slots, are byte-identical between
the packages and cross in both directions with the same next verdicts;
content hashes and the `exact_%08d.npz` sidecar are shared."""
import dataclasses

import msgpack
import numpy as np
import pytest
import torch

from repro.core.dedup import FoldConfig as JaxFoldConfig
from repro.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro.index import exact as jexact
from repro.index import make_pipeline as jax_make_pipeline
from repro.train import checkpoint as jckpt
from repro_torch.core.dedup import FoldConfig
from repro_torch.core.hnsw import state_to_numpy
from repro_torch.index import exact as texact
from repro_torch.index import make_pipeline
from repro_torch.train import checkpoint as tckpt

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)

CFG = dict(capacity=256, M=8, M0=16, ef_construction=32, ef_search=32,
           tau=0.7, threshold_space="minhash")


def _batch(n, seed, dataset="common_crawl"):
    src = SyntheticCorpus(dataclasses.replace(DATASET_PRESETS[dataset],
                                              seed=seed))
    return src.next_batch(n)[:2]


def _norm(x):
    if isinstance(x, memoryview):
        return bytes(x)
    if isinstance(x, list):
        return [_norm(y) for y in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("obj", [
    [{"dtype": "uint32", "shape": [3, 4], "data": b"x" * 48}],
    [{"dtype": "int64", "shape": [], "data": bytes(8)}] * 17,
    [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
     -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1],
    ["", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "a" * 70000],
    [b"", b"b" * 255, b"b" * 256, b"b" * 65535, b"b" * 65536],
    {f"k{i}": i for i in range(20)},
    list(range(70000)),
], ids=["leaf", "array16", "ints", "strs", "bins", "map16", "array32"])
def test_msgpack_subset_matches_msgpack(obj):
    packed = msgpack.packb(obj)
    assert tckpt.packb(obj) == packed
    assert _norm(tckpt.unpackb(packed)) == msgpack.unpackb(packed)


def _grown_pair(key, **over):
    """The same stream through both packages: two batches, deletes, and
    for hnsw a compaction (free slots) and more deletes (tombstones)."""
    cfg = {**CFG, **over}
    jp = jax_make_pipeline(key, JaxFoldConfig(use_kernel=False, **cfg))
    tp = make_pipeline(key, FoldConfig(**cfg), device="cpu")
    jp.backend.track_slots = tp.backend.track_slots = True
    for s in range(2):
        b = _batch(64, s)
        np.testing.assert_array_equal(tp.process_batch(*b)[0],
                                      np.asarray(jp.process_batch(*b)[0]))
    slots = np.concatenate(jp.backend.pop_slot_log())
    tp.backend.pop_slot_log()
    assert tp.delete(slots[::3]) == jp.delete(slots[::3]) > 0
    if key == "hnsw":
        assert tp.compact()["free"] == jp.compact()["free"] > 0
        assert tp.delete(slots[1::5]) == jp.delete(slots[1::5]) > 0
    return cfg, jp, tp


CASES = [("hnsw", {"verify_minhash": True}), ("hnsw", {}), ("brute", {})]


@pytest.mark.parametrize("key,over", CASES, ids=["hnsw-verify", "hnsw", "brute"])
def test_snapshots_are_byte_identical_and_cross_both_ways(key, over, tmp_path):
    cfg, jp, tp = _grown_pair(key, **over)
    jp.save(str(tmp_path / "jax"), 3)
    tp.save(str(tmp_path / "port"), 3)
    for name in ("arrays.msgpack", "MANIFEST.json"):
        assert ((tmp_path / "jax" / "step_00000003" / name).read_bytes()
                == (tmp_path / "port" / "step_00000003" / name).read_bytes())
    nxt = _batch(64, 9)

    def stats(pipe):         # cumulative `deleted` restarts at a restore
        return {k: v for k, v in pipe.backend.stats().items()
                if k != "deleted"}

    # JAX -> port: the restored port pipeline continues as the JAX donor
    t2 = make_pipeline(key, FoldConfig(**cfg), device="cpu")
    assert t2.restore(str(tmp_path / "jax")) == 3
    assert stats(t2) == stats(jp)
    # port -> JAX: the restored JAX pipeline answers as the port donor.
    # (The JAX backend restores its exact-verify sig store read-only, so
    # its next insert fails; the read-only query is compared there.)
    j2 = jax_make_pipeline(key, JaxFoldConfig(use_kernel=False, **cfg))
    assert j2.restore(str(tmp_path / "port")) == 3
    assert stats(j2) == stats(tp)
    jq, tq2, jq2 = jp.query(*nxt), t2.query(*nxt), j2.query(*nxt)
    for q in (tq2, jq2):
        np.testing.assert_array_equal(np.asarray(q.ids), np.asarray(jq.ids))
        np.testing.assert_array_equal(np.asarray(q.sims), np.asarray(jq.sims))
    jkeep = np.asarray(jp.process_batch(*nxt)[0])
    np.testing.assert_array_equal(t2.process_batch(*nxt)[0], jkeep)
    np.testing.assert_array_equal(tp.process_batch(*nxt)[0], jkeep)
    if not over.get("verify_minhash"):
        np.testing.assert_array_equal(np.asarray(j2.process_batch(*nxt)[0]),
                                      jkeep)
    if key == "hnsw":
        got = state_to_numpy(t2.backend.state)
        for field, exp in jp.backend.state._asdict().items():
            np.testing.assert_array_equal(got[field], np.asarray(exp),
                                          err_msg=field)


def test_restore_into_larger_capacity_and_missing_dir(tmp_path):
    cfg, jp, _ = _grown_pair("hnsw", verify_minhash=True)
    jp.save(str(tmp_path), 4)
    big_cfg = FoldConfig(**{**cfg, "capacity": 1024})
    big = make_pipeline("hnsw", big_cfg, device="cpu")  # foldlint: disable=F131
    assert big.restore(str(tmp_path)) == 4
    assert big.capacity == 1024 and big.backend._sig_store.shape[0] == 1024
    assert big.inserted == jp.inserted
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        big.restore(str(tmp_path / "nothing_here"))


def test_checkpoint_module_matches_reference(tmp_path):
    """The module API on a plain tree: the same files as the reference's
    save, async saves committed by wait_pending, step listing, manifests
    with extras, and restore into a template's structure."""
    tree = {"b": np.arange(6, dtype=np.uint32).reshape(2, 3),
            "a": (np.int64(7), np.zeros((0, 4), np.float32)),
            "c": np.array(True)}
    jckpt.save(str(tmp_path / "j"), 1, tree, extra={"capacity": 9})
    tckpt.save(str(tmp_path / "t"), 1, tree, extra={"capacity": 9})
    for name in ("arrays.msgpack", "MANIFEST.json"):
        assert ((tmp_path / "j" / "step_00000001" / name).read_bytes()
                == (tmp_path / "t" / "step_00000001" / name).read_bytes())
    tckpt.save_async(str(tmp_path / "t"), 5, tree)
    tckpt.wait_pending()
    assert tckpt.list_steps(str(tmp_path / "t")) == [1, 5]
    assert tckpt.latest_step(str(tmp_path / "t")) == 5
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    assert tckpt.manifest(str(tmp_path / "t"), 1) == {"step": 1, "n_arrays": 4,
                                                      "capacity": 9}
    got = tckpt.restore(str(tmp_path / "j"), 1,
                        {"a": (0, 0), "b": 0, "c": 0})
    assert got["a"][0].dtype == np.int64 and got["a"][0].shape == ()
    assert got["a"][1].shape == (0, 4) and got["c"].dtype == np.bool_
    np.testing.assert_array_equal(got["b"], tree["b"])
    got["b"][0, 0] = 5                                  # writable copies
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.restore(str(tmp_path / "j"), 1, {"a": 0})


def test_content_hashes_and_sidecar_are_shared(tmp_path):
    tokens, lengths = _batch(16, 2)
    assert texact.batch_hashes(tokens, lengths) == jexact.batch_hashes(
        tokens, lengths)
    assert texact.batch_hashes(tokens) == jexact.batch_hashes(tokens)
    t_tok = torch.from_numpy(tokens.view(np.int32).copy())
    assert texact.batch_hashes(t_tok, torch.from_numpy(lengths)) == \
        jexact.batch_hashes(tokens, lengths)
    assert texact.doc_hash([1, 2, 3], 2) == jexact.doc_hash([1, 2, 3], 2)
    tf, jf = texact.ExactDupFilter(), jexact.ExactDupFilter()
    for i, h in enumerate(texact.batch_hashes(tokens, lengths)):
        assert tf.add(h, i if i % 2 else -1) == jf.add(h, i if i % 2 else -1)
    assert tf.discard_refs([1, 3, 99]) == jf.discard_refs([1, 3, 99]) == 2
    tf.save(str(tmp_path), 7)
    back = jexact.ExactDupFilter()
    assert back.load(str(tmp_path), 7)
    assert back._by_hash == jf._by_hash and back._refs == jf._refs
    jf.save(str(tmp_path), 8)
    again = texact.ExactDupFilter()
    assert again.load(str(tmp_path), 8) and not again.load(str(tmp_path), 9)
    assert len(again) == 0
    again.load(str(tmp_path), 8)
    assert again._by_hash == tf._by_hash and again._refs == tf._refs
    tf.prune_sidecars(str(tmp_path), [8])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["exact_00000008.npz"]
