"""The MinHash-LSH baselines of the PyTorch port held against the JAX
package: `pick_bands` and `band_keys` (lanes >= 2**31 given as the port's
int32 bits), the `dpk` (rebuild on and off) and `flat_lsh` (several topK
budgets) keep masks, neighbor ids and sims over a multi-batch stream,
flat_lsh's deletion with its free list, and snapshots byte-identical in
both directions, restored into a larger capacity too."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.baselines.base import band_keys as jax_band_keys
from repro.baselines.base import pick_bands as jax_pick_bands
from repro.core.dedup import FoldConfig as JaxFoldConfig
from repro.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro.index import make_pipeline as jax_make_pipeline
from repro_torch.baselines.base import band_keys, pick_bands
from repro_torch.core.dedup import FoldConfig
from repro_torch.index import make_pipeline as _make_pipeline

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)

CFG = dict(capacity=1024, tau=0.7)
CASES = [("dpk", {"rebuild": True}), ("dpk", {"rebuild": False}),
         ("flat_lsh", {"topk": 1}), ("flat_lsh", {"topk": 4}),
         ("flat_lsh", {"topk": 160})]
IDS = ["dpk-rebuild", "dpk-incremental", "flat-topk1", "flat-topk4",
       "flat-topk160"]


def make_pipeline(key, cfg, **opts):
    return _make_pipeline(key, cfg, device="cpu", **opts)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def test_pick_bands_matches_jax_over_the_grid():
    for h in range(8, 257):
        for tau in np.linspace(0.3, 0.95, 14):
            assert pick_bands(h, float(tau)) == jax_pick_bands(h, float(tau))
    assert pick_bands(112, 0.7) == (14, 8)


def test_band_keys_bit_exact_on_high_lanes():
    """Half the lanes are >= 2**31: as the port's int32 bits they must fold
    to the reference's keys (no sign extension), as must uint32."""
    rng = np.random.default_rng(0)
    sigs = rng.integers(0, 2**32, (64, 112), dtype=np.uint64).astype(np.uint32)
    sigs[:, ::2] |= np.uint32(0x80000000)
    want = jax_band_keys(sigs, 14, 8)
    assert want.dtype == np.uint64
    for arg in (sigs, sigs.view(np.int32)):
        np.testing.assert_array_equal(band_keys(arg, 14, 8), want)


def _stream(n_batches, size=64, seed=0):
    """Common Crawl preset batches; in each, every 8th doc is cut to 1-4
    tokens (a handful of shingles: MinHash lanes >= 2**31 reach the
    store); with two or more batches, one more re-sends half of the
    first two."""
    src = SyntheticCorpus(dataclasses.replace(DATASET_PRESETS["common_crawl"],
                                              seed=seed))
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        tok, ln = src.next_batch(size)[:2]
        ln = ln.copy()
        ln[::8] = rng.integers(1, 5, len(ln[::8]))
        out.append((tok, ln))
    if n_batches < 2:
        return out
    (t0, l0), (t1, l1) = out[0], out[1]
    width = max(t0.shape[1], t1.shape[1])
    pad = [np.pad(t, ((0, 0), (0, width - t.shape[1]))) for t in (t0, t1)]
    h = size // 2
    out.append((np.concatenate([pad[0][:h], pad[1][h:]]),
                np.concatenate([l0[:h], l1[h:]])))
    return out


def _pair(key, opts, **over):
    cfg = {**CFG, **over}
    jp = jax_make_pipeline(key, JaxFoldConfig(use_kernel=False, **cfg), **opts)
    tp = make_pipeline(key, FoldConfig(**cfg), **opts)
    jp.backend.track_slots = tp.backend.track_slots = True
    return cfg, jp, tp


def _same_step(jp, tp, batch, tag):
    """One batch through both: identical read-only search results, then
    identical keep masks, step-② survivors, ids, sims, stats and slot
    logs."""
    jq, tq = jp.query(*batch), tp.query(*batch)
    np.testing.assert_array_equal(tq.ids, np.asarray(jq.ids), err_msg=tag)
    np.testing.assert_array_equal(_bits(tq.sims), _bits(jq.sims), err_msg=tag)
    jsig, tsig = jp.signatures(*batch), tp.signatures(*batch)
    jres, tres = jp.dedup_step(jsig), tp.dedup_step(tsig)
    for field in ("keep", "keep_in_batch", "ids"):
        np.testing.assert_array_equal(getattr(tres, field),
                                      np.asarray(getattr(jres, field)),
                                      err_msg=f"{tag}: {field}")
    np.testing.assert_array_equal(_bits(tres.sims), _bits(jres.sims),
                                  err_msg=tag)
    assert isinstance(tres.keep, np.ndarray)        # host-side results
    jslots, tslots = jp.backend.pop_slot_log(), tp.backend.pop_slot_log()
    assert len(jslots) == len(tslots)
    for a, b in zip(jslots, tslots):
        np.testing.assert_array_equal(b, a, err_msg=tag)
    assert tp.backend.stats() == jp.backend.stats()
    return tres.keep, (np.concatenate(tslots) if tslots
                       else np.empty(0, np.int32))


def _same_index(jp, tp):
    jb, tb = jp.backend, tp.backend
    np.testing.assert_array_equal(tb.store, jb.store)
    np.testing.assert_array_equal(tb.keys, jb.keys)
    assert tb.n == jb.n and tb.buckets == jb.buckets


@pytest.mark.parametrize("key,opts", CASES, ids=IDS)
def test_lsh_streams_match_jax(key, opts):
    _, jp, tp = _pair(key, opts)
    batches = _stream(3)
    kept = [int(_same_step(jp, tp, b, f"batch {i}")[0].sum())
            for i, b in enumerate(batches)]
    assert kept[0] > 0 and kept[-1] < 64
    _same_index(jp, tp)
    assert (tp.backend.store[:tp.backend.n] >= 2**31).any()
    # the blocking composition gives the same verdicts and accounting
    nxt = _stream(1, seed=5)[0]
    jkeep, jstats = jp.process_batch(*nxt)
    keep, stats = tp.process_batch(*nxt)
    np.testing.assert_array_equal(keep, np.asarray(jkeep))
    for k, v in jstats.items():
        if not k.startswith("t_"):
            assert stats[k] == v, k


def test_flat_lsh_delete_then_reinsert_matches_jax():
    """Deleted rows leave their buckets and join a sorted free list;
    a replay readmits exactly the killed docs into the freed rows."""
    _, jp, tp = _pair("flat_lsh", {"topk": 4})
    b0, b1, b2 = _stream(2)
    _, s0 = _same_step(jp, tp, b0, "b0")
    _, s1 = _same_step(jp, tp, b1, "b1")
    kill = np.concatenate([s1[::2], s0[1::3], [-1, 10**6]])
    assert tp.delete(kill) == jp.delete(kill) > 0
    assert tp.delete(kill) == 0
    assert tp.backend._free == jp.backend._free
    assert tp.backend._free == sorted(tp.backend._free)
    _same_index(jp, tp)
    assert tp.inserted == jp.inserted
    keep, slots = _same_step(jp, tp, b0, "replay")
    assert keep.any() and set(slots.tolist()) <= set(kill.tolist())
    assert tp.backend._free == jp.backend._free
    _same_step(jp, tp, b2, "b2")
    _same_index(jp, tp)
    np.testing.assert_array_equal(tp.backend._free_mask, jp.backend._free_mask)


@pytest.mark.parametrize("key,opts", [CASES[0], CASES[3]],
                         ids=["dpk", "flat_lsh"])
def test_lsh_snapshots_byte_identical_both_ways(key, opts, tmp_path):
    cfg, jp, tp = _pair(key, opts)
    for i, b in enumerate(_stream(2)):
        _same_step(jp, tp, b, f"batch {i}")
    if key == "flat_lsh":
        kill = np.arange(0, tp.backend.n, 5)
        assert tp.delete(kill) == jp.delete(kill) > 0
    jp.save(str(tmp_path / "jax"), 4)
    tp.save(str(tmp_path / "port"), 4)
    for name in ("arrays.msgpack", "MANIFEST.json"):
        assert ((tmp_path / "jax" / "step_00000004" / name).read_bytes()
                == (tmp_path / "port" / "step_00000004" / name).read_bytes())
    nxt = _stream(1, seed=6)[0]
    # JAX -> port into a larger configured capacity, port -> JAX as is
    big = {**cfg, "capacity": 4096}
    t2 = make_pipeline(key, FoldConfig(**big), **opts)
    j2 = jax_make_pipeline(key, JaxFoldConfig(use_kernel=False, **cfg),
                           **opts)
    assert t2.restore(str(tmp_path / "jax")) == 4
    assert j2.restore(str(tmp_path / "port")) == 4
    assert t2.capacity == 4096 and j2.capacity == 1024
    assert t2.backend.keys.dtype == np.uint64
    for restored, donor in ((t2, jp), (j2, tp)):
        assert restored.inserted == donor.inserted
        np.testing.assert_array_equal(restored.backend.store[:1024],
                                      donor.backend.store)
        if key == "flat_lsh":   # dpk re-buckets at its next search
            assert ({k: v for k, v in restored.backend.buckets.items() if v}
                    == {k: v for k, v in donor.backend.buckets.items() if v})
    jkeep = np.asarray(jp.process_batch(*nxt)[0])
    for pipe in (t2, j2, tp):
        np.testing.assert_array_equal(np.asarray(pipe.process_batch(*nxt)[0]),
                                      jkeep)
