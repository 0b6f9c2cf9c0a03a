"""The exact reference of the PyTorch port held against the JAX package:
the `brute` backend (keep masks, neighbor ids and sims over a multi-batch
stream with deletes and free-row reuse, and its tie order across store
chunks) and `core/oracle.py`'s offline labeler."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import oracle as joracle
from repro.core.dedup import FoldConfig as JaxFoldConfig
from repro.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro.index import make_pipeline as jax_make_pipeline
from repro.index.backends import brute as jbrute
from repro_torch.core import oracle as toracle
from repro_torch.core.dedup import FoldConfig
from repro_torch.index import make_pipeline
from repro_torch.index.backends import brute as tbrute

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)

CFG = dict(capacity=256, tau=0.7, threshold_space="minhash")


def _batch(n, seed, dataset="common_crawl"):
    src = SyntheticCorpus(dataclasses.replace(DATASET_PRESETS[dataset],
                                              seed=seed))
    return src.next_batch(n)[:2]


def _pair(**over):
    cfg = {**CFG, **over}
    jp = jax_make_pipeline("brute", JaxFoldConfig(use_kernel=False, **cfg))
    tp = make_pipeline("brute", FoldConfig(**cfg), device="cpu")  # foldlint: disable=F131
    jp.backend.track_slots = tp.backend.track_slots = True
    return jp, tp


def _same_step(jp, tp, batch, tag):
    """One batch through both: identical keep masks, stats, slot logs, and
    (before it) identical read-only search results."""
    jq, tq = jp.query(*batch), tp.query(*batch)
    np.testing.assert_array_equal(tq.ids, np.asarray(jq.ids), err_msg=tag)
    np.testing.assert_array_equal(tq.sims.view(np.uint32),
                                  np.asarray(jq.sims).view(np.uint32),
                                  err_msg=tag)
    np.testing.assert_array_equal(tq.is_dup, np.asarray(jq.is_dup))
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
    return keep, (np.concatenate(tslots) if tslots else np.empty(0, np.int32))


def test_brute_matches_jax_with_deletes_and_reuse():
    jp, tp = _pair()
    b0, b1, b2 = _batch(64, 0), _batch(64, 1), _batch(64, 2)
    _, s0 = _same_step(jp, tp, b0, "b0")
    _, s1 = _same_step(jp, tp, b1, "b1")
    kill = np.concatenate([s0[::3], s1[1::4]])
    assert tp.delete(kill) == jp.delete(kill) == len(kill)
    assert tp.delete(kill) == 0                         # idempotent
    assert tp.inserted == jp.inserted
    assert tp.backend.stats() == jp.backend.stats()
    keep, s = _same_step(jp, tp, b0, "replay")          # killed docs readmit
    assert keep.any() and set(s.tolist()) <= set(kill.tolist())
    _same_step(jp, tp, b2, "b2")
    assert tp.backend.stats() == jp.backend.stats()
    np.testing.assert_array_equal(
        tp.backend.store[:tp.backend.n].numpy().view(np.uint32),
        jp.backend.store[:jp.backend.n])


def test_brute_tie_order_across_chunks(monkeypatch):
    """Sims are multiples of 1/H, so a query's best sim is often reached
    by several rows, inside one store chunk and across chunks (here:
    chunks of 16 rows). The store holds variants of 4 base signatures
    with 50, 60 or 70 of 112 lanes changed; each base queried scores ties
    at its best count. Both packages report the same row: the first
    maximum within a chunk (jnp.argmax), the earlier chunk across chunks
    (strict `best > sims`); the same after deletes free some of them."""
    import jax.numpy as jnp
    from repro.index.protocol import SigBatch as JaxSigBatch
    from repro_torch.index.protocol import SigBatch
    monkeypatch.setattr(jbrute, "_CHUNK", 16)
    monkeypatch.setattr(tbrute, "_CHUNK", 16)
    rng = np.random.default_rng(3)
    H = 112
    base = rng.integers(0, 2**32, (4, H), dtype=np.uint64).astype(np.uint32)
    rows = np.repeat(base, 18, axis=0)
    for r in range(len(rows)):
        lanes = rng.permutation(H)[:rng.choice([50, 60, 70])]
        rows[r, lanes] ^= np.uint32(0x5A5A5A5A)
    jbe = jbrute.BruteForceBackend(JaxFoldConfig(use_kernel=False, **CFG))
    tbe = tbrute.BruteForceBackend(FoldConfig(**CFG), device="cpu")
    keep = np.ones(len(rows), bool)
    jbe.insert(JaxSigBatch(sigs=jnp.asarray(rows)), keep)
    tbe.insert(SigBatch(sigs=torch.from_numpy(rows.view(np.int32).copy())),
               torch.from_numpy(keep))
    q = SigBatch(sigs=torch.from_numpy(base.view(np.int32).copy()))
    for tag in ("full", "after delete"):
        jids, jsims = jbe.search(JaxSigBatch(sigs=jnp.asarray(base)))
        tids, tsims = tbe.search(q)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids),
                                      err_msg=tag)
        np.testing.assert_array_equal(tsims.numpy(), np.asarray(jsims),
                                      err_msg=tag)
        eq = (rows[None, :, :] == base[:, None, :]).sum(-1)
        eq[:, tbe._free_mask[:len(rows)]] = -1
        best = eq.max(1, keepdims=True)
        chunks = [{j // 16 for j in np.flatnonzero(r)} for r in eq == best]
        assert max(len(c) for c in chunks) > 1, tag      # ties across chunks
        assert ((eq == best).sum(1) > 1).all(), tag      # and within
        kill = tids.numpy()[:, 0]
        assert tbe.delete(kill) == jbe.delete(kill) == 4


def test_brute_batch_sim_and_overflow():
    jp, tp = _pair(capacity=48)
    b = _batch(64, 3, dataset="lm1b")
    sig_t = tp.signatures(*b)
    assert sig_t.bitmaps is None and sig_t.pcs is None
    np.testing.assert_array_equal(
        tp.backend.batch_sim(sig_t).numpy(),
        np.asarray(jp.backend.batch_sim(jp.signatures(*b))))
    with pytest.raises(RuntimeError, match="grow"):
        tp.process_batch(*b)
    assert tp.inserted == 0
    tp.grow(128)
    assert tp.capacity == 128 and int(tp.process_batch(*b)[0].sum()) > 0


@pytest.mark.parametrize("tau", [0.5, 0.7, 0.9])
def test_oracle_matches_jax_package(tau):
    rng = np.random.default_rng(int(tau * 10))
    sigs = rng.integers(0, 2**32, (60, 112), dtype=np.uint64).astype(np.uint32)
    for i in range(5, 60):
        if rng.random() < 0.5:
            sigs[i] = sigs[rng.integers(0, i)]
            lanes = rng.choice(112, rng.integers(0, 60), replace=False)
            sigs[i, lanes] = rng.integers(0, 2**32, len(lanes), dtype=np.uint64)
    jsim = joracle.exact_jaccard_matrix(sigs)
    for arg in (sigs, sigs.view(np.int32)):
        tsim = toracle.exact_jaccard_matrix(arg)
        assert tsim.dtype == np.float32
        np.testing.assert_array_equal(tsim.view(np.uint32), jsim.view(np.uint32))
    jmask, jdup = joracle.online_admission(jsim, tau)
    tmask, tdup = toracle.online_admission(tsim, tau)
    np.testing.assert_array_equal(tmask, jmask)
    np.testing.assert_array_equal(tdup, jdup)
    assert 0 < tmask.sum() < 60
    a, b = {1, 2, 3}, {2, 3, 4}
    assert toracle.true_set_jaccard(a, b) == joracle.true_set_jaccard(a, b)
    assert toracle.true_set_jaccard(set(), set()) == 1.0


def test_brute_agrees_with_the_oracle():
    """brute's verdicts on one batch are the oracle's online admission
    over the batch's exact MinHash-Jaccard matrix."""
    tp = make_pipeline("brute", FoldConfig(**CFG), device="cpu")  # foldlint: disable=F131
    b = _batch(64, 4)
    keep, _ = tp.process_batch(*b)
    sigs = tp.signatures(*b).sigs.numpy()
    mask, _ = toracle.online_admission(toracle.exact_jaccard_matrix(sigs), 0.7)
    np.testing.assert_array_equal(keep, mask)
