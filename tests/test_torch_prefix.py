"""The prefix-filter baseline of the PyTorch port held against the JAX
package: the INDEX_FIRST step's keep, keep_in_batch, ids and sims over a
stream with shingles >= 2**31, all-padding rows and a half-repeated
batch; `in_batch_keep` at the float64 boundary (a Jaccard exactly tau);
no MinHash on the pipeline; snapshots byte-identical in both
directions."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dedup import FoldConfig as JaxFoldConfig
from repro.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro.index import make_pipeline as jax_make_pipeline
from repro.index.backends.prefix import PrefixFilterBackend as JaxPrefix
from repro.index.protocol import SigBatch as JaxSigBatch
from repro_torch.core.dedup import FoldConfig
from repro_torch.index import INDEX_FIRST, SigBatch
from repro_torch.index import make_pipeline as _make_pipeline
from repro_torch.index.backends.prefix import PrefixFilterBackend
from repro_torch.kernels import ops

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)

CFG = dict(capacity=1024, tau=0.7)
PAD = 0xFFFFFFFF


def make_pipeline(key, cfg):
    return _make_pipeline(key, cfg, device="cpu")


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _stream(n_batches, size=48, seed=0):
    """Common Crawl preset batches with every 12th doc emptied (an
    all-padding shingle row) and every 12th from the 6th cut to 1-6 tokens;
    with two or more batches, one more re-sends half of the first two."""
    src = SyntheticCorpus(dataclasses.replace(DATASET_PRESETS["common_crawl"],
                                              seed=seed))
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        tok, ln = src.next_batch(size)[:2]
        ln = ln.copy()
        ln[::12] = 0
        ln[6::12] = rng.integers(1, 7, len(ln[6::12]))
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


def _pair(**over):
    cfg = {**CFG, **over}
    jp = jax_make_pipeline("prefix_filter", JaxFoldConfig(**cfg))
    tp = make_pipeline("prefix_filter", FoldConfig(**cfg))
    return cfg, jp, tp


def _same_step(jp, tp, batch, tag):
    jq, tq = jp.query(*batch), tp.query(*batch)
    np.testing.assert_array_equal(tq.ids, np.asarray(jq.ids), err_msg=tag)
    np.testing.assert_array_equal(_bits(tq.sims), _bits(jq.sims), err_msg=tag)
    jres = jp.dedup_step(jp.signatures(*batch))
    tres = tp.dedup_step(tp.signatures(*batch))
    for field in ("keep", "keep_in_batch", "ids"):
        np.testing.assert_array_equal(getattr(tres, field),
                                      np.asarray(getattr(jres, field)),
                                      err_msg=f"{tag}: {field}")
    np.testing.assert_array_equal(_bits(tres.sims), _bits(jres.sims),
                                  err_msg=tag)
    assert tp.backend.stats() == jp.backend.stats()
    return tres


def _same_index(jb, tb):
    assert tb.sets == jb.sets and tb.prefixes == jb.prefixes
    assert tb.freq == jb.freq and tb.inverted == jb.inverted


def test_prefix_filter_stream_matches_jax(monkeypatch):
    """INDEX_FIRST admission through the backend's in_batch_keep, with no
    MinHash anywhere on the port's pipeline."""
    def no_minhash(*a, **k):
        raise AssertionError("prefix_filter's pipeline ran MinHash")
    monkeypatch.setattr(ops, "minhash", no_minhash)
    _, jp, tp = _pair()
    assert tp.backend.order == INDEX_FIRST and tp._seeds is None
    batches = _stream(3)
    sig = tp.signatures(*batches[0])
    assert sig.sigs is None and sig.bitmaps is None
    assert (sig.shingles == -1).all(1).any()           # all-padding rows
    results = [_same_step(jp, tp, b, f"batch {i}")
               for i, b in enumerate(batches)]
    assert results[0].keep.sum() > 0 and results[-1].keep.sum() < 48
    # index duplicates never count as in-batch duplicates (INDEX_FIRST)
    assert (~results[-1].keep & results[-1].keep_in_batch).any()
    _same_index(jp.backend, tp.backend)
    assert max(max(s) for s in tp.backend.sets if s) >= 2**31
    nxt = _stream(1, seed=3)[0]
    jkeep, jstats = jp.process_batch(*nxt)
    keep, stats = tp.process_batch(*nxt)
    np.testing.assert_array_equal(keep, np.asarray(jkeep))
    for k, v in jstats.items():
        if not k.startswith("t_"):
            assert stats[k] == v, k


@pytest.mark.parametrize("tau", [0.7, 0.6])
def test_in_batch_keep_at_the_float64_boundary(tau):
    """Pairs whose set-Jaccard is exactly tau (7/10 and 14/20 at tau 0.7,
    12/20 at tau 0.6) and below it: in_batch_keep compares the float64 value with tau, search
    stores it into f32 sims; both packages agree on the batch, on
    batch_sim, and on a later search of the same sets against the index.
    Shingle values sit above 2**31 and rows are padded with 0xFFFFFFFF."""
    hi = 0x80000000
    sets = [list(range(hi, hi + 10)),            # A
            list(range(hi, hi + 7)),             # J(A, .) = 7/10
            list(range(hi, hi + 6)) + [hi + 50],  # 6/11 with A
            list(range(hi + 100, hi + 120)),     # C
            list(range(hi + 100, hi + 114)),     # 14/20 with C
            list(range(hi + 100, hi + 112)),     # 12/20 with C
            []]                                  # all padding
    sh = np.full((len(sets), 24), PAD, np.uint32)
    for i, s in enumerate(sets):
        sh[i, :len(s)] = s
    jbe = JaxPrefix(JaxFoldConfig(tau=tau, capacity=64))
    tbe = PrefixFilterBackend(FoldConfig(tau=tau, capacity=64), device="cpu")
    jsig = JaxSigBatch(shingles=jnp.asarray(sh))
    tsig = SigBatch(shingles=torch.from_numpy(sh.view(np.int32).copy()))
    for rnd in range(2):
        jids, jsims = jbe.search(jsig)
        tids, tsims = tbe.search(tsig)
        np.testing.assert_array_equal(tids, np.asarray(jids))
        np.testing.assert_array_equal(_bits(tsims), _bits(jsims))
        np.testing.assert_array_equal(_bits(tbe.batch_sim(tsig)),
                                      _bits(jbe.batch_sim(jsig)))
        eligible = np.ones(len(sets), bool)
        jk, jh = jbe.in_batch_keep(jsig, eligible)
        tk, th = tbe.in_batch_keep(tsig, eligible)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(th, jh)
        if rnd == 0:
            # exactly tau is a hit; 12/20 reaches only tau 0.6; 6/11 none
            assert th[1] and th[4] and not th[2]
            assert th[5] == (tau == 0.6)
            jbe.insert(jsig, jk)
            tbe.insert(tsig, tk)
    assert tbe.sets == jbe.sets and tbe.prefixes == jbe.prefixes


def test_prefix_snapshots_byte_identical_both_ways(tmp_path):
    cfg, jp, tp = _pair()
    for i, b in enumerate(_stream(2)):
        _same_step(jp, tp, b, f"batch {i}")
    jp.save(str(tmp_path / "jax"), 5)
    tp.save(str(tmp_path / "port"), 5)
    for name in ("arrays.msgpack", "MANIFEST.json"):
        assert ((tmp_path / "jax" / "step_00000005" / name).read_bytes()
                == (tmp_path / "port" / "step_00000005" / name).read_bytes())
    t2 = make_pipeline("prefix_filter", FoldConfig(**cfg))
    j2 = jax_make_pipeline("prefix_filter", JaxFoldConfig(**cfg))
    assert t2.restore(str(tmp_path / "jax")) == 5
    assert j2.restore(str(tmp_path / "port")) == 5
    _same_index(jp.backend, t2.backend)
    _same_index(tp.backend, j2.backend)
    nxt = _stream(1, seed=4)[0]
    jkeep = np.asarray(jp.process_batch(*nxt)[0])
    for pipe in (t2, j2, tp):
        np.testing.assert_array_equal(np.asarray(pipe.process_batch(*nxt)[0]),
                                      jkeep)
