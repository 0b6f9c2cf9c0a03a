"""The PyTorch port's data pipeline held against the JAX package, case for
case with tests/test_ingest.py: the synthetic corpora give the same
arrays, the hash tokenizer the same ids, the packer the same training
batches, and `DedupIngest` (direct, and backed by a `DedupService`) admits
the same rows with the same stats counts."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.dedup import FoldConfig as JaxFoldConfig
from repro.data import DATASET_PRESETS as JAX_PRESETS
from repro.data import DedupIngest as JaxDedupIngest
from repro.data import HashWordTokenizer as JaxHashWordTokenizer
from repro.data import PackedBatches as JaxPackedBatches
from repro.data import SyntheticCorpus as JaxSyntheticCorpus
from repro.service import DedupService as JaxDedupService
from repro.service import ServiceConfig as JaxServiceConfig
from repro_torch.core.dedup import FoldConfig
from repro_torch.data import (DATASET_PRESETS, DedupIngest, HashWordTokenizer,
                              PackedBatches, SyntheticCorpus)
from repro_torch.service import DedupService, ServiceConfig

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)

FC = dict(capacity=2048, ef_construction=32, ef_search=32,
          threshold_space="minhash")


@pytest.mark.parametrize("name", ["common_crawl", "c4"])
def test_corpus_matches_jax(name):
    """Same preset, same batches (tokens, lengths, planted dup sources),
    twice over (determinism), with the reference's statistics."""
    cfg = DATASET_PRESETS[name]
    got = SyntheticCorpus(cfg).next_batch(512)
    again = SyntheticCorpus(cfg).next_batch(512)
    want = JaxSyntheticCorpus(JAX_PRESETS[name]).next_batch(512)
    for g, a, w in zip(got, again, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(a, w)
        assert g.dtype == w.dtype
    tokens, lengths, dup_of = got
    assert tokens.dtype == np.uint32 and lengths.min() >= cfg.min_len
    assert (dup_of < np.arange(512))[dup_of >= 0].all()
    if name == "common_crawl":
        assert 0.25 < (dup_of >= 0).mean() < 0.55


def test_tokenizer_matches_jax():
    tok, jtok = HashWordTokenizer(vocab_size=1000), JaxHashWordTokenizer(
        vocab_size=1000)
    for text in ("the quick brown fox", "THE QUICK brown fox", "", "a  b\tc"):
        np.testing.assert_array_equal(tok.encode(text), jtok.encode(text))
        assert tok.encode(text).dtype == np.uint32
    t1 = tok.encode("the quick brown fox")
    assert np.array_equal(t1, tok.encode("THE QUICK brown fox"))
    assert (t1 < 1000).all() and len(t1) == 4
    texts = ["a b c", "d", "", "one two three four five"]
    for g, w in zip(tok.encode_batch(texts), jtok.encode_batch(texts)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    toks, lens = tok.encode_batch(["a b c", "d"])
    assert toks.shape == (2, 3) and list(lens) == [3, 1]
    assert HashWordTokenizer(lowercase=False).encode("A")[0] == \
        JaxHashWordTokenizer(lowercase=False).encode("A")[0]


@pytest.mark.parametrize("seq_len,batch", [(32, 2), (16, 3)])
def test_packing_matches_jax(seq_len, batch):
    """pop_batch and flush_batch give the same (tokens, loss_mask) as the
    reference over ragged admitted docs; masked positions are content or
    EOS, padding is unmasked."""
    rng = np.random.default_rng(seq_len)
    pk, jpk = (PackedBatches(batch=batch, seq_len=seq_len, eos_id=1),
               JaxPackedBatches(batch=batch, seq_len=seq_len, eos_id=1))
    outs = []
    for _ in range(4):
        lens = rng.integers(1, 24, 6).astype(np.int32)
        docs = np.full((6, 24), 7, np.int32)
        pk.add_docs(docs, lens)
        jpk.add_docs(docs, lens)
        outs.append((pk.pop_batch(), jpk.pop_batch()))
    outs.append((pk.flush_batch(), jpk.flush_batch()))
    assert any(g is not None for g, _ in outs)
    for g, w in outs:
        assert (g is None) == (w is None)
        if g is None:
            continue
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        tokens, mask = g
        assert tokens.shape == mask.shape == (batch, seq_len)
        assert (tokens[mask == 0] == 0).all()
        assert set(np.unique(tokens[mask == 1])) <= {1, 7}


@pytest.mark.parametrize("mode", ["direct", "service"])
def test_dedup_ingest_matches_jax(mode):
    """Both ingest modes admit the same rows as the reference's, batch for
    batch; totals line up with the index count and some dups drop."""
    src = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    jsrc = JaxSyntheticCorpus(JAX_PRESETS["common_crawl"])
    if mode == "direct":
        ing = DedupIngest(src, FoldConfig(**FC), device="cpu")
        jing = JaxDedupIngest(jsrc, JaxFoldConfig(**FC))
        n = 128
    else:
        svc = dict(max_batch=64, max_wait_ms=0.0, batch_buckets=(64,))
        ing = DedupIngest(src, service=DedupService(ServiceConfig(
            fold=FoldConfig(**FC), device="cpu", **svc)))  # foldlint: disable=F141 (the port's ServiceConfig adds device)
        jing = JaxDedupIngest(jsrc, service=JaxDedupService(JaxServiceConfig(
            fold=JaxFoldConfig(**FC), **svc)))
        n = 100
    for _ in range(3):
        got, want = ing.next_clean_batch(n), jing.next_clean_batch(n)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        toks, lens, stats = got
        assert toks.shape[0] == lens.shape[0] == stats["n_insert"] == \
            want[2]["n_insert"]
        if mode == "service":
            assert stats["service"] == want[2]["service"]
    assert (ing.total_in, ing.total_admitted) == (jing.total_in,
                                                  jing.total_admitted)
    assert ing.total_admitted == ing.pipe.inserted < ing.total_in
    if mode == "service":
        assert ing.service.stats()["counters"]["docs_out"] == 3 * n


def test_dedup_ingest_runs_on_cuda_unless_asked():
    """Direct mode builds its pipeline on cuda by default: with no card
    that raises instead of running on the CPU."""
    src = SyntheticCorpus(dataclasses.replace(DATASET_PRESETS["lm1b"],
                                              seed=1))
    if torch.cuda.is_available():
        assert DedupIngest(src, FoldConfig(**FC)).pipe.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="found no GPU"):
            DedupIngest(src, FoldConfig(**FC))
    assert DedupIngest(src, FoldConfig(**FC),
                       device="cpu").pipe.device.type == "cpu"
