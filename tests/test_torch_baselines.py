"""`repro_torch.baselines` and the port's registry held against the JAX
package: the five constructors at the same arguments give the same
verdicts, `minhash_signatures` and `SignatureStage` the same lanes, the
registry serves every key of the reference (`hnsw_sharded` included), and
the port's service on the CPU gives the JAX service's verdicts for each
baseline key."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.baselines as jb
from repro.core.dedup import FoldConfig as JaxFoldConfig
from repro.core.hashing import hash_seeds as jax_hash_seeds
from repro.core.minhash import minhash_signatures as jax_minhash_signatures
from repro.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro.index import available as jax_available
from repro.service import DedupService as JaxDedupService
from repro.service import ServiceConfig as JaxServiceConfig
import repro_torch.baselines as tb
from repro_torch.core.dedup import FoldConfig
from repro_torch.core.hashing import hash_seeds
from repro_torch.core.minhash import minhash_signatures
from repro_torch.index import available, make
from repro_torch.service import DedupService, ServiceConfig

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)

SMALL_HNSW = dict(capacity=512, M=8, M0=16, ef_construction=32, ef_search=32)
CONSTRUCTORS = [
    ("BruteForcePipeline", dict(capacity=512)),
    ("DPKPipeline", dict(capacity=512)),
    ("DPKPipeline", dict(capacity=512, rebuild=False, tau=0.6)),
    ("FlatLSHPipeline", dict(capacity=512, topk=2)),
    ("PrefixFilterPipeline", dict(tau=0.8)),
    ("RawHNSWPipeline", dict(**SMALL_HNSW)),
    ("RawHNSWPipeline", dict(metric="hamming", k=2, **SMALL_HNSW)),
]


def _batches(n, size=48, seed=0):
    src = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    return [src.next_batch(size)[:2] for _ in range(n)]


@pytest.mark.parametrize("name,kw", CONSTRUCTORS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(CONSTRUCTORS)])
def test_baseline_constructors_match_jax(name, kw):
    jp = getattr(jb, name)(**kw)
    tp = getattr(tb, name)(**kw, device="cpu")
    assert tp.backend.name == jp.backend.name
    assert tp.backend.cfg == FoldConfig(**{
        f: getattr(jp.backend.cfg, f) for f in
        FoldConfig.__dataclass_fields__})
    for i, b in enumerate(_batches(3)):
        np.testing.assert_array_equal(tp.process_batch(*b)[0],
                                      np.asarray(jp.process_batch(*b)[0]),
                                      err_msg=f"batch {i}")


def test_minhash_signatures_and_signature_stage_match_jax():
    toks, lens = _batches(1, size=32)[0]
    lens = lens.copy()
    lens[:4] = [0, 1, 3, 5]
    for n in (1, 5):
        want = np.asarray(jax_minhash_signatures(
            jnp.asarray(toks), jnp.asarray(lens), jax_hash_seeds(112), n=n))
        got = minhash_signatures(
            torch.from_numpy(toks.view(np.int32)), torch.from_numpy(lens),
            hash_seeds(112, device="cpu"), n=n)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    for kw in ({}, {"num_hashes": 31, "shingle_n": 3, "seed": 9}):
        want = np.asarray(jb.SignatureStage(use_kernel=False, **kw)(toks, lens))
        got = tb.SignatureStage(device="cpu", **kw)(toks, lens)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_registry_serves_every_key_but_hnsw_sharded():
    """The name dates from before the sharded slice: the registry now
    serves every reference key, `hnsw_sharded` too."""
    assert available() == jax_available()
    be = make("hnsw_sharded", FoldConfig(), device="cpu")  # foldlint: disable=F131
    assert be.name == "hnsw_sharded" and be.nshards == 1
    if not torch.cuda.is_available():     # device=None means cuda
        for name in ("DPKPipeline", "PrefixFilterPipeline"):
            with pytest.raises(RuntimeError, match="no GPU"):
                getattr(tb, name)()


def _verdicts(vs):
    return [(v.doc_id, v.admitted, v.reason, v.neighbor_id,
             int(np.float32(v.similarity).view(np.uint32))) for v in vs]


@pytest.mark.parametrize("key,opts", [
    ("hnsw_raw", {"metric": "hamming"}), ("dpk", {}),
    ("flat_lsh", {"topk": 8}), ("prefix_filter", {})])
def test_service_serves_new_keys_with_jax_verdicts(key, opts):
    """The same ragged requests through both services at small micro-batch
    sizes: equal verdicts, counters and backend stats."""
    fold = dict(SMALL_HNSW, tau=0.7)
    svc = dict(backend=key, backend_opts=opts, max_batch=32,
               max_wait_ms=0.0)
    jsvc = JaxDedupService(JaxServiceConfig(fold=JaxFoldConfig(**fold), **svc))
    tsvc = DedupService(ServiceConfig(fold=FoldConfig(**fold), device="cpu",  # foldlint: disable=F141 (the port's ServiceConfig adds device)
                                      **svc))
    rng = np.random.default_rng(len(key))
    src = SyntheticCorpus(DATASET_PRESETS["common_crawl"])
    toks, lens, _ = src.next_batch(120)
    out = [[], []]
    start = 0
    while start < 120:
        n = int(rng.integers(1, 40))
        for i, s in enumerate((jsvc, tsvc)):
            out[i].append(s.submit(toks[start:start + n],
                                   lens[start:start + n]))
        start += n
    for s in (jsvc, tsvc):
        s.flush()
    got = [[v for t in ts for v in s.results(t)]
           for ts, s in zip(out, (jsvc, tsvc))]
    assert _verdicts(got[1]) == _verdicts(got[0])
    assert any(v.admitted for v in got[1]) and not all(
        v.admitted for v in got[1])
    js, ts = jsvc.stats(), tsvc.stats()
    assert ts["counters"] == js["counters"]
    assert ts["index"]["backend_stats"] == js["index"]["backend_stats"]
