"""HNSW search and batched insert of the PyTorch port held against the JAX
package: an index built by JAX is carried across with state_from_numpy,
and the port must return identical (ids, sims) and build identical
graphs, including on a duplicate-dense batch that forces distance ties."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import hnsw as J
from repro.core.bitmap import pack_bitmaps, popcount
from repro_torch.core import hnsw as T

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)

CFG = J.HNSWConfig(capacity=512, words=32, M=8, M0=16, ef_construction=32,
                   ef_search=32, max_level=3)
N_BUILD = 160


def _corpus(rng, n, H=112, dup_rate=0.4, max_edits=6):
    sigs = rng.integers(0, 2**32, (n, H), dtype=np.uint64).astype(np.uint32)
    for i in range(10, n):
        if rng.random() < dup_rate:
            sigs[i] = sigs[rng.integers(0, i)]
            lanes = rng.choice(H, rng.integers(0, max_edits), replace=False)
            sigs[i, lanes] = rng.integers(0, 2**32, len(lanes), dtype=np.uint64)
    return sigs


@pytest.fixture(scope="module")
def built():
    """A JAX-built index plus queries: a regular batch and a tie batch of
    exact copies of indexed rows (many bitmap distances of exactly 0)."""
    rng = np.random.default_rng(11)
    sigs = _corpus(rng, N_BUILD + 48)
    vecs = np.array(pack_bitmaps(jnp.asarray(sigs), T=1024))
    pcs = np.array(popcount(jnp.asarray(vecs)))
    # plant exact duplicate groups inside the index: ties among neighbors
    for g in range(8):
        vecs[20 * g + 1:20 * g + 5] = vecs[20 * g]
        pcs[20 * g + 1:20 * g + 5] = pcs[20 * g]
    state, _ = J.hnsw_insert_batch(
        CFG, J.hnsw_init(CFG), jnp.asarray(vecs[:N_BUILD]),
        jnp.asarray(pcs[:N_BUILD]),
        jnp.asarray(J.sample_levels(N_BUILD, CFG)), jnp.ones(N_BUILD, bool))
    snap = {k: np.array(v) for k, v in state._asdict().items()}
    ties = np.repeat(vecs[[0, 20, 40, 60]], 4, axis=0)
    return dict(state=snap, vecs=vecs, pcs=pcs,
                queries={"regular": vecs[N_BUILD:], "ties": ties})


def _jstate(snap):
    return J.HNSWState(**{k: jnp.asarray(v) for k, v in snap.items()})


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


@pytest.mark.parametrize("batch", ["regular", "ties"])
@pytest.mark.parametrize("query_chunk", [0, 8])
@pytest.mark.parametrize("frontier", [1, 4])
@pytest.mark.parametrize("packed", [True, False])
def test_search_matches_jax(built, batch, query_chunk, frontier, packed):
    cfg = CFG._replace(frontier=frontier, packed_visited=packed)
    q = built["queries"][batch]
    jids, jsims = J.hnsw_search(cfg, _jstate(built["state"]), jnp.asarray(q),
                                k=4, query_chunk=query_chunk)
    tids, tsims = T.hnsw_search(T.HNSWConfig(**cfg._asdict()),
                                T.state_from_numpy(built["state"], "cpu"),
                                _t(q), k=4, query_chunk=query_chunk)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tsims.numpy(), np.asarray(jsims))
    if batch == "ties":
        assert (tsims.numpy()[:, :2] == 1.0).all()   # exact copies found


def test_search_on_empty_index():
    cfg = CFG
    q = np.random.default_rng(0).integers(0, 2**32, (5, 32), dtype=np.uint64
                                          ).astype(np.uint32)
    jids, jsims = J.hnsw_search(cfg, J.hnsw_init(cfg), jnp.asarray(q), k=4)
    tids, tsims = T.hnsw_search(T.HNSWConfig(**cfg._asdict()),
                                T.hnsw_init(T.HNSWConfig(**cfg._asdict()), "cpu"),
                                _t(q), k=4)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tsims.numpy(), np.asarray(jsims))


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("free", [False, True])
def test_insert_batch_matches_jax(built, seeded, free):
    """The same batch into the same state: identical graphs. `free` hands
    in slots above the high-water mark that no graph node reaches — the
    properties of reclaimed slots — so they are consumed first."""
    rng = np.random.default_rng(int(seeded) * 2 + int(free))
    vecs = built["vecs"][N_BUILD:]
    pcs = built["pcs"][N_BUILD:]
    B = len(vecs)
    levels = J.sample_levels(B, CFG, seed=7)
    mask = rng.random(B) < 0.75
    mask[-4:] = True
    seeds = free_slots = None
    if seeded:
        seeds = np.array(J.hnsw_search(CFG, _jstate(built["state"]),
                                       jnp.asarray(vecs), k=4)[0])
    if free:
        free_slots = np.full(B, -1, np.int32)
        free_slots[:5] = [500, 490, 480, 470, 460]
    jst, jn = J.hnsw_insert_batch(
        CFG, _jstate(built["state"]), jnp.asarray(vecs), jnp.asarray(pcs),
        jnp.asarray(levels), jnp.asarray(mask),
        seed_ids=None if seeds is None else jnp.asarray(seeds),
        free_slots=None if free_slots is None else jnp.asarray(free_slots))
    tst, tn = T.hnsw_insert_batch(
        T.HNSWConfig(**CFG._asdict()), T.state_from_numpy(built["state"], "cpu"),
        _t(vecs), torch.from_numpy(pcs.copy()), torch.from_numpy(levels),
        torch.from_numpy(mask),
        seed_ids=None if seeds is None else torch.from_numpy(seeds),
        free_slots=None if free_slots is None else torch.from_numpy(free_slots))
    assert int(tn) == int(jn) == int(mask.sum())
    got = T.state_to_numpy(tst)
    for field in J.HNSWState._fields:
        np.testing.assert_array_equal(got[field], np.asarray(getattr(jst, field)),
                                      err_msg=field)


def test_insert_into_empty_index_and_grow_match_jax():
    rng = np.random.default_rng(4)
    sigs = _corpus(rng, 40)
    vecs = np.asarray(pack_bitmaps(jnp.asarray(sigs), T=1024))
    pcs = np.asarray(popcount(jnp.asarray(vecs)))
    levels = J.sample_levels(40, CFG, seed=3)
    jst, _ = J.hnsw_insert_batch(CFG, J.hnsw_init(CFG), jnp.asarray(vecs),
                                 jnp.asarray(pcs), jnp.asarray(levels),
                                 jnp.ones(40, bool))
    tcfg = T.HNSWConfig(**CFG._asdict())
    tst, _ = T.hnsw_insert_batch(tcfg, T.hnsw_init(tcfg, "cpu"), _t(vecs),
                                 torch.from_numpy(pcs.copy()),
                                 torch.from_numpy(levels), torch.ones(40, dtype=torch.bool))
    jcfg2, jst2 = J.hnsw_grow(CFG, jst, 1024)
    tcfg2, tst2 = T.hnsw_grow(tcfg, tst, 1024)
    assert tcfg2.capacity == jcfg2.capacity == 1024
    got = T.state_to_numpy(tst2)
    for field in J.HNSWState._fields:
        np.testing.assert_array_equal(got[field], np.asarray(getattr(jst2, field)),
                                      err_msg=field)


def test_helpers_match_jax():
    for cap, packed in [(1000, True), (1 << 20, True), (1 << 20, False)]:
        jc = CFG._replace(capacity=cap, packed_visited=packed)
        tc = T.HNSWConfig(**jc._asdict())
        assert T.auto_query_chunk(tc) == J.auto_query_chunk(jc)
        assert T.visited_nbytes(tc) == J.visited_nbytes(jc)
    np.testing.assert_array_equal(T.sample_levels(1000, T.HNSWConfig(**CFG._asdict()), 9),
                                  J.sample_levels(1000, CFG, 9))


def test_unported_paths_raise_by_name(built):
    """The per-doc path (`_insert_one`) and the selection heuristic, once
    refused by name, now build the JAX package's graph into a JAX-built
    index; so do the `hnsw_raw` metrics (tests/test_torch_raw.py), and a
    metric neither package knows is refused by name, as the reference's
    `_dist_rows` refuses it."""
    vecs, pcs = built["vecs"][N_BUILD:], built["pcs"][N_BUILD:]
    B = len(vecs)
    levels = J.sample_levels(B, CFG, seed=5)
    mask = np.random.default_rng(9).random(B) < 0.6
    for jcfg in (CFG._replace(batched_insert=False),
                 CFG._replace(select_heuristic=True)):
        jst, jn = J.hnsw_insert_batch(
            jcfg, _jstate(built["state"]), jnp.asarray(vecs),
            jnp.asarray(pcs), jnp.asarray(levels), jnp.asarray(mask))
        tst, tn = T.hnsw_insert_batch(
            T.HNSWConfig(**jcfg._asdict()),
            T.state_from_numpy(built["state"], "cpu"), _t(vecs),
            torch.from_numpy(pcs.copy()), torch.from_numpy(levels),
            torch.from_numpy(mask))
        assert int(tn) == int(jn) == int(mask.sum())
        got = T.state_to_numpy(tst)
        for field in J.HNSWState._fields:
            np.testing.assert_array_equal(
                got[field], np.asarray(getattr(jst, field)), err_msg=field)
    tcfg = T.HNSWConfig(**CFG._asdict())
    x = torch.zeros((2, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown metric"):
        T.hnsw_search(tcfg._replace(metric="cosine"), T.hnsw_init(tcfg, "cpu"),
                      x, k=2)


def test_bitset_zeros_follows_the_device_rule(monkeypatch):
    from repro_torch.core.bitset import bitset_zeros
    card = torch.cuda.is_available()
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no GPU"):
            bitset_zeros(2, 100)
        bs = bitset_zeros(2, 100, device="cpu")
        assert bs.device.type == "cpu" and bs.shape == (2, 4) and not bs.any()
    if card:
        assert bitset_zeros(2, 100).device.type == "cuda"
