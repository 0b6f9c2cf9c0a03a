"""The per-doc insert path and the hnswlib selection heuristic of the
PyTorch port: `_select_diverse` and `_link_back` against the JAX package,
the heuristic's back-link rule on a hand-built row, and the property the
reference holds for its two insert organizations — a batch driven one
row at a time through the batched path builds the per-doc path's graph
bit for bit."""
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


def _corpus(n, seed=0, H=112, dup_rate=0.4):
    rng = np.random.default_rng(seed)
    sigs = rng.integers(0, 2**32, (n, H), dtype=np.uint64).astype(np.uint32)
    for i in range(4, n):
        if rng.random() < dup_rate:
            sigs[i] = sigs[rng.integers(0, i)]
            lanes = rng.choice(H, rng.integers(0, 6), replace=False)
            sigs[i, lanes] = rng.integers(0, 2**32, len(lanes), dtype=np.uint64)
    vecs = np.asarray(pack_bitmaps(jnp.asarray(sigs), T=1024))
    return vecs, np.asarray(popcount(jnp.asarray(vecs)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _numpy(state):
    return {k: np.array(v) for k, v in state._asdict().items()}


def _assert_equal_states(tst, jst):
    got = T.state_to_numpy(tst)
    for field in J.HNSWState._fields:
        np.testing.assert_array_equal(got[field], np.asarray(getattr(jst, field)),
                                      err_msg=field)


@pytest.fixture(scope="module")
def graph():
    """A JAX-built graph of 50 nodes over 64 slots (all 64 vectors set)."""
    vecs, pcs = _corpus(64, seed=1)
    cfg = J.HNSWConfig(capacity=64, words=32, M=8, M0=16, ef_construction=32,
                       ef_search=32, max_level=3)
    st, _ = J.hnsw_insert_batch(cfg, J.hnsw_init(cfg), jnp.asarray(vecs[:50]),
                                jnp.asarray(pcs[:50]),
                                jnp.asarray(J.sample_levels(50, cfg)),
                                jnp.ones(50, bool))
    st = st._replace(vectors=jnp.asarray(vecs), pb=jnp.asarray(pcs))
    return cfg._replace(select_heuristic=True), _numpy(st)


def test_select_diverse_matches_jax(graph):
    """Many rows of sorted candidates (some -1) through one vectorised
    call equal the reference's per-row fori loop, for two m_l."""
    cfg, snap = graph
    jst = J.HNSWState(**{k: jnp.asarray(v) for k, v in snap.items()})
    tst = T.state_from_numpy(snap, "cpu")
    tcfg = T.HNSWConfig(**cfg._asdict())
    rng = np.random.default_rng(2)
    ids_rows, d_rows = [], []
    for _ in range(12):
        q = int(rng.integers(0, 64))
        ids = rng.permutation(64)[:32].astype(np.int32)
        ids[rng.random(32) < 0.2] = -1
        d = np.asarray(J._dist_ids(cfg, jst, jst.vectors[q], jst.pb[q],
                                   jnp.asarray(ids)))
        order = np.argsort(d, kind="stable")
        ids_rows.append(ids[order])
        d_rows.append(d[order])
    ids_rows, d_rows = np.stack(ids_rows), np.stack(d_rows)
    for m_l in (8, 16):
        got = T._select_diverse(tcfg, tst, torch.from_numpy(ids_rows),
                                torch.from_numpy(d_rows), m_l).numpy()
        for r in range(len(ids_rows)):
            exp = J._select_diverse(cfg, jst, jnp.asarray(ids_rows[r]),
                                    jnp.asarray(d_rows[r]), m_l)
            np.testing.assert_array_equal(got[r], np.asarray(exp))
        assert ((got >= 0).sum(1) <= m_l).all()


@pytest.mark.parametrize("heuristic", [False, True])
def test_link_back_matches_jax(graph, heuristic):
    cfg, snap = graph
    cfg = cfg._replace(select_heuristic=heuristic)
    tcfg = T.HNSWConfig(**cfg._asdict())
    rng = np.random.default_rng(int(heuristic))
    for trial in range(6):
        new = 50 + trial
        sel = rng.permutation(50)[:8].astype(np.int32)
        for m_l in (4, 8, 16):
            jst = J._link_back(
                cfg, J.HNSWState(**{k: jnp.asarray(v) for k, v in snap.items()}),
                jnp.int32(new), 0, jnp.asarray(sel), m_l)
            tst = T.state_from_numpy(snap, "cpu")
            T._link_back(tcfg, tst, new, 0, torch.from_numpy(sel), m_l)
            np.testing.assert_array_equal(tst.neighbors.numpy(),
                                          np.asarray(jst.neighbors))


def test_link_back_honors_select_heuristic():
    """The reference's back-link rule (tests/test_hnsw.py), on bitmap
    vectors: an overfull row is re-selected by the heuristic (node 2 is
    closer to kept node 1 than to node 0, so it loses to the farther but
    diverse node 3); a row with room takes the new id without consulting
    it; without the heuristic the closest are kept."""
    cfg = J.HNSWConfig(capacity=8, words=1, M=2, M0=2, ef_construction=4,
                       ef_search=4, max_level=1, select_heuristic=True)
    vecs = np.zeros((8, 1), np.uint32)
    vecs[0, 0] = 0b1111
    vecs[1, 0] = 0b11111                # d(1, 0) = 2/10
    vecs[2, 0] = 0b111111               # d(2, 0) = 4/12, d(2, 1) = 2/12
    vecs[3, 0] = 0b1111 | (0b111 << 10)  # d(3, 0) = 6/14, d(3, 1) = 8/16
    pcs = np.array([bin(int(v)).count("1") for v in vecs[:, 0]], np.int32)
    base = J.hnsw_init(cfg)
    base = base._replace(
        vectors=jnp.asarray(vecs), pb=jnp.asarray(pcs),
        node_level=jnp.where(jnp.arange(8) < 4, 0, -1), count=jnp.int32(4))
    sel = np.array([0], np.int32)
    tcfg = T.HNSWConfig(**cfg._asdict())
    cases = [(cfg, [1, 2], 3, {1, 3}), (cfg._replace(select_heuristic=False),
                                        [1, 2], 3, {1, 2}),
             (cfg, [1, -1], 2, {1, 2})]
    for c, row, new, expect in cases:
        st = base._replace(neighbors=base.neighbors.at[0, 0].set(
            jnp.array(row, jnp.int32)))
        jrow = np.asarray(J._link_back(c, st, jnp.int32(new), 0,
                                       jnp.asarray(sel), 2).neighbors[0, 0])
        tst = T.state_from_numpy(_numpy(st), "cpu")
        T._link_back(tcfg._replace(select_heuristic=c.select_heuristic), tst,
                     new, 0, torch.from_numpy(sel), 2)
        trow = tst.neighbors[0, 0].numpy()
        assert set(trow.tolist()) == set(jrow.tolist()) == expect, (trow, jrow)
        np.testing.assert_array_equal(trow, jrow)


@pytest.mark.parametrize("heuristic,levels_kind", [
    (False, "sampled"), (True, "sampled"), (False, "tied"),
])
def test_batched_single_row_equals_per_doc(heuristic, levels_kind):
    """The reference's property, held by the port: the batched path driven
    one row at a time builds a graph BIT-IDENTICAL to the per-doc path over
    the whole batch (48 rows, mask permutations, level ties, heuristic),
    and the per-doc graph is the JAX package's."""
    vecs, pcs = _corpus(48)
    cfg = J.HNSWConfig(capacity=96, words=32, M=8, M0=16, ef_construction=16,
                       ef_search=16, max_level=3, select_heuristic=heuristic)
    if levels_kind == "tied":
        levels = np.ones(48, np.int32)
    else:
        levels = J.sample_levels(48, cfg)
    mask = np.random.default_rng(7).random(48) < 0.7
    seq = cfg._replace(batched_insert=False)
    jst, jn = J.hnsw_insert_batch(seq, J.hnsw_init(seq), jnp.asarray(vecs),
                                  jnp.asarray(pcs), jnp.asarray(levels),
                                  jnp.asarray(mask))
    tseq = T.HNSWConfig(**seq._asdict())
    tst, tn = T.hnsw_insert_batch(tseq, T.hnsw_init(tseq, "cpu"), _t(vecs),
                                  torch.from_numpy(pcs.copy()),
                                  torch.from_numpy(levels),
                                  torch.from_numpy(mask))
    assert int(tn) == int(jn) == int(mask.sum())
    _assert_equal_states(tst, jst)
    tcfg = T.HNSWConfig(**cfg._asdict())
    one = T.hnsw_init(tcfg, "cpu")
    n_tot = 0
    for i in range(48):
        one, n = T.hnsw_insert_batch(tcfg, one, _t(vecs[i:i + 1]),
                                     torch.from_numpy(pcs[i:i + 1].copy()),
                                     torch.from_numpy(levels[i:i + 1]),
                                     torch.from_numpy(mask[i:i + 1]))
        n_tot += int(n)
    assert n_tot == int(mask.sum())
    _assert_equal_states(one, jst)
