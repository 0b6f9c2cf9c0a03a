"""The per-doc insert path and the hnswlib selection heuristic of the
PyTorch port: `_select_diverse` and `_link_back` against the JAX package,
the heuristic's back-link rule on a hand-built row, and the property the
reference holds for its two insert organizations — a batch driven one
row at a time through the batched path builds the per-doc path's graph
bit for bit. Then the batched commit: its plan (`_plan_commit`) on a
hand-made batch, and applied by K5's plain version, in waves and group by
group, against the JAX package's graph; its record's counts."""
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


def _shared_target_batch(n_base=40, n_new=32, seed=3):
    """A JAX-built graph of n_base nodes and a batch of n_new near-copies
    of its node 0: every row back-links node 0 and the batch's earlier
    rows, so one target's row takes many new ids in turn."""
    vecs, _ = _corpus(n_base + n_new, seed=seed, dup_rate=0.0)
    vecs = vecs.copy()
    rng = np.random.default_rng(seed)
    for i in range(n_base, n_base + n_new):
        vecs[i] = vecs[0]
        flip = rng.choice(vecs.shape[1], 2, replace=False)
        vecs[i, flip] ^= np.uint32(1) << rng.integers(0, 32, 2).astype(
            np.uint32)
    pcs = np.asarray(popcount(jnp.asarray(vecs)))
    return vecs, pcs


def _jax_then_both(cfg, vecs, pcs, levels, mask, n_base):
    """The JAX package inserts the first n_base rows; then the JAX package
    and the port each insert the rest as one batch. Returns the JAX state
    and a CPU port state copied from before that batch."""
    jst, _ = J.hnsw_insert_batch(cfg, J.hnsw_init(cfg),
                                 jnp.asarray(vecs[:n_base]),
                                 jnp.asarray(pcs[:n_base]),
                                 jnp.asarray(levels[:n_base]),
                                 jnp.ones(n_base, bool))
    tst = T.state_from_numpy(_numpy(jst), "cpu")
    jst, _ = J.hnsw_insert_batch(cfg, jst, jnp.asarray(vecs[n_base:]),
                                 jnp.asarray(pcs[n_base:]),
                                 jnp.asarray(levels[n_base:]),
                                 jnp.asarray(mask))
    return jst, tst


@pytest.mark.parametrize("one_by_one", [False, True],
                         ids=["waves", "group_by_group"])
@pytest.mark.parametrize("heuristic,levels_kind", [
    (False, "sampled"), (True, "sampled"), (False, "tied"),
    (False, "shared"), (True, "shared"),
])
def test_commit_plan_equals_jax(heuristic, levels_kind, one_by_one,
                                monkeypatch):
    """A batch's commit, planned on the CPU (`_plan_commit`) and applied by
    the plain version of K5, builds the JAX package's graph bit for bit:
    applied in waves (the plain version) and applied strictly group by
    group, each group's new ids one at a time in row order. The "shared"
    batch sends many rows' back-links to one target row."""
    cfg = J.HNSWConfig(capacity=96, words=32, M=8, M0=16, ef_construction=16,
                       ef_search=16, max_level=3, select_heuristic=heuristic)
    if levels_kind == "shared":
        vecs, pcs = _shared_target_batch()
        n_base = 40
    else:
        vecs, pcs = _corpus(80, seed=5)
        n_base = 32
    n_new = len(vecs) - n_base
    if levels_kind == "tied":
        levels = np.ones(len(vecs), np.int32)
    else:
        levels = J.sample_levels(len(vecs), cfg)
    mask = np.random.default_rng(11).random(n_new) < 0.8
    jst, tst = _jax_then_both(cfg, vecs, pcs, levels, mask, n_base)
    seen = []

    def apply(tcfg, state, sched):
        seen.append(sched)
        if not one_by_one:
            T._link_back_plain(tcfg, state, sched)
            return
        start = sched.start.numpy()
        for g in range(sched.groups):
            for k in range(start[g], start[g + 1]):
                T._link_back_plain(tcfg, state, T.LinkSchedule(
                    sched.level[g:g + 1], sched.target[g:g + 1],
                    torch.tensor([0, 1]), sched.new_ids[k:k + 1]))

    monkeypatch.setattr(T, "link_back", apply)
    tcfg = T.HNSWConfig(**cfg._asdict())
    tst, n = T.hnsw_insert_batch(tcfg, tst, _t(vecs[n_base:]),
                                 torch.from_numpy(pcs[n_base:].copy()),
                                 torch.from_numpy(levels[n_base:]),
                                 torch.from_numpy(mask))
    assert int(n) == int(mask.sum())
    _assert_equal_states(tst, jst)
    sched, = seen
    sizes = np.diff(sched.start.numpy())
    assert sched.links == sizes.sum() > 0 and (sizes > 0).all()
    keys = sched.level.numpy() * cfg.capacity + sched.target.numpy()
    assert (np.diff(keys) > 0).all()
    if levels_kind == "shared":
        assert sizes.max() >= 8


def test_plan_commit_orders_each_target_by_row():
    """A hand-made batch: the running top, the entry, the forward rows and
    each (level, target) group's new ids in row order."""
    cfg = T.HNSWConfig(capacity=16, words=1, M=2, M0=3, max_level=1)
    adm = np.array([True, False, True, True])
    lvl = np.array([1, 0, 0, 1], np.int32)
    slot = np.array([10, 13, 11, 12], np.int32)
    sel = np.full((4, 2, 3), -1, np.int32)
    sel[0, 0, :2], sel[0, 1, :1] = [3, 4], [3]
    sel[1, 0] = [3, 4, 5]                    # not admitted
    sel[2, 0] = [4, 10, 3]
    sel[2, 1, :2] = [3, 10]                  # level 1 > the row's level
    sel[3, 0], sel[3, 1, :2] = [3, 4, 11], [3, 10]
    plan, sizes = T._plan_commit(cfg, adm, lvl, slot, 0, 5, sel)
    rows, levs, fslot, g_lev, g_tgt, start, new, tail = np.split(
        plan, np.cumsum(sizes)[:-1])
    # row 0 raises the top to 1 after linking at level 0 only; row 3 meets
    # top 1 and links at both levels without raising it
    assert list(zip(rows, levs, fslot)) == [(0, 0, 10), (2, 0, 11),
                                            (3, 0, 12), (3, 1, 12)]
    assert list(zip(g_lev, g_tgt)) == [(0, 3), (0, 4), (0, 10), (0, 11),
                                       (1, 3), (1, 10)]
    groups = [list(new[a:b]) for a, b in zip(start[:-1], start[1:])]
    assert groups == [[10, 11, 12], [10, 11, 12], [11], [12], [12], [12]]
    assert list(tail) == [10, 1]             # the entry, the top level


def test_commit_record_counts_links_and_groups(monkeypatch):
    """The open record's `insert.commit` entry carries the batch's
    back-link count and group count, the sizes of its schedule."""
    from repro_torch import spans
    vecs, pcs = _shared_target_batch()
    cfg = T.HNSWConfig(capacity=96, words=32, M=8, M0=16, ef_construction=16,
                       ef_search=16, max_level=3)
    levels = T.sample_levels(len(vecs), cfg)
    st = T.hnsw_init(cfg, "cpu")
    seen = []
    apply = T.link_back
    monkeypatch.setattr(T, "link_back",
                        lambda c, s, sched: (seen.append(sched),
                                             apply(c, s, sched)))
    entries = []
    for part in (slice(0, 40), slice(40, None)):
        stats: dict = {}
        with spans.span("insert", record=stats):
            st, _ = T.hnsw_insert_batch(cfg, st, _t(vecs[part]),
                                        torch.from_numpy(pcs[part].copy()),
                                        torch.from_numpy(levels[part]),
                                        torch.ones(len(vecs[part]),
                                                   dtype=torch.bool))
        entries.append(stats[spans.KEY]["insert.commit"])
    assert len(seen) == 2
    for e, sched in zip(entries, seen):
        assert e["links"] == sched.links > 0
        assert e["groups"] == sched.groups > 0
        assert e["syncs"] == 2
