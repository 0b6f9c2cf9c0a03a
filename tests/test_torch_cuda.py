"""The CUDA kernels against their plain PyTorch versions, on the card,
and the port's paths on the card against the CPU (the LM stack's every
REDUCED arch among them).

Marked `gpu`: without a card every test skips with a reason (decided at
run time, in a fixture). The file imports no JAX, so it runs on a machine
with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import collections
import os
import traceback
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core.bitset import bitset_zeros
from repro_torch.core.hashing import hash_seeds
from repro_torch.kernels import _lib, ops, ref
from repro_torch.kernels.bitmap_jaccard import bitmap_jaccard_matrix, hamming_matrix
from repro_torch.kernels.minhash import minhash_kernel_signatures

# K2-K4's tiled kernel has 32 x 32 outputs per block and stages 128 words
# of a row per pass: Q and N at tile - 1, tile, tile + 1 and 2 tile + 1, W
# on both sides of the 4-word vector and of the 128-word pass
TILE = 32
TILE_QN = [(TILE - 1, TILE + 1), (TILE, TILE), (TILE + 1, TILE - 1),
           (2 * TILE + 1, 2 * TILE + 1), (1, 2 * TILE + 1), (2 * TILE + 1, 1)]
JACCARD_SHAPES = ([(1, 1, 4), (8, 128, 128), (13, 201, 128), (5, 7, 64),
                   (128, 256, 32), (3, 130, 16), (512, 512, 128)]
                  + [(q, n, w) for q, n in TILE_QN
                     for w in (1, 3, 5, 127, 128, 129)]
                  + [(300, 1000, 128), (40, 70, 256)])
MINHASH_SHAPES = [(1, 4, 7), (5, 300, 112), (16, 128, 128), (9, 513, 64),
                  (2, 16, 1), (512, 384, 112)]
# K1: B off any multiple of the docs per block, L over one staged tile
# (512), H on and off the lane layouts; padding inside rows, rows with
# 0, 1 and L valid shingles (b, l, h, layout)
MINHASH_PADDED = [(1, 1500, 112, "single"), (7, 1500, 112, "mixed"),
                  (7, 384, 31, "mixed"), (513, 384, 112, "mixed"),
                  (513, 70, 1, "mixed"), (7, 1500, 128, "alternating"),
                  (7, 384, 128, "middle"), (13, 600, 1, "single"),
                  (9, 2, 112, "mixed"), (7, 384, 7, "mixed"),
                  (3, 200, 600, "mixed"), (3, 1024, 112, "full"),
                  (3, 513, 112, "full"), (512, 384, 112, "mixed")]
MINHASH_CASES = (
    [pytest.param(b, l, h, "tail", id=f"{b}-{l}-{h}")
     for b, l, h in MINHASH_SHAPES]
    + [pytest.param(b, l, h, pad, id=f"{b}-{l}-{h}-{pad}")
       for b, l, h, pad in MINHASH_PADDED])
ROW_PADS = ("alternating", "middle", "single", "empty", "full", "tail")
PAD = 0xFFFFFFFF


def to_t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def words(rng, shape) -> np.ndarray:
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def place_padding(sh: np.ndarray, kind: str, rng) -> np.ndarray:
    """Pad (0xFFFFFFFF) shingles of `sh` in place. "tail" pads the back
    half of row 0 only; "mixed" gives row r the layout ROW_PADS[r % 6];
    any other layout applies to every row."""
    b, l = sh.shape
    if kind == "tail":
        sh[0, l // 2:] = PAD
        return sh
    for r in range(b):
        k = ROW_PADS[r % len(ROW_PADS)] if kind == "mixed" else kind
        if k == "alternating":
            sh[r, ::2] = PAD
        elif k == "middle":
            sh[r, l // 3:2 * l // 3 + 1] = PAD
        elif k == "single":
            keep = rng.integers(l)
            sh[r, np.arange(l) != keep] = PAD
        elif k == "empty":
            sh[r] = PAD
        elif k == "tail":
            sh[r, l // 2:] = PAD
    return sh


@pytest.fixture
def cuda():
    """The card, decided at run time; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,w", JACCARD_SHAPES)
def test_cuda_pair_kernels_equal_plain(cuda, q, n, w):
    rng = np.random.default_rng(q + n + w)
    qs, db = to_t(words(rng, (q, w))).to(cuda), to_t(words(rng, (n, w))).to(cuda)
    pq, pb = ref.popcount(qs), ref.popcount(db)
    before = dict(_lib.LAUNCHES)
    pairs = [(bitmap_jaccard_matrix(qs, db, pq, pb), ref.bitmap_jaccard_ref(qs, db, pq, pb)),
             (bitmap_jaccard_matrix(qs, db, cached=False), ref.bitmap_jaccard_ref(qs, db)),
             (hamming_matrix(qs, db), ref.hamming_ref(qs, db))]
    torch.cuda.synchronize()
    for got, exp in pairs:
        assert torch.equal(got, exp)
    for k in ("jaccard_cached", "jaccard_nocache", "hamming"):
        assert _lib.LAUNCHES[k] == before[k] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,h,pad", MINHASH_CASES)
def test_cuda_minhash_kernel_equals_plain(cuda, b, l, h, pad):
    rng = np.random.default_rng(b + l + h)
    sh_t = to_t(place_padding(words(rng, (b, l)), pad, rng)).to(cuda)
    seeds = hash_seeds(h, device=cuda)
    before = _lib.LAUNCHES["minhash"]
    got = minhash_kernel_signatures(sh_t, seeds)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["minhash"] == before + 1
    assert torch.equal(got, ref.minhash_ref(sh_t, seeds))


def _epilogue(kind: str):
    """(kernel, plain version) of one of the tiled kernel's epilogues."""
    if kind == "cached":
        return (lambda a, b: bitmap_jaccard_matrix(a, b, ref.popcount(a),
                                                   ref.popcount(b)),
                lambda a, b: ref.bitmap_jaccard_ref(a, b, ref.popcount(a),
                                                    ref.popcount(b)))
    if kind == "nocache":
        return (lambda a, b: bitmap_jaccard_matrix(a, b, cached=False),
                ref.bitmap_jaccard_ref)
    return hamming_matrix, ref.hamming_ref


@pytest.mark.gpu
@pytest.mark.parametrize("epilogue", ["cached", "nocache", "hamming"])
@pytest.mark.parametrize("w,offset", [(5, 5), (128, 1), (128, 4), (8, 2)])
def test_cuda_jaccard_cached_on_offset_views(cuda, w, offset, epilogue):
    """Contiguous row views whose data pointer is `offset` words into the
    buffer: (5, 5) is big[1:] with W = 5, (128, 1) a W that takes vector
    loads on a base that is not 16-byte aligned; for K2, K3 and K4."""
    kern, plain = _epilogue(epilogue)
    rng = np.random.default_rng(w + offset)
    flat = to_t(words(rng, (offset + 70 * w,))).to(cuda)
    db = flat[offset:].view(70, w)
    qs = to_t(words(rng, (33, w))).to(cuda)
    for a, b in ((qs, db), (db, qs), (db, db)):
        got = kern(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,w", [(512, 512, 128), (33, 65, 129),
                                   (31, 70, 5), (65, 1, 256)])
def test_cuda_nocache_recount_equals_cached(cuda, q, n, w):
    """K3 recounts the rows' popcounts inside the kernel: its matrix equals
    K2's fed the popcounts from outside, with one launch each. Rows of
    every density (empty, sparse, full) stress the recount."""
    rng = np.random.default_rng(q * n + w)
    qs, db = words(rng, (q, w)), words(rng, (n, w))
    qs[::3] &= words(rng, (len(qs[::3]), w))        # sparser rows
    qs[0] = 0
    db[-1] = 0xFFFFFFFF
    qs, db = to_t(qs).to(cuda), to_t(db).to(cuda)
    before = dict(_lib.LAUNCHES)
    k3 = bitmap_jaccard_matrix(qs, db, cached=False)
    k2 = bitmap_jaccard_matrix(qs, db, ref.popcount(qs), ref.popcount(db))
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["jaccard_nocache"] == before["jaccard_nocache"] + 1
    assert _lib.LAUNCHES["jaccard_cached"] == before["jaccard_cached"] + 1
    assert torch.equal(k3, k2)


@pytest.mark.gpu
@pytest.mark.parametrize("w", [5, 112, 129])
def test_cuda_hamming_rounds_as_plain_helper(cuda, w):
    """K4 against `ref.hamming_from_px` for every distance px in [0, 32 W]:
    database row i has its first i bits set and the query is empty, so
    px = i. 32 W is not a power of two here, where the rounding matters."""
    bits = 32 * w
    set_bits = np.arange(bits)[None, :] < np.arange(bits + 1)[:, None]
    db = np.packbits(set_bits, axis=1, bitorder="little").view(np.uint32)
    db_t = to_t(db).to(cuda)
    qs_t = torch.zeros((1, w), dtype=torch.int32, device=cuda)
    got = hamming_matrix(qs_t, db_t)
    torch.cuda.synchronize()
    exp = ref.hamming_from_px(torch.arange(bits + 1, dtype=torch.int32), bits)
    assert torch.equal(got.cpu()[0], exp)
    assert torch.equal(got, ref.hamming_ref(qs_t, db_t))


@pytest.mark.gpu
def test_cuda_bitset_zeros_defaults_to_the_card(cuda):
    assert bitset_zeros(2, 100).device.type == "cuda"


@pytest.mark.gpu
def test_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")
    x = to_t(words(np.random.default_rng(0), (16, 32))).to(cuda)
    for name in ("bitmap_jaccard_ref", "hamming_ref", "minhash_ref"):
        monkeypatch.setattr(ref, name, boom)
    ops.bitmap_jaccard(x, x, ref.popcount(x), ref.popcount(x))
    ops.bitmap_jaccard(x, x, cached=False)
    ops.hamming(x, x)
    ops.minhash(x, x[0])
    # the insert's commit, batched and per doc, through K5 alone
    from repro_torch.core import hnsw
    monkeypatch.setattr(hnsw, "_link_back_plain", boom)
    monkeypatch.setattr(hnsw, "_link_back", boom)
    before = _lib.LAUNCHES["link_back"]
    for batched in (True, False):
        cfg = hnsw.HNSWConfig(capacity=64, words=32, M=4, M0=8,
                              ef_construction=8, ef_search=8, max_level=2,
                              batched_insert=batched)
        hnsw.hnsw_insert_batch(cfg, hnsw.hnsw_init(cfg, cuda), x,
                               ref.popcount(x),
                               torch.zeros(16, dtype=torch.int32),
                               torch.ones(16, dtype=torch.bool))
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["link_back"] > before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("h", [7, 31, 112, 128])
def test_cuda_minhash_jaccard_rounds_as_cpu(cuda, h):
    """pairwise_minhash_jaccard and minhash_jaccard_sim on the card equal
    the CPU's, count * f32(1/H), at every lane count 0..H; the exact-verify
    rescoring equals numpy's float64 mean cast to f32 on both."""
    from repro_torch.core import bitmap as bm
    from repro_torch.index.backends.hnsw import _lane_fraction_f64
    rng = np.random.default_rng(h)
    a = words(rng, (1, h))
    b = np.repeat(a, h + 1, axis=0) ^ np.uint32(1)
    for i in range(h + 1):
        lanes = rng.permutation(h)[:i]
        b[i, lanes] = a[0, lanes]
    ta, tb = to_t(a), to_t(b)
    exp = np.arange(h + 1, dtype=np.float32) * (np.float32(1) / np.float32(h))
    got = bm.pairwise_minhash_jaccard(ta.to(cuda), tb.to(cuda)).cpu()
    assert torch.equal(got, bm.pairwise_minhash_jaccard(ta, tb))
    np.testing.assert_array_equal(got.numpy()[0], exp)
    rows = ta.repeat(h + 1, 1)
    assert torch.equal(bm.minhash_jaccard_sim(rows.to(cuda), tb.to(cuda)).cpu(),
                       bm.minhash_jaccard_sim(rows, tb))
    eq = rows == tb
    f64 = _lane_fraction_f64(eq.to(cuda)).cpu()
    assert torch.equal(f64, _lane_fraction_f64(eq))
    np.testing.assert_array_equal(
        f64.numpy(), (a == b).mean(-1).astype(np.float32))


def _cc_batches(n, size, seed=0):
    from repro_torch.data.corpus import DATASET_PRESETS, SyntheticCorpus
    import dataclasses
    src = SyntheticCorpus(dataclasses.replace(DATASET_PRESETS["common_crawl"],
                                              seed=seed))
    return [src.next_batch(size)[:2] for _ in range(n)]


def _same_state(a, b):
    from repro_torch.core.hnsw import state_to_numpy
    na, nb = state_to_numpy(a), state_to_numpy(b)
    return [k for k in na if not np.array_equal(na[k], nb[k])]


COMMIT_CASES = ["shared_target", "duplicates", "empty_graph", "above_top",
                "free_slots"]


def _commit_rows(metric, n, rng):
    """n rows: 4,096-bit bitmaps with 112 bits set (bitmap_jaccard,
    hamming) or 112 MinHash lanes (minhash_jaccard)."""
    if metric == "minhash_jaccard":
        return words(rng, (n, 112))
    bits = np.zeros((n, 4096), bool)
    for r in range(n):
        bits[r, rng.choice(4096, 112, replace=False)] = True
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


def _near(metric, v, rng, k=3):
    """A near-copy of row v: k lanes redrawn, or k set bits moved."""
    if metric == "minhash_jaccard":
        v = v.copy()
        v[rng.choice(v.size, k, replace=False)] = words(rng, k)
        return v
    bits = np.unpackbits(v.view(np.uint8), bitorder="little").astype(bool)
    bits[rng.choice(np.flatnonzero(bits), k, replace=False)] = False
    bits[rng.choice(np.flatnonzero(~bits), k, replace=False)] = True
    return np.packbits(bits, bitorder="little").view(np.uint32)


def _commit_case(kind, metric, heuristic):
    """(cfg, base rows and levels, two batches of (rows, levels, mask)) for
    one case of test_cuda_commit_kernel_equals_plain."""
    from repro_torch.core.hnsw import HNSWConfig, sample_levels
    rng = np.random.default_rng(COMMIT_CASES.index(kind) * 7 + len(metric))
    # M0 = 32 puts M0 + 1 = 33 candidates on a warp's 32 lanes
    wide = kind in ("shared_target", "duplicates")
    W = 112 if metric == "minhash_jaccard" else 128
    cfg = HNSWConfig(capacity=512, words=W, M=16 if wide else 8,
                     M0=32 if wide else 16, ef_construction=32,
                     ef_search=32, max_level=3, metric=metric,
                     select_heuristic=heuristic)
    base = _commit_rows(metric, 0 if kind == "empty_graph" else 160, rng)
    base_lv = (np.zeros(len(base), np.int32) if kind == "above_top"
               else sample_levels(len(base), cfg, seed=1))
    batches = []
    for b in range(2):
        rows = _commit_rows(metric, 64, rng)
        if kind == "shared_target":     # many rows back-link one target
            rows[:48] = [_near(metric, base[b], rng) for _ in range(48)]
        elif kind == "duplicates":      # equal distances: the tie order
            rows[:8] = base[5 + b]
            rows[8:16] = rows[16]
        else:
            for i in range(32, 64):
                rows[i] = _near(metric, rows[i - 32], rng)
        lv = (rng.integers(0, 4, 64).astype(np.int32) if kind == "above_top"
              else sample_levels(64, cfg, seed=2 + b))
        batches.append((rows, lv, rng.random(64) < 0.9))
    return cfg, (base, base_lv), batches


@pytest.mark.gpu
@pytest.mark.parametrize("kind", COMMIT_CASES)
@pytest.mark.parametrize("heuristic", [False, True], ids=["closest", "heuristic"])
@pytest.mark.parametrize("metric", ["bitmap_jaccard", "minhash_jaccard",
                                    "hamming"])
def test_cuda_commit_kernel_equals_plain(cuda, metric, heuristic, kind,
                                         monkeypatch):
    """hnsw_insert_batch on the card, whose commit is K5, leaves the state
    (neighbors, entry, top_level and the rest) bit-equal to the CPU's plain
    path after every batch, with one K5 launch a batch: many rows
    back-linking one target (hazard L), duplicate vectors (tie order), an
    empty graph, rows above the running top level, reused free slots."""
    from repro_torch.core import hnsw
    cfg, (base, base_lv), batches = _commit_case(kind, metric, heuristic)
    scheds = []
    apply = hnsw.link_back

    def recorded(c, st, sched):
        sizes = np.diff(sched.start.cpu().numpy())
        scheds.append((st.neighbors.device.type, sched.links,
                       int(sizes.max(initial=0))))
        apply(c, st, sched)

    monkeypatch.setattr(hnsw, "link_back", recorded)

    def run(dev):
        def t(a):
            return to_t(a).to(dev)

        def insert(st, rows, lv, mask, free=None):
            return hnsw.hnsw_insert_batch(
                cfg, st, t(rows), ref.popcount(t(rows)),
                torch.from_numpy(lv).to(dev), torch.from_numpy(mask).to(dev),
                free_slots=free)

        st = hnsw.hnsw_init(cfg, dev)
        if len(base):
            st, _ = insert(st, base, base_lv, np.ones(len(base), bool))
        free = None
        if kind == "free_slots":
            st, _ = hnsw.hnsw_delete(cfg, st, torch.arange(0, 160, 3,
                                                           device=dev))
            st, _ = hnsw.hnsw_compact(cfg, st)
            # the backend's free list: unlinked slots below the count
            lv = st.node_level.cpu().numpy()[:int(st.count)]
            free = np.full(64, -1, np.int32)
            got = np.flatnonzero(lv < 0)[:64]
            free[:len(got)] = got
            free = torch.from_numpy(free).to(dev)
        out = []
        for b, (rows, lv, mask) in enumerate(batches):
            before = _lib.LAUNCHES["link_back"]
            st, n = insert(st, rows, lv, mask, free if b == 0 else None)
            torch.cuda.synchronize()
            out.append((hnsw.state_to_numpy(st), int(n),
                        _lib.LAUNCHES["link_back"] - before))
        return out

    card, host = run(cuda), run("cpu")
    for b, ((cs, cn, cl), (hs, hn, hl)) in enumerate(zip(card, host)):
        assert cn == hn == int(batches[b][2].sum()), b
        for field in ("neighbors", "entry", "top_level", "vectors", "pb",
                      "node_level", "dead", "count"):
            np.testing.assert_array_equal(cs[field], hs[field],
                                          err_msg=f"batch {b}: {field}")
        assert (cl, hl) == (1, 0), b
    on_card = [s for s in scheds if s[0] == "cuda"]
    assert on_card and all(links > 0 for _, links, _ in on_card)
    if kind == "shared_target":
        assert max(m for *_, m in on_card) >= 8


@pytest.mark.gpu
def test_cuda_brute_matches_cpu(cuda, monkeypatch):
    """brute on the card equals brute on the CPU (keep masks, ids and sims
    bit for bit) across chunk boundaries, with deletes and free-row reuse."""
    from repro_torch.core.dedup import FoldConfig
    from repro_torch.index import make_pipeline
    from repro_torch.index.backends import brute
    monkeypatch.setattr(brute, "_CHUNK", 48)
    cfg = FoldConfig(capacity=512, tau=0.7, threshold_space="minhash")
    pipes = [make_pipeline("brute", cfg, device=d)  # foldlint: disable=F131
             for d in (cuda, "cpu")]
    for p in pipes:
        p.backend.track_slots = True
    batches = _cc_batches(4, 64)
    for i, (tok, ln) in enumerate(batches + batches[:1]):
        keeps = [p.process_batch(tok, ln)[0] for p in pipes]
        assert np.array_equal(*keeps), i
        res = [p.query(tok, ln) for p in pipes]
        assert np.array_equal(res[0].ids, res[1].ids)
        assert np.array_equal(res[0].sims, res[1].sims)
        slots = [np.concatenate(p.backend.pop_slot_log() or [np.empty(0)])
                 for p in pipes]
        assert np.array_equal(*slots)
        if i == 1:
            assert pipes[0].delete(slots[0][::2]) == pipes[1].delete(slots[1][::2])


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [{}, {"select_heuristic": True},
                                  {"batched_insert": False},
                                  {"verify_minhash": True},
                                  {"exact_filter": True}],
                         ids=["default", "heuristic", "per_doc", "verify",
                              "exact"])
def test_cuda_options_and_compact_match_cpu(cuda, opts):
    """FoldPipeline with each option on the card equals it on the CPU
    (keep masks and state) through delete, compact and free-slot reuse."""
    from repro_torch.core.dedup import FoldConfig, FoldPipeline
    cfg = FoldConfig(capacity=512, M=8, M0=16, ef_construction=32,
                     ef_search=32, **opts)
    pipes = [FoldPipeline(cfg, device=d) for d in (cuda, "cpu")]
    batches = _cc_batches(3, 48)
    for i, (tok, ln) in enumerate(batches + batches[:1]):
        keeps = [p.process_batch(tok, ln)[0] for p in pipes]
        assert np.array_equal(*keeps), i
        assert not _same_state(pipes[0].state, pipes[1].state), i
        if i == 1:
            live = np.flatnonzero(pipes[1].state.node_level.numpy() >= 0)
            assert pipes[0].delete(live[::3]) == pipes[1].delete(live[::3])
            out = [p.compact() for p in pipes]
            assert out[0]["reclaimed"] == out[1]["reclaimed"] > 0
            assert not _same_state(pipes[0].state, pipes[1].state)


@pytest.mark.gpu
@pytest.mark.parametrize("key,opts", [
    ("hnsw_raw", {"metric": "minhash_jaccard"}),
    ("hnsw_raw", {"metric": "hamming"}), ("dpk", {"rebuild": True}),
    ("flat_lsh", {"topk": 4}), ("flat_lsh", {"topk": 160}),
    ("prefix_filter", {})],
    ids=["raw-jaccard", "raw-hamming", "dpk", "flat4", "flat160", "prefix"])
def test_cuda_baselines_match_cpu(cuda, key, opts):
    """Each newly ported backend on the card equals itself on the CPU over
    two batches (keep masks, query ids and sims bit for bit; the full
    state for hnsw_raw). Step ① launched K1 on every key but
    prefix_filter, which runs no MinHash."""
    from repro_torch.core.dedup import FoldConfig
    from repro_torch.index import make_pipeline
    cfg = FoldConfig(capacity=512, M=8, M0=16, ef_construction=32,
                     ef_search=32)
    pipes = [make_pipeline(key, cfg, device=d, **opts) for d in (cuda, "cpu")]
    _lib.reset_launches()
    for i, (tok, ln) in enumerate(_cc_batches(2, 64, seed=4)):
        keeps = [p.process_batch(tok, ln)[0] for p in pipes]
        assert np.array_equal(*keeps), i
        res = [p.query(tok, ln) for p in pipes]
        assert np.array_equal(res[0].ids, res[1].ids), i
        assert np.array_equal(res[0].sims.view(np.uint32),
                              res[1].sims.view(np.uint32)), i
        if key == "hnsw_raw":
            assert not _same_state(pipes[0].backend.state,
                                   pipes[1].backend.state), i
    assert (_lib.LAUNCHES["minhash"] > 0) == (key != "prefix_filter")


def _verdicts(vs):
    return [(v.doc_id, v.admitted, v.reason, v.neighbor_id,
             int(np.float32(v.similarity).view(np.uint32))) for v in vs]


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [0, 2])
def test_cuda_service_verdicts_match_cpu(cuda, tmp_path, depth):
    """DedupService on the card and on the CPU over the same ragged
    submits: equal verdicts, counters, grow events, committed snapshot
    steps (with equal bytes) and index state; the service's path launched
    K1 and K2."""
    from repro_torch.core.dedup import FoldConfig
    from repro_torch.service import DedupService, ServiceConfig
    svcs = [DedupService(ServiceConfig(
        fold=FoldConfig(capacity=128, M=8, M0=16, ef_construction=32,
                        ef_search=32), max_batch=64, max_wait_ms=0.0,
        pipeline_depth=depth, stage_timer_every=3,
        snapshot_dir=str(tmp_path / str(d)), snapshot_every=2,
        max_snapshots=2, device=d)) for d in (cuda, "cpu")]  # foldlint: disable=F141 (the port's ServiceConfig adds device)
    rng = np.random.default_rng(depth)
    docs = [(t, ln) for t, ln in _cc_batches(6, 100)]
    _lib.reset_launches()
    tickets = [[], []]
    for tok, ln in docs:
        n = int(rng.integers(1, len(tok)))
        for i, svc in enumerate(svcs):
            tickets[i].append(svc.submit(tok[:n], ln[:n]))
    for svc in svcs:
        svc.flush()
    assert _lib.LAUNCHES["minhash"] > 0 and _lib.LAUNCHES["jaccard_cached"] > 0
    out = [[v for t in ts for v in svc.results(t)]
           for ts, svc in zip(tickets, svcs)]
    assert _verdicts(out[0]) == _verdicts(out[1])
    s = [svc.stats() for svc in svcs]
    assert s[0]["counters"] == s[1]["counters"]
    assert s[0]["index"]["grow_events"] == s[1]["index"]["grow_events"] > 0
    steps = [svc.index_manager.committed_steps() for svc in svcs]
    assert steps[0] == steps[1] and steps[0]
    for step in steps[0]:
        name = f"step_{step:08d}/arrays.msgpack"
        assert (tmp_path / str(cuda) / name).read_bytes() == \
            (tmp_path / "cpu" / name).read_bytes()
    assert not _same_state(svcs[0].pipeline.backend.state,
                           svcs[1].pipeline.backend.state)


@pytest.mark.gpu
def test_cuda_replica_matches_cpu_replica(cuda, tmp_path):
    """One published epoch restored by a replica on the card and by one on
    the CPU: equal query results, and equal to the writer's."""
    import dataclasses

    from repro_torch.cluster import (ClusterConfig, ClusterWriter,
                                     ReadReplica, TenantSpec)
    from repro_torch.core.dedup import FoldConfig
    from repro_torch.service import ServiceConfig
    scfg = ServiceConfig(fold=FoldConfig(capacity=512, M=8, M0=16,
                                         ef_construction=32, ef_search=32),
                         max_batch=32, max_wait_ms=0.0,
                         snapshot_dir=str(tmp_path), device=cuda)  # foldlint: disable=F141 (the port's ServiceConfig adds device)
    w = ClusterWriter(ClusterConfig(
        service=scfg, n_replicas=0,
        tenants=(TenantSpec("capped", max_live_docs=40),)))
    replicas = [ReadReplica(dataclasses.replace(scfg, device=d))  # foldlint: disable=F142 (the port's ServiceConfig adds device)
                for d in (cuda, "cpu")]
    for tok, ln in _cc_batches(3, 48, seed=1):
        w.results(w.submit(tok, ln, tenant="capped"))
        w.publish()
        assert all(r.refresh() for r in replicas)
        probe = _cc_batches(1, 32, seed=2)[0]
        res = [r.query(*probe) for r in replicas] + [w.query(*probe)]
        for a in res[1:]:
            assert np.array_equal(res[0].is_dup, a.is_dup)
            assert np.array_equal(res[0].ids, a.ids)
            assert np.array_equal(res[0].sims.view(np.uint32),
                                  a.sims.view(np.uint32))
    assert replicas[0].pipeline.device.type == "cuda"
    assert w.stats()["cluster"]["tenants"]["capped"]["evicted"] > 0
    assert not _same_state(replicas[0].pipeline.backend.state,
                           replicas[1].pipeline.backend.state)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 4])
def test_cuda_sharded_matches_cpu(cuda, tmp_path, shards):
    """hnsw_sharded on the card equals it on the CPU: keep masks, every
    per-shard state, the merged query's ids and sims, delete by global id,
    compact and free-slot reuse, and the snapshot bytes; its step ① ran
    K1 once per batch."""
    from repro_torch.core.dedup import FoldConfig
    from repro_torch.index import make_pipeline
    cfg = FoldConfig(capacity=256, M=8, M0=16, ef_construction=32,
                     ef_search=32)
    pipes = [make_pipeline("hnsw_sharded", cfg, shards=shards, device=d)  # foldlint: disable=F131 (the port's factories add device)
             for d in (cuda, "cpu")]
    for p in pipes:
        p.backend.track_slots = True
    batches = _cc_batches(4, 62, seed=5)
    _lib.reset_launches()
    for i, (tok, ln) in enumerate(batches):
        keeps = [p.process_batch(tok, ln)[0] for p in pipes]
        assert np.array_equal(*keeps), i
        for a, b in zip(*(p.backend.states for p in pipes)):
            assert not _same_state(a, b), i
        if i == 1:
            slots = [np.concatenate(p.backend.pop_slot_log()) for p in pipes]
            assert np.array_equal(*slots)
            n = [p.delete(slots[0][::3]) for p in pipes]
            assert n[0] == n[1] == len(slots[0][::3])
            out = [p.compact() for p in pipes]
            assert out[0]["reclaimed"] == out[1]["reclaimed"] > 0
            assert pipes[0].backend._free == pipes[1].backend._free
    assert _lib.LAUNCHES["minhash"] == len(batches)
    res = [p.query(*batches[0]) for p in pipes]
    assert np.array_equal(res[0].ids, res[1].ids)
    assert np.array_equal(res[0].sims.view(np.uint32),
                          res[1].sims.view(np.uint32))
    for p, d in zip(pipes, ("cuda", "cpu")):
        p.save(str(tmp_path / d), 1)
    name = "step_00000001/arrays.msgpack"
    assert (tmp_path / "cuda" / name).read_bytes() == \
        (tmp_path / "cpu" / name).read_bytes()


@pytest.mark.gpu
@pytest.mark.parametrize("call", ["search", "insert", "process_batch"])
def test_cuda_sync_counter_equals_sync_debug_mode(cuda, call, monkeypatch):
    """`repro_torch.spans` counts, under an open record, exactly the
    synchronizations that `torch.cuda.set_sync_debug_mode` reports for the
    same call, less the stage timers' own waits (`spans.ready`)."""
    from repro_torch import spans
    from repro_torch.core.dedup import FoldConfig, FoldPipeline
    from repro_torch.core.hnsw import (hnsw_insert_batch, hnsw_search,
                                       sample_levels)
    pipe = FoldPipeline(FoldConfig(capacity=4096, M=8, M0=16,
                                   ef_construction=32, ef_search=32),
                        device=cuda)
    batches = _cc_batches(4, 96)
    for tok, ln in batches[:3]:
        pipe.process_batch(tok, ln)
    be = pipe.backend
    sig = pipe.signatures(*batches[3])
    ids, _ = be.search(sig)
    levels = torch.from_numpy(sample_levels(96, be.hnsw_cfg, seed=7)).to(cuda)
    mask = torch.arange(96, device=cuda) % 3 != 0
    stats: dict = {}

    def run():
        if call == "process_batch":
            stats.update(pipe.process_batch(*batches[3])[1])
            return
        with spans.span(call, record=stats):
            if call == "search":
                hnsw_search(be.hnsw_cfg, be.state, sig.bitmaps, k=4)
            else:
                hnsw_insert_batch(be.hnsw_cfg, be.state, sig.bitmaps,
                                  sig.pcs, levels, mask, seed_ids=ids)

    _assert_syncs_counted(cuda, monkeypatch, run, stats)


def _assert_syncs_counted(cuda, monkeypatch, run, stats,
                          under=lambda name: True) -> None:
    """`run()` makes, under the spans of `stats` that `under(name)` picks,
    as many counted syncs as sync-debug mode reports, less the stage
    timers' own waits."""
    from repro_torch import spans
    ready, sites = [], []
    sync, wait = spans.sync, spans.ready

    def counted():
        frame = next(f for f in reversed(traceback.extract_stack()[:-1])
                     if not f.filename.endswith("spans.py"))
        sites.append(f"{os.path.basename(frame.filename)}:{frame.lineno}")
        sync()

    def timed(x):
        ready.append(1)
        wait(x)

    def debug_mode(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return [w for w in caught
                if "synchronizing CUDA operation" in str(w.message)]

    monkeypatch.setattr(spans, "sync", counted)
    monkeypatch.setattr(spans, "ready", timed)
    torch.cuda.synchronize()
    per_wait = len(debug_mode(lambda: torch.cuda.synchronize(cuda)))
    before = sum(e["syncs"] for name, e in stats.get(spans.KEY, {}).items()
                 if under(name))
    caught = debug_mode(run)
    n = sum(e["syncs"] for name, e in stats[spans.KEY].items()
            if under(name)) - before
    assert n == len(sites) > 0
    assert len(caught) - per_wait * len(ready) == n, (
        f"sync-debug sites {collections.Counter(_where(w) for w in caught)}; "
        f"counted sites {collections.Counter(sites)}; timer waits "
        f"{len(ready)}, each {per_wait} sync-debug syncs")


@pytest.mark.gpu
@pytest.mark.parametrize("call", ["expire", "compact"])
def test_cuda_lifecycle_sync_counter_equals_sync_debug_mode(cuda, call,
                                                            monkeypatch):
    """The lifecycle's spans (`lifecycle.expire`; `lifecycle.compact` and
    its `compact.repair`, `compact.unlink`, `compact.free`) count exactly
    the synchronizations sync-debug mode reports for one expiry and for
    one compaction, each run on the stats of the batch after which it
    runs."""
    from repro_torch import spans
    from repro_torch.core.dedup import FoldConfig, FoldPipeline
    from repro_torch.lifecycle import LifecycleManager
    pipe = FoldPipeline(FoldConfig(capacity=4096, M=8, M0=16,
                                   ef_construction=32, ef_search=32),
                        device=cuda)
    mgr = LifecycleManager(pipe, ttl_steps=2, compact_watermark=2.0)
    batches = _cc_batches(5, 96)
    for tok, ln in batches[:4]:
        pipe.process_batch(tok, ln)
        mgr.after_batch()
    assert pipe.dead_fraction > 0
    stats = pipe.process_batch(*batches[4])[1]
    if call == "expire":
        def run():
            assert mgr.after_batch(record=stats) > 0
    else:
        def run():
            assert mgr.compact(record=stats)["reclaimed"] > 0
    _assert_syncs_counted(
        cuda, monkeypatch, run, stats,
        lambda name: name.startswith(("lifecycle.", "compact.")))
    assert ("lifecycle.compact" in stats[spans.KEY]) == (call == "compact")


def _where(w) -> str:
    return f"{os.path.basename(w.filename)}:{w.lineno}"


@pytest.mark.gpu
def test_cuda_program_gate_holds_on_one_spec(cuda, capsys):
    """`python -m repro_torch.analysis check --device cuda` on hnsw/delete:
    its budgets hold on the card (syncs, temp bytes), and the run equals
    the CPU's in interface, aliasing, data-dependent ops and outputs."""
    from repro_torch.analysis import analyze_program, default_specs
    from repro_torch.analysis.__main__ import main
    from repro_torch.analysis.analyze import tensor_leaves
    assert main(["check", "--device", "cuda", "--select", "hnsw/delete"]) == 0
    assert "golden fingerprints not compared on cuda" in capsys.readouterr().out
    spec, = default_specs(["hnsw/delete"])
    got, want = analyze_program(spec, cuda), analyze_program(spec, "cpu")
    for key in ("in_avals", "out_avals", "aliased", "data_dependent_ops",
                "memory"):
        if key == "memory":
            assert got.fingerprint[key]["argument_bytes"] == \
                want.fingerprint[key]["argument_bytes"]
            assert got.fingerprint[key]["temp_bytes"] > 0
        else:
            assert got.fingerprint[key] == want.fingerprint[key], key
    assert got.measure.syncs >= got.measure.data_dependent
    assert got.measure.launches > 0
    for a, b in zip(tensor_leaves(got.measure.outputs),
                    tensor_leaves(want.measure.outputs)):
        assert torch.equal(a.cpu(), b)


# the LM stack: every REDUCED arch; tolerances of tests/test_torch_models.py
# (f32 1e-4, the SSM families 2e-3; bf16 atol=0.15, rtol=0.05, and zamba2,
# ill-conditioned at bf16, no further from the CPU's f32 outputs than the
# CPU's own bf16 outputs, within 25%)
LM_ARCHS = ["qwen1_5_4b", "stablelm_1_6b", "stablelm_12b", "gemma3_27b",
            "zamba2_7b", "grok_1_314b", "qwen3_moe_235b", "falcon_mamba_7b",
            "internvl2_1b", "whisper_medium"]


def _lm_outputs(cfg, dev):
    """Prefill logits, a decode step at pos 3 (logits, cache leaves) and
    generate at batch 2, prompt 8, gen 8; weights from a CPU generator."""
    from repro_torch.launch.serve import generate, init_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train.step import make_decode_step, make_prefill_step
    rng = np.random.default_rng(0)
    params, caches = init_model(cfg, 2, 16, dev, rng,
                                generator=torch.Generator().manual_seed(0))
    prompts = rng.integers(1, cfg.vocab, (2, 8))
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.as_tensor(
            rng.normal(size=(2, cfg.prefix_len, cfg.d_model)),
            dtype=torch.float32, device=dev)
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(
            rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)),
            dtype=torch.float32, device=dev)
    prefill = make_prefill_step(cfg)(params, batch)
    step_caches = tree_map(torch.clone, caches)
    logits, step_caches = make_decode_step(cfg)(
        params, step_caches, batch["tokens"][:, 0],
        torch.full((2,), 3, dtype=torch.int64, device=dev))
    out = generate(cfg, params, caches, prompts, 8)
    leaves = [prefill, logits, out.prompt_logits] + tree_leaves(step_caches)
    return [t.float().cpu().numpy() for t in leaves], out.tokens


@pytest.mark.gpu
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_lm_serving_matches_cpu(cuda, arch, cdt):
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.kernels import _lib
    cfg = dataclasses.replace(reduced_config(arch), compute_dtype=cdt)
    _lib.reset_launches()
    got, got_tokens = _lm_outputs(cfg, cuda)
    assert not any(_lib.LAUNCHES.values())
    want, want_tokens = _lm_outputs(cfg, torch.device("cpu"))
    assert len(got) == len(want)
    if cdt == "float32":
        tol = 2e-3 if cfg.family in ("ssm", "hybrid") else 1e-4
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol)
        np.testing.assert_array_equal(got_tokens, want_tokens)
    elif cfg.family == "hybrid":
        truth, _ = _lm_outputs(dataclasses.replace(cfg, compute_dtype="float32"),
                               torch.device("cpu"))
        for g, w, t in zip(got, want, truth):
            assert np.abs(g - t).mean() <= 1.25 * np.abs(w - t).mean()
            assert np.abs(g - t).max() <= 1.25 * np.abs(w - t).max()
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=0.15, rtol=0.05)


# the training step on the card: one REDUCED qwen1.5-4b step at f32
# compute against the CPU from the same weights and batch (the f32 bounds
# of tests/test_torch_train_grads.py and tests/test_torch_train.py: each
# gradient and m within 1e-5 of its leaf's largest |value|, v (quadratic
# in the gradient) within 2e-5, the loss and grad_norm within 1e-5
# relative, params within 1e-5 wherever the gradient is at least 1e-3 of
# its leaf's largest and within one AdamW step elsewhere), and the card's
# elastic resume bit-exact under deterministic algorithms
def _train_batch(vocab, i, dev):
    rng = np.random.default_rng(5000 + i)
    t = rng.integers(0, vocab, (4, 65))
    return {"tokens": torch.as_tensor(t[:, :-1], device=dev),
            "labels": torch.as_tensor(t[:, 1:], device=dev),
            "loss_mask": torch.ones((4, 64), device=dev)}


def _share(got, want) -> float:
    want = want.float().cpu()
    err = (got.float().cpu() - want).abs().max()
    return float(err / want.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
def test_cuda_lm_train_step_matches_cpu(cuda, tmp_path, monkeypatch):
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params, tree_leaves, tree_map
    from repro_torch.train import (ElasticTrainer, OptConfig, make_train_step,
                                   opt_init)
    from repro_torch.train.step import make_grad_fn
    cpu = torch.device("cpu")
    base = reduced_config("qwen1_5_4b")
    cfg = dataclasses.replace(base, compute_dtype="float32")
    host = init_params(T.param_specs(cfg), torch.Generator().manual_seed(0),
                       cpu)
    card = tree_map(lambda t: t.to(cuda, copy=True), host)

    loss_c, g_c = make_grad_fn(cfg)(card, _train_batch(cfg.vocab, 0, cuda))
    loss_h, g_h = make_grad_fn(cfg)(host, _train_batch(cfg.vocab, 0, cpu))
    assert abs(float(loss_c) - float(loss_h)) <= 1e-5 * abs(float(loss_h))
    g_c, g_h = tree_leaves(g_c), tree_leaves(g_h)
    for a, b in zip(g_c, g_h):
        assert _share(a, b) <= 1e-5

    oc = OptConfig(lr=1e-3, warmup_steps=1, decay_steps=100)
    p0 = tree_map(torch.clone, host)
    out = {}
    for tag, dev, params in (("card", cuda, card), ("host", cpu, host)):
        out[tag] = make_train_step(cfg, oc)(
            params, opt_init(params, oc), _train_batch(cfg.vocab, 0, dev))
    (pc, sc, mc), (ph, sh, mh) = out["card"], out["host"]
    for k in ("loss", "grad_norm"):
        assert abs(float(mc[k]) - float(mh[k])) <= 1e-5 * abs(float(mh[k]))
    lr = float(mh["lr"])
    for a, b, g, p in zip(tree_leaves(pc), tree_leaves(ph), g_h,
                          tree_leaves(p0)):
        err = (a.cpu() - b).abs()
        held = g.abs() >= 1e-3 * g.abs().max()
        assert bool((err[held] <= 1e-5 * b.abs().max()).all())
        assert bool((err <= 2 * lr * (1 + 0.1 * p.abs()) + 1e-7).all())
    for a, b in zip(tree_leaves(sc.m), tree_leaves(sh.m)):
        assert _share(a, b) <= 1e-5
    for a, b in zip(tree_leaves(sc.v), tree_leaves(sh.v)):
        assert _share(a, b) <= 2e-5

    # elastic resume on the card, bf16 compute as the reference's test
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        step = make_train_step(base, oc)

        def trainer(d, every):
            params = tree_map(lambda t: t.to(cuda, copy=True), host)
            return ElasticTrainer(
                step, params, opt_init(params, oc),
                lambda i: _train_batch(base.vocab, i, cuda), str(d),
                ckpt_every=every, async_save=False)

        tr = trainer(tmp_path / "run", 4)
        with pytest.raises(RuntimeError, match="injected failure at step 6"):
            tr.run(10, fail_at=6)
        tr2 = trainer(tmp_path / "run", 4)
        assert tr2.maybe_resume() and tr2.step == 4
        tr2.run(10)
        ref = trainer(tmp_path / "ref", 100)
        ref.run(10)
        for a, b in zip(tree_leaves(tr2.params), tree_leaves(ref.params)):
            assert torch.equal(a, b)
    finally:
        torch.use_deterministic_algorithms(before)
