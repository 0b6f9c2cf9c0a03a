"""The DedupBackend contract battery of tests/test_contract.py, run on the
PyTorch port's registry (`repro_torch.index.available()`: "brute", "dpk",
"flat_lsh", "hnsw", "hnsw_raw", "hnsw_sharded" and "prefix_filter", every
reference key) on the CPU, driven by the capability flags each backend
declares, and once more on "hnsw_sharded" at 4 shards (the port stacks
its shards on one device; the reference's battery runs that key at its
device count). The port's backends take `device="cpu"`; the battery is
otherwise the reference's, assertion for assertion."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.dedup import FoldConfig
from repro_torch.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro_torch.index import available
from repro_torch.index import make_pipeline as _make_pipeline

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)


def make_pipeline(key, cfg):
    """`key`, or `key@N` for N shards."""
    key, _, shards = key.partition("@")
    opts = {"shards": int(shards)} if shards else {}
    return _make_pipeline(key, cfg, device="cpu", **opts)

TAU = 0.7
CFG = FoldConfig(capacity=256, M=8, M0=16, ef_construction=32, ef_search=32,
                 tau=TAU, threshold_space="minhash")

KEYS = sorted(available()) + ["hnsw_sharded@4"]

# hnsw_raw verifies in the low-recall minhash_jaccard space — a
# deliberately imperfect paper baseline. Its replay/reinsert guarantees
# are ONE-SIDED: a deleted or unseen doc is never falsely claimed a
# duplicate, but recall misses may readmit docs the index already holds.
# The battery degrades exact-equality assertions to that one-sided form
# for backends listed here (state round-trips stay exact regardless).
ONE_SIDED = {"hnsw_raw"}


def _batch(n=64, seed=0, dataset="lm1b"):
    src = SyntheticCorpus(dataclasses.replace(DATASET_PRESETS[dataset],
                                              seed=seed))
    return src.next_batch(n)[:2]


def _slots(pipe):
    logs = pipe.backend.pop_slot_log()
    return np.concatenate(logs) if logs else np.empty(0, np.int64)


def _keep(pipe, batch):
    return np.asarray(pipe.process_batch(*batch)[0])


# ---------------------------------------------------- verdicts + replay
@pytest.mark.parametrize("key", KEYS)
def test_port_verdict_sanity_and_exact_replay(key):
    """Insert/search floor every backend must clear: verdicts are a (B,)
    bool mask, claimed admissions equal realized inserts (n_overflow 0),
    and resubmitting the identical batch is all-duplicate."""
    pipe = make_pipeline(key, cfg=CFG)
    b = _batch(48, seed=3)
    keep, stats = pipe.process_batch(*b)
    keep = np.asarray(keep)
    assert keep.shape == (48,) and keep.dtype == bool
    assert 0 < int(keep.sum()) == pipe.inserted
    assert stats["n_overflow"] == 0
    replay = int(_keep(pipe, b).sum())
    assert replay <= int(keep.sum()) if key in ONE_SIDED else replay == 0


# ------------------------------------------------- overflow + grow()
@pytest.mark.parametrize("key", KEYS)
def test_port_overflow_never_silently_drops_and_grow_roundtrip(key):
    """OVERFLOW CONTRACT: at capacity a backend either refuses the batch
    (RuntimeError with a grow() hint, nothing mutated) or absorbs it —
    it must never return verdicts claiming admission for docs the index
    cannot see. After a refusal, grow() makes the same batch land."""
    pipe = make_pipeline(key, cfg=dataclasses.replace(CFG, capacity=48))
    claimed, refused, pending = 0, False, None
    seed = 0
    # unique-heavy stream until well past capacity (or the backend refuses)
    while seed * 64 <= pipe.capacity + 128:
        b = _batch(64, seed=seed)
        seed += 1
        try:
            claimed += int(_keep(pipe, b).sum())
        except RuntimeError as e:
            refused, pending = True, b
            assert "grow" in str(e) or "full" in str(e)
            break
    # the verdicts returned so far must all be realized in the index
    assert pipe.inserted == claimed
    if refused:
        assert pipe.backend.supports_growth, \
            f"{key} refused at capacity but cannot grow"
        pipe.grow(4 * pipe.capacity)
        got = int(_keep(pipe, pending).sum())
        assert got > 0 and pipe.inserted == claimed + got


# ------------------------------------------------------------ snapshots
@pytest.mark.parametrize("key", KEYS)
def test_port_snapshot_roundtrip_or_refusal(key, tmp_path):
    """supports_snapshots backends: restore of an empty dir raises
    FileNotFoundError naming the dir; save -> restore into a fresh
    pipeline reproduces occupancy and verdicts exactly (replay of the
    saved stream is all-duplicate, the next batch verdict-identical)."""
    pipe = make_pipeline(key, cfg=CFG)
    if not pipe.backend.supports_snapshots:
        with pytest.raises((NotImplementedError, RuntimeError)):
            pipe.save(str(tmp_path), 1)
        return
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        pipe.restore(str(tmp_path / "nothing_here"))
    b1, b2 = _batch(48, seed=5), _batch(48, seed=6)
    pipe.process_batch(*b1)
    pipe.save(str(tmp_path), step=1)
    fresh = make_pipeline(key, cfg=CFG)
    assert fresh.restore(str(tmp_path)) == 1
    assert fresh.inserted == pipe.inserted
    # restored state is exact, so verdicts match the donor even for the
    # low-recall backends; the all-duplicate replay is two-sided only
    assert np.array_equal(_keep(fresh, b2), _keep(pipe, b2))
    if key not in ONE_SIDED:
        assert _keep(fresh, b1).sum() == 0


@pytest.mark.parametrize("key", KEYS)
def test_port_restore_adopts_larger_capacity_then_grows(key, tmp_path):
    """A snapshot taken at one capacity restores into a pipeline built
    with a LARGER configured capacity: the restored index adopts the
    bigger geometry (capacity grown back up) with verdicts intact."""
    pipe = make_pipeline(key, cfg=CFG)
    if not pipe.backend.supports_snapshots:
        pytest.skip(f"{key}: supports_snapshots=False")
    b1, b2 = _batch(48, seed=7), _batch(48, seed=8)
    pipe.process_batch(*b1)
    pipe.save(str(tmp_path), step=3)
    big = make_pipeline(key, cfg=dataclasses.replace(CFG, capacity=1024))
    want_cap = big.capacity                 # total, >= snapshot's
    assert big.restore(str(tmp_path)) == 3
    assert big.capacity >= want_cap
    assert big.inserted == pipe.inserted
    assert np.array_equal(_keep(big, b2), _keep(pipe, b2))
    if key not in ONE_SIDED:
        assert _keep(big, b1).sum() == 0


# ------------------------------------------------------------- deletion
@pytest.mark.parametrize("key", KEYS)
def test_port_deletion_contract_or_clear_refusal(key):
    """supports_deletion backends: delete(slots) is idempotent, drops
    `inserted` to live count, and resubmitting the original batch
    readmits exactly the killed docs (live docs stay duplicates).
    Backends without the flag must raise NotImplementedError naming it,
    with the read-side surface at pristine defaults."""
    pipe = make_pipeline(key, cfg=CFG)
    be = pipe.backend
    if not be.supports_deletion:
        with pytest.raises(NotImplementedError, match="supports_deletion"):
            pipe.delete(np.array([0]))
        assert pipe.deleted == 0 and pipe.dead_fraction == 0.0
        assert pipe.compact() == {"reclaimed": 0}
        return
    be.track_slots = True
    b = _batch(64, seed=1)
    keep1 = _keep(pipe, b)
    slots = _slots(pipe)
    n0 = pipe.inserted
    assert len(slots) == int(keep1.sum()) == n0 > 0
    if key not in ONE_SIDED:       # replay mutates nothing when two-sided
        assert _keep(pipe, b).sum() == 0
    kill = slots[::2]
    assert pipe.delete(kill) == len(kill)
    assert pipe.delete(kill) == 0                  # idempotent
    assert pipe.deleted == len(kill)
    assert pipe.inserted == n0 - len(kill)         # live docs only
    keep3 = _keep(pipe, b)
    assert keep3[np.flatnonzero(keep1)[::2]].all()     # killed docs readmit
    if key not in ONE_SIDED:                           # ...and ONLY them
        expect = np.zeros_like(keep3)
        expect[np.flatnonzero(keep1)[::2]] = True
        assert np.array_equal(keep3, expect)
        assert pipe.inserted == n0


@pytest.mark.parametrize("key", KEYS)
def test_port_compact_invariants(key):
    """compact() on a tombstoned index: dead_fraction returns to 0, live
    count and live verdicts are untouched, and the index keeps accepting
    inserts (reclaimed slots reusable)."""
    pipe = make_pipeline(key, cfg=CFG)
    be = pipe.backend
    if not be.supports_deletion:
        pytest.skip(f"{key}: supports_deletion=False")
    be.track_slots = True
    b = _batch(64, seed=2)
    pipe.process_batch(*b)
    slots = _slots(pipe)
    n0 = pipe.inserted
    killed = int(pipe.delete(slots[1::2]))
    assert 0.0 <= pipe.dead_fraction <= 1.0
    out = pipe.compact()
    assert out["reclaimed"] >= 0
    assert pipe.dead_fraction == 0.0
    assert pipe.inserted == n0 - killed
    live = pipe.inserted
    keep = _keep(pipe, b)                # killed docs readmit, live stay dup
    got = int(keep.sum())
    assert got == killed if key not in ONE_SIDED else got >= killed
    assert pipe.inserted == live + got


# -------------------------------------------------- honest capability flags
@pytest.mark.parametrize("key", KEYS)
def test_port_undeclared_capabilities_refuse_loudly(key):
    """A backend that declares a capability False must refuse the call
    with an exception (never a silent no-op the serving layer would
    misread as success)."""
    pipe = make_pipeline(key, cfg=CFG)
    be = pipe.backend
    if not be.supports_growth:
        with pytest.raises((NotImplementedError, RuntimeError)):
            pipe.grow(2 * pipe.capacity)
    if not be.supports_deletion:
        with pytest.raises(NotImplementedError, match="supports_deletion"):
            pipe.delete(np.array([0]))
