"""Step ① of the PyTorch port held bit-exact against the JAX package:
seeds, shingles, MinHash, bitmaps and popcounts, and fold_signatures on
every corpus preset (short docs and all-padding rows included)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import bitmap as jbm
from repro.core import dedup as jdedup
from repro.core.hashing import hash_seeds as j_hash_seeds
from repro.core.minhash import minhash_from_shingles as j_minhash
from repro.core.shingle import shingle_hashes as j_shingles
from repro.data.corpus import DATASET_PRESETS, SyntheticCorpus
from repro_torch.core import bitmap as tbm
from repro_torch.core import dedup as tdedup
from repro_torch.core.hashing import hash_seeds as t_hash_seeds
from repro_torch.core.minhash import minhash_from_shingles as t_minhash
from repro_torch.core.shingle import shingle_hashes as t_shingles

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)


def to_t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> int32-bit torch (the port's representation)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _docs(rng, B=9, L=40, vocab=2**32):
    tokens = rng.integers(0, vocab, (B, L), dtype=np.uint64).astype(np.uint32)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[0] = 0          # all-padding row: keeps 0xFFFFFFFF
    lengths[1] = 3          # shorter than shingle_n
    lengths[2] = L
    return tokens, lengths


@pytest.mark.parametrize("num,base", [(1, 0), (112, 0x5EED), (300, 7),
                                      (16, 2**32 - 1)])
def test_hash_seeds_bit_exact(num, base):
    np.testing.assert_array_equal(u32(t_hash_seeds(num, base, device="cpu")),
                                  np.asarray(j_hash_seeds(num, base)))


@pytest.mark.parametrize("n", [1, 3, 5, 9])
def test_shingle_hashes_bit_exact(n):
    tokens, lengths = _docs(np.random.default_rng(n))
    exp = np.asarray(j_shingles(jnp.asarray(tokens), jnp.asarray(lengths), n))
    got = u32(t_shingles(to_t(tokens), torch.from_numpy(lengths), n))
    np.testing.assert_array_equal(got, exp)
    assert (got[0] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("h", [1, 7, 112])
def test_minhash_from_shingles_bit_exact(h):
    tokens, lengths = _docs(np.random.default_rng(h), B=11, L=64)
    sh = np.asarray(j_shingles(jnp.asarray(tokens), jnp.asarray(lengths), 5))
    seeds = np.asarray(j_hash_seeds(h))
    exp = np.asarray(j_minhash(jnp.asarray(sh), jnp.asarray(seeds)))
    got = u32(t_minhash(to_t(sh), to_t(seeds)))
    np.testing.assert_array_equal(got, exp)
    assert (got[0] == 0xFFFFFFFF).all()     # empty doc keeps the sentinel


@pytest.mark.parametrize("T", [32, 1024, 4096])
def test_pack_bitmaps_and_popcount_bit_exact(T):
    rng = np.random.default_rng(T)
    sigs = rng.integers(0, 2**32, (17, 112), dtype=np.uint64).astype(np.uint32)
    sigs[3] = 0xFFFFFFFF                     # unsigned `% T` on the sentinel
    sigs[4, :56] = sigs[4, 56:]              # colliding lanes
    exp = np.asarray(jbm.pack_bitmaps(jnp.asarray(sigs), T=T))
    got = tbm.pack_bitmaps(to_t(sigs), T=T)
    np.testing.assert_array_equal(u32(got), exp)
    np.testing.assert_array_equal(tbm.popcount(got).numpy(),
                                  np.asarray(jbm.popcount(jnp.asarray(exp))))


def test_pairwise_similarities_match():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2**32, (7, 16), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (11, 16), dtype=np.uint64).astype(np.uint32)
    a[0] = 0
    b[0] = 0                                  # empty vs empty -> 1.0
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = to_t(a), to_t(b)
    pairs = [
        (jbm.pairwise_bitmap_jaccard(ja, jb), tbm.pairwise_bitmap_jaccard(ta, tb)),
        (jbm.chunked_pairwise_bitmap_jaccard(ja, jb, row_chunk=4, col_chunk=3),
         tbm.chunked_pairwise_bitmap_jaccard(ta, tb, row_chunk=4, col_chunk=3)),
        (jbm.pairwise_hamming(ja, jb), tbm.pairwise_hamming(ta, tb)),
        (jbm.pairwise_minhash_jaccard(ja, jb), tbm.pairwise_minhash_jaccard(ta, tb)),
        (jbm.bitmap_jaccard_sim(ja, ja[::-1]), tbm.bitmap_jaccard_sim(ta, ta.flip(0))),
        (jbm.hamming_sim(ja, ja[::-1]), tbm.hamming_sim(ta, ta.flip(0))),
        (jbm.minhash_jaccard_sim(ja, ja[::-1]), tbm.minhash_jaccard_sim(ta, ta.flip(0))),
    ]
    for exp, got in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


@pytest.mark.parametrize("w", [5, 16, 112, 128, 129])
def test_hamming_rounds_as_jitted_reference(w):
    """pairwise_hamming and hamming_sim equal the reference's jitted
    versions bit for bit, also where 32 W is not a power of two (W = 112
    is the raw backend's 112 MinHash lanes): one rounding of
    fma(-px, f32(1 / (32 W)), 1), as XLA computes a division by a
    constant."""
    rng = np.random.default_rng(w)
    a = rng.integers(0, 2**32, (13, w), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (21, w), dtype=np.uint64).astype(np.uint32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = to_t(a), to_t(b)
    pairs = [
        (jbm.pairwise_hamming(ja, jb), tbm.pairwise_hamming(ta, tb)),
        (jax.jit(jbm.hamming_sim)(ja, jb[:13]), tbm.hamming_sim(ta, tb[:13])),
    ]
    for exp, got in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(exp).view(np.uint32))


@pytest.mark.parametrize("preset", sorted(DATASET_PRESETS))
def test_fold_signatures_bit_exact_on_every_preset(preset):
    tokens, lengths, _ = SyntheticCorpus(DATASET_PRESETS[preset]).next_batch(24)
    lengths[0] = 0                            # all-padding row
    lengths[1] = 2                            # shorter than shingle_n
    jcfg = jdedup.FoldConfig(use_kernel=False)
    tcfg = tdedup.FoldConfig()
    jsig, jbmp, jpcs = jdedup.fold_signatures(
        jcfg, j_hash_seeds(jcfg.num_hashes), tokens, lengths)
    tsig, tbmp, tpcs = tdedup.fold_signatures(
        tcfg, t_hash_seeds(tcfg.num_hashes, device="cpu"), to_t(tokens),
        torch.from_numpy(lengths))
    np.testing.assert_array_equal(u32(tsig), np.asarray(jsig))
    np.testing.assert_array_equal(u32(tbmp), np.asarray(jbmp))
    np.testing.assert_array_equal(tpcs.numpy(), np.asarray(jpcs))
    assert (u32(tsig)[0] == 0xFFFFFFFF).all()



def _lane_count_pairs(h, rng):
    """a (1, h) and b (h+1, h): row i of b equals a in exactly i lanes, at
    shuffled positions, so every lane count 0..h occurs once."""
    a = rng.integers(0, 2**32, (1, h), dtype=np.uint64).astype(np.uint32)
    b = np.repeat(a, h + 1, axis=0) ^ np.uint32(1)
    for i in range(h + 1):
        lanes = rng.permutation(h)[:i]
        b[i, lanes] = a[0, lanes]
    return a, b


@pytest.mark.parametrize("h", [7, 31, 112, 128])
def test_minhash_jaccard_rounds_as_reference_at_every_count(h):
    """pairwise_minhash_jaccard and minhash_jaccard_sim equal the
    reference's jitted (and eager) jnp.mean bit for bit at every lane
    count 0..H: count * f32(1/H), one rounding. At H = 112 an IEEE
    division count / H differs at 62 of the 113 counts."""
    a, b = _lane_count_pairs(h, np.random.default_rng(h))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = to_t(a), to_t(b)
    a_rows = np.repeat(a, h + 1, axis=0)
    exp = np.asarray(jax.jit(jbm.pairwise_minhash_jaccard)(ja, jb))
    np.testing.assert_array_equal(
        exp, np.asarray(jbm.pairwise_minhash_jaccard(ja, jb)))
    pairs = [
        (exp, tbm.pairwise_minhash_jaccard(ta, tb)),
        (np.asarray(jax.jit(jbm.pairwise_minhash_jaccard)(jb, ja)),
         tbm.pairwise_minhash_jaccard(tb, ta)),
        (np.asarray(jax.jit(jbm.minhash_jaccard_sim)(jnp.asarray(a_rows), jb)),
         tbm.minhash_jaccard_sim(to_t(a_rows), tb)),
    ]
    for e, got in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(e).view(np.uint32))
    counts = np.arange(h + 1, dtype=np.float32)
    np.testing.assert_array_equal(
        exp[0], counts * (np.float32(1) / np.float32(h)))


@pytest.mark.parametrize("h", [7, 31, 112, 128])
def test_verify_minhash_rescoring_rounds_as_reference(h):
    """The exact-verify rescoring of the hnsw backend rounds as the
    reference's: numpy's float64 mean of the lane agreement, cast to f32
    (not the jnp.mean rounding of pairwise_minhash_jaccard)."""
    from repro_torch.index.backends.hnsw import _lane_fraction_f64
    a, b = _lane_count_pairs(h, np.random.default_rng(h + 1))
    cand = b[None]                                     # (1, h+1, h)
    exp = jnp.asarray((a[:, None, :] == cand).mean(-1), jnp.float32)
    got = _lane_fraction_f64(to_t(a)[:, None, :] == to_t(cand))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(exp).view(np.uint32))
