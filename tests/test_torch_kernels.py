"""The port's plain kernel versions held against the JAX Pallas kernels (in
interpret mode) and against `repro.kernels.ref`, over the shape sweeps of
tests/test_kernels.py, and the dispatch rules of `repro_torch.kernels.ops`.
The CUDA kernels themselves are tested in tests/test_torch_cuda.py.

All outputs must match exactly: u32 bit for bit, f32 with
assert_array_equal (the formulas are the same, every Jaccard division is
IEEE-rounded on both sides, and Hamming rounds once as the reference's
jitted fma(-px, 1/(32 W), 1)). The one stated split: the reference's eager
`ref.hamming_ref` divides as IEEE, within 1 ulp of that."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import bitmap as jbm
from repro.core.hashing import hash_seeds as j_hash_seeds
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _lib, ops, ref
from repro_torch.kernels.bitmap_jaccard import bitmap_jaccard_matrix, hamming_matrix
from repro_torch.kernels.minhash import minhash_kernel_signatures

# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores the parallel test workers share
torch.set_num_threads(1)

JACCARD_SHAPES = [(1, 1, 4), (8, 128, 128), (13, 201, 128), (5, 7, 64),
                  (128, 256, 32), (3, 130, 16), (33, 65, 129)]
HAMMING_SHAPES = [(8, 128, 128), (9, 33, 16), (1, 1, 4)]
MINHASH_SHAPES = [(1, 4, 7), (5, 300, 112), (16, 128, 128), (9, 513, 64),
                  (2, 16, 1)]
# padding inside rows and rows with a single valid shingle (b, l, h, layout)
MINHASH_PADDED = [(4, 64, 112, "alternating"), (5, 300, 31, "middle"),
                  (6, 40, 8, "single"), (7, 600, 112, "mixed")]
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
    any other layout applies to every row. Padding anywhere in a row is
    masked exactly as at its end."""
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


@pytest.mark.parametrize("q,n,w", JACCARD_SHAPES)
@pytest.mark.parametrize("cached", [True, False])
def test_bitmap_jaccard_plain_matches_pallas_and_ref(q, n, w, cached):
    rng = np.random.default_rng(q * 1000 + n + w)
    qs, db = words(rng, (q, w)), words(rng, (n, w))
    pallas = np.asarray(jops.bitmap_jaccard(jnp.asarray(qs), jnp.asarray(db),
                                            cached=cached, interpret=True))
    jplain = np.asarray(jref.bitmap_jaccard_ref(jnp.asarray(qs), jnp.asarray(db)))
    got = ops.bitmap_jaccard(to_t(qs), to_t(db), cached=cached)
    assert got.dtype == torch.float32 and got.shape == (q, n)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), jplain)
    np.testing.assert_array_equal(
        ops.bitmap_jaccard(to_t(qs), to_t(db), cached=cached,
                           use_kernel=False).numpy(), jplain)


def test_bitmap_jaccard_sparse_and_empty():
    qs = torch.zeros((4, 16), dtype=torch.int32)
    db = torch.zeros((6, 16), dtype=torch.int32)
    assert (ops.bitmap_jaccard(qs, db) == 1.0).all()
    a = torch.tensor([[0b1010, 0, 0, 0]], dtype=torch.int32)
    b = torch.tensor([[0b0101, 0, 0, 0]], dtype=torch.int32)
    assert ops.bitmap_jaccard(a, a)[0, 0] == 1.0
    assert ops.bitmap_jaccard(a, b)[0, 0] == 0.0


@pytest.mark.parametrize("q,n,w", HAMMING_SHAPES)
def test_hamming_plain_matches_pallas_and_ref(q, n, w):
    rng = np.random.default_rng(q + n * 7 + w)
    qs, db = words(rng, (q, w)), words(rng, (n, w))
    pallas = np.asarray(jops.hamming(jnp.asarray(qs), jnp.asarray(db),
                                     interpret=True))
    jplain = np.asarray(jref.hamming_ref(jnp.asarray(qs), jnp.asarray(db)))
    got = ops.hamming(to_t(qs), to_t(db)).numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, jplain)


@pytest.mark.parametrize("q,n,w", [(33, 65, 129), (31, 70, 5)])
def test_hamming_plain_off_power_of_two_words(q, n, w):
    """With 32 W not a power of two, px / (32 W) rounds. The port rounds
    once as fma(-px, f32(1 / (32 W)), 1) (kernel and plain version alike),
    as the reference's jitted paths do (the Pallas kernel among them: XLA
    rewrites the division by a constant); the reference's eager plain
    version divides as IEEE, which may differ by one ulp."""
    rng = np.random.default_rng(q + n * 7 + w)
    qs, db = words(rng, (q, w)), words(rng, (n, w))
    got = ops.hamming(to_t(qs), to_t(db)).numpy()
    pallas = np.asarray(jops.hamming(jnp.asarray(qs), jnp.asarray(db),
                                     interpret=True))
    np.testing.assert_array_equal(got.view(np.uint32), pallas.view(np.uint32))
    eager = np.asarray(jref.hamming_ref(jnp.asarray(qs), jnp.asarray(db)))
    np.testing.assert_array_max_ulp(got, eager, maxulp=1)


@pytest.mark.parametrize("w", [5, 16, 112, 128, 129])
def test_hamming_from_px_rounds_as_jit(w):
    """Every distance px in [0, 32 W]: the helper equals the reference's
    jitted `1 - px / (32 W)` bit for bit."""
    bits = 32 * w
    px = np.arange(bits + 1, dtype=np.int32)
    jit = np.asarray(jax.jit(
        lambda p: 1.0 - p.astype(jnp.float32) / jnp.float32(bits))(px))
    got = ref.hamming_from_px(torch.from_numpy(px), bits).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), jit.view(np.uint32))
    if bits & (bits - 1):                # the IEEE quotient rounds elsewhere
        ieee = np.float32(1) - px.astype(np.float32) / np.float32(bits)
        assert (ieee != jit).any()


@pytest.mark.parametrize("w", [5, 16, 112, 128, 129])
def test_ops_hamming_matches_jitted_reference(w):
    """ops.hamming (the CPU tensor takes the plain version) and its
    use_kernel=False arm equal the reference's jitted pairwise_hamming and
    its Pallas kernel bit for bit."""
    rng = np.random.default_rng(w)
    qs, db = words(rng, (9, w)), words(rng, (40, w))
    jit = np.asarray(jbm.pairwise_hamming(jnp.asarray(qs), jnp.asarray(db)))
    pallas = np.asarray(jops.hamming(jnp.asarray(qs), jnp.asarray(db),
                                     interpret=True))
    np.testing.assert_array_equal(pallas.view(np.uint32), jit.view(np.uint32))
    for use_kernel in (True, False):
        got = ops.hamming(to_t(qs), to_t(db), use_kernel=use_kernel).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), jit.view(np.uint32))


@pytest.mark.parametrize("b,l,h,pad", MINHASH_CASES)
def test_minhash_plain_matches_pallas_and_ref(b, l, h, pad):
    rng = np.random.default_rng(b * 100 + l + h)
    sh = place_padding(words(rng, (b, l)), pad, rng)
    seeds = np.asarray(j_hash_seeds(h))
    pallas = np.asarray(jops.minhash(jnp.asarray(sh), jnp.asarray(seeds),
                                     interpret=True))
    jplain = np.asarray(jref.minhash_ref(jnp.asarray(sh), jnp.asarray(seeds)))
    got = ops.minhash(to_t(sh), to_t(seeds))
    assert got.dtype == torch.int32 and got.shape == (b, h)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), pallas)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), jplain)


def test_minhash_all_padded_row():
    sh = torch.full((3, 32), -1, dtype=torch.int32)
    seeds = to_t(np.asarray(j_hash_seeds(8)))
    assert (ops.minhash(sh, seeds) == -1).all()     # 0xFFFFFFFF sentinel


@pytest.mark.parametrize("bad", ["dtype", "rank", "contiguity", "device"])
def test_wrappers_refuse_bad_inputs(bad):
    qs = torch.zeros((4, 8), dtype=torch.int32)
    if bad == "dtype":
        qs = qs.to(torch.int64)
    elif bad == "rank":
        qs = qs[None]
    elif bad == "contiguity":
        qs = torch.zeros((8, 4), dtype=torch.int32).T
    elif bad == "device":
        qs = qs.to("meta")       # neither CPU nor CUDA: no plain fallback
    with pytest.raises((TypeError, ValueError)):
        if bad == "device":
            hamming_matrix(qs, qs)
        else:
            bitmap_jaccard_matrix(qs, qs)
    with pytest.raises((TypeError, ValueError)):
        minhash_kernel_signatures(qs, torch.zeros(3, dtype=torch.int32))


def test_cpu_tensors_launch_nothing():
    _lib.reset_launches()
    x = torch.zeros((3, 4), dtype=torch.int32)
    ops.bitmap_jaccard(x, x)
    ops.bitmap_jaccard(x, x, cached=False)
    ops.hamming(x, x)
    ops.minhash(x, torch.zeros(2, dtype=torch.int32))
    assert all(v == 0 for v in _lib.LAUNCHES.values())
