"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: without a card every test skips with a reason (decided at
run time, in a fixture). The file imports no JAX, so it runs on a machine
with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.hashing import hash_seeds
from repro_torch.kernels import _lib, ops, ref
from repro_torch.kernels.bitmap_jaccard import bitmap_jaccard_matrix, hamming_matrix
from repro_torch.kernels.minhash import minhash_kernel_signatures

JACCARD_SHAPES = [(1, 1, 4), (8, 128, 128), (13, 201, 128), (5, 7, 64),
                  (128, 256, 32), (3, 130, 16), (512, 512, 128)]
MINHASH_SHAPES = [(1, 4, 7), (5, 300, 112), (16, 128, 128), (9, 513, 64),
                  (2, 16, 1), (512, 384, 112)]


def to_t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def words(rng, shape) -> np.ndarray:
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


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
@pytest.mark.parametrize("b,l,h", MINHASH_SHAPES)
def test_cuda_minhash_kernel_equals_plain(cuda, b, l, h):
    rng = np.random.default_rng(b + l + h)
    sh = words(rng, (b, l))
    sh[0, l // 2:] = 0xFFFFFFFF
    sh_t = to_t(sh).to(cuda)
    seeds = hash_seeds(h, device=cuda)
    got = minhash_kernel_signatures(sh_t, seeds)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.minhash_ref(sh_t, seeds))


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
    torch.cuda.synchronize()
