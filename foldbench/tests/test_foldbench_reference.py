"""The plain reference against the program on the CPU: signatures bit for
bit, both similarity formulas bit for bit, and the exact pipeline's
verdicts equal to the `hnsw` pipeline's where its search is exhaustive
(fewer admitted documents than ef, so the beam visits every node)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from foldbench.reference import exact
from foldbench.reference.signatures import signatures
from foldbench.traffic.generate import Stream, load_mix, pad

PREFILL = {"docs": 48, "batch_docs": 16, "seed": 3}


def _unpack(words: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T/32) int32 words -> (B, T) float32 0/1, bit b of word w at
    position 32 w + b."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64)
    return ((w[:, :, None] >> shifts) & 1).reshape(w.shape[0], T).float()


def _pipe(capacity=256):
    from repro_torch.core.dedup import FoldConfig, FoldPipeline
    return FoldPipeline(FoldConfig(capacity=capacity), device="cpu")


def _ref(tokens, lengths, cfg):
    return signatures(tokens, lengths, num_hashes=cfg.num_hashes,
                      shingle_n=cfg.shingle_n, T=cfg.T, seed=cfg.seed,
                      device="cpu")


@pytest.mark.parametrize("mix", ["cc-ingest", "rn-open"])
def test_signatures_equal_the_programs(mix):
    pipe = _pipe()
    tokens, lengths = pad(Stream(load_mix(mix), PREFILL, 1).docs(24))
    lengths[3] = 2                 # shorter than a shingle
    sig = pipe.signatures(tokens, lengths)
    bits, pcs = _ref(tokens, lengths, pipe.cfg)
    assert torch.equal(bits, _unpack(sig.bitmaps, pipe.cfg.T))
    assert torch.equal(pcs, sig.pcs.to(torch.int64))


def test_similarities_equal_the_programs():
    from repro_torch.core.hnsw import _bitmap_dist
    from repro_torch.core.hashing import popc
    pipe = _pipe()
    tokens, lengths = pad(Stream(load_mix("cc-recrawl"), PREFILL, 2).docs(32))
    sig = pipe.signatures(tokens, lengths)
    bits, pcs = _ref(tokens, lengths, pipe.cfg)
    assert torch.equal(exact.batch_sims(bits, pcs, bits, pcs),
                       pipe.backend.batch_sim(sig))
    px = popc(sig.bitmaps[:, None, :] ^ sig.bitmaps[None, :, :]).sum(-1)
    want = 1.0 - _bitmap_dist(px, sig.pcs[:, None], sig.pcs[None, :])
    assert torch.equal(exact.index_sims(bits, pcs, bits, pcs), want)


@pytest.mark.parametrize("mix", ["cc-ingest", "cc-recrawl"])
def test_exact_pipeline_equals_exhaustive_hnsw(mix):
    pipe = _pipe()
    stream = Stream(load_mix(mix), PREFILL, 4)
    batches, keeps, admitted = [], [], []
    for _ in range(4):
        tokens, lengths = pad(stream.docs(16))
        keep, _ = pipe.process_batch(tokens, lengths)
        bits, pcs = _ref(tokens, lengths, pipe.cfg)
        batches.append((bits, pcs))
        keeps.append(keep)
        admitted += [(bits[i], pcs[i]) for i in np.flatnonzero(keep)]
    assert len(admitted) <= pipe.cfg.ef_search
    want, _ = exact.exact_pipeline(batches, pipe.cfg.tau)
    assert [k.tolist() for k in keeps] == [k.tolist() for k in want]
    assert sum(int((~k).sum()) for k in keeps) > 0
    judged = exact.judge(batches, keeps, 1, pipe.cfg.tau)
    assert judged["recall"] == 1.0 and judged["unjustified"] == 0
    # the index search's similarities to the slots it returns, slot j
    # holding the j-th admitted document
    tokens, lengths = pad(stream.docs(16))
    ids, sims = pipe.backend.search(pipe.signatures(tokens, lengths))
    q, qp = _ref(tokens, lengths, pipe.cfg)
    held = torch.stack([b for b, _ in admitted])
    hp = torch.stack([p for _, p in admitted])
    all_sims = exact.index_sims(q, qp, held, hp)
    for r in range(ids.shape[0]):
        for j, s in zip(ids[r].tolist(), sims[r].tolist()):
            if j >= 0:
                assert all_sims[r, j].item() == s
        assert sims[r, 0].item() == all_sims[r].max().item()


def test_control_lanes_differ_from_the_configured_ones():
    tokens, lengths = pad(Stream(load_mix("cc-ingest"), PREFILL, 5).docs(8))
    full = signatures(tokens, lengths, num_hashes=112, shingle_n=5, T=4096,
                      seed=0, device="cpu")
    low = signatures(tokens, lengths, num_hashes=112, shingle_n=5, T=4096,
                     seed=0, device="cpu", lane_bits=16)
    assert not torch.equal(full[0], low[0])
    assert torch.all(low[1] > 0)
