"""The retention window's reference: the exact online pipeline of
`exact.py`, where the index a batch is searched against holds only what
the W batches before it admitted (W is the configuration's
`lifecycle["ttl_batches"]`), and the live count the program's index should
end with is what the last W batches admitted.

It runs at a cell's own size: about 930 batches against a window of about
118k admitted rows. The window is held on the device as one ring of W
blocks of rows (the bitmaps as 0/1 float32 rows, their popcounts and a
validity mask): batch i is searched against the whole ring in a few
blocked matrix products, then its admitted rows overwrite the block of
batch i - W. Counts are exact (TF32 off, integer counts far below 2**24)
and the similarities are `exact.py`'s float32 formulas. It imports nothing
of the program.

`compare` judges the program's verdicts as `exact.judge` does, each batch
held against what the program admitted in the W batches before it;
`index_gap` is the program's live count against what its last W batches
admitted. The control is the same windowed pipeline on 16-bit MinHash
lanes, as `exact`'s is; `truth` is the windowed pipeline's own verdicts.
"""
from __future__ import annotations

import numpy as np
import torch

from foldbench.reference.exact import (CONTROL_LANE_BITS, batch_sims,
                                       greedy_leader, index_sims)
from foldbench.reference.signatures import batch_signatures

__all__ = ["Window", "compare", "truth"]

_CHUNK = 32768            # ring rows per matrix product


class Window:
    """What the last W batches admitted, as a ring of W blocks of `rows`
    rows each on `device`."""

    def __init__(self, W: int, rows: int, T: int, device):
        self.W, self.rows = W, rows
        self.bits = torch.zeros((W * rows, T), dtype=torch.float32,
                                device=device)
        self.pcs = torch.zeros(W * rows, dtype=torch.int64, device=device)
        self.valid = torch.zeros(W * rows, dtype=torch.bool, device=device)
        self.added = 0

    def hit(self, bits: torch.Tensor, pcs: torch.Tensor,
            tau: float) -> np.ndarray:
        """(B,) bool: some row of the window lies at or above tau."""
        out = torch.zeros(bits.shape[0], dtype=torch.bool, device=bits.device)
        end = min(self.added, self.W) * self.rows
        for s in range(0, end, _CHUNK):
            e = min(s + _CHUNK, end)
            sim = index_sims(bits, pcs, self.bits[s:e], self.pcs[s:e])
            out |= ((sim >= tau) & self.valid[None, s:e]).any(1)
        return out.cpu().numpy()

    def add(self, bits: torch.Tensor, pcs: torch.Tensor, keep) -> None:
        """A batch's admitted rows take the block of the batch W back."""
        rows = torch.from_numpy(np.asarray(keep, bool)).to(bits.device)
        b, p = bits[rows], pcs[rows]
        s = (self.added % self.W) * self.rows
        n = b.shape[0]
        self.valid[s:s + self.rows] = False
        self.bits[s:s + n] = b
        self.pcs[s:s + n] = p
        self.valid[s:s + n] = True
        self.added += 1


def _ring(batches: list, W: int) -> Window:
    bits = batches[0][0]
    rows = max(b.shape[0] for b, _ in batches)
    return Window(W, rows, bits.shape[1], bits.device)


def _exact_off(device) -> None:
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False


def _window(batches: list, W: int, tau: float) -> tuple[list, list]:
    """(keep, keep_in_batch) per batch of the windowed exact pipeline."""
    ring = _ring(batches, W)
    keeps, kibs = [], []
    for bits, pcs in batches:
        kib = greedy_leader(batch_sims(bits, pcs, bits, pcs), tau)
        keep = kib & ~ring.hit(bits, pcs, tau)
        ring.add(bits, pcs, keep)
        keeps.append(keep)
        kibs.append(kib)
    return keeps, kibs


def _judge(batches: list, verdicts: list, first: int, W: int, tau: float,
           sound: tuple[list, list]) -> dict:
    """`exact.judge`'s counts, each batch held against what the program
    admitted in the W batches before it."""
    keeps, kibs = sound
    ring = _ring(batches, W)
    out = dict(docs=0, missing=0, batch_dup_kept=0, unjustified=0,
               missed=0, exact_dups=0, caught=0)
    for i, ((bits, pcs), got) in enumerate(zip(batches, verdicts)):
        B = bits.shape[0]
        got = (np.asarray(got, bool) if got is not None and len(got) == B
               else None)
        if i >= first:
            out["docs"] += B
            if got is None:
                out["missing"] += B
            else:
                found = ring.hit(bits, pcs, tau)
                out["batch_dup_kept"] += int((got & ~kibs[i]).sum())
                out["unjustified"] += int((~got & kibs[i] & ~found).sum())
                out["missed"] += int((got & found).sum())
                out["exact_dups"] += int((~keeps[i]).sum())
                out["caught"] += int((~keeps[i] & ~got).sum())
        ring.add(bits, pcs, got if got is not None else np.zeros(B, bool))
    out["recall"] = (out["caught"] / out["exact_dups"] if out["exact_dups"]
                     else 1.0)
    return out


def compare(docs: list, verdicts: list, first: int, fold: dict,
            config: dict, rec: dict, *, device,
            control: bool = False) -> tuple[dict, dict | None]:
    """`exact.compare`'s counts under the window."""
    _exact_off(device)
    W, tau = config["lifecycle"]["ttl_batches"], fold["tau"]
    batches = batch_signatures(docs, fold, device)
    sound = _window(batches, W, tau)
    judged = _judge(batches, verdicts, first, W, tau, sound)
    judged["missing"] += rec.get("missing_docs", 0)
    live = sum(int(np.asarray(v, bool).sum()) for v in verdicts[-W:]
               if v is not None)
    judged["index_gap"] = abs(live - rec["index_count"])
    if not control:
        return judged, None
    low = batch_signatures(docs, fold, device, CONTROL_LANE_BITS)
    low_keeps = _window(low, W, tau)[0]
    del low
    counts = _judge(batches, low_keeps, first, W, tau, sound)
    counts["index_gap"] = 0       # the reference's index holds what it admits
    return judged, counts


def truth(docs: list, fold: dict, config: dict, *,
          device) -> tuple[list, int]:
    """The windowed pipeline's verdicts per batch, and what the last W
    batches admitted."""
    _exact_off(device)
    W = config["lifecycle"]["ttl_batches"]
    keeps = _window(batch_signatures(docs, fold, device), W, fold["tau"])[0]
    return keeps, sum(int(k.sum()) for k in keeps[-W:])
