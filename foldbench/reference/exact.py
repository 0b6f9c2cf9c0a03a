"""The exact online pipeline and the comparison that decides `correct`.

The exact pipeline runs FOLD's admission rule with brute force in place of
the HNSW index: in BATCH_FIRST order, each batch is swept by the greedy
leader (a row is dropped when an earlier row of the batch that the sweep
kept lies at or above tau), then each surviving row is compared with EVERY
admitted document and dropped when any lies at or above tau; the rest are
admitted. It sees the same batches, in the same order, as the system did.

Similarities use FOLD's bitmap Jaccard from exact integer counts: with
s = pa + pb and px = popcount(a ^ b) = s - 2 |a & b|,
  within a batch   (s - px) / max(s + px, 1) in float32 (1 where both
                   are empty), the in-batch kernel's formula;
  against the index  1 - 2 px / max(s + px, 1) in float32 (1 where both
                   are empty), the index search's.
|a & b| is a float32 matrix product of 0/1 rows (TF32 off), exact while
counts stay below 2**24; a bitmap has at most H = 112 bits set.

`judge` holds the system's verdicts against the guarantees of the
configuration and the exact pipeline's verdicts (see its docstring).
`compare` is the entry point the benchmark calls: the whole judgement of a
run, the control's with it. `truth` is what a sound program gives, which
the control's test judges beside the control.
"""
from __future__ import annotations

import numpy as np
import torch

from foldbench.reference.signatures import batch_signatures

__all__ = ["ExactIndex", "greedy_leader", "batch_sims", "index_sims",
           "exact_pipeline", "judge", "CONTROL_LANE_BITS", "compare",
           "truth"]

_CHUNK = 16384
# the control: the exact pipeline on MinHash lanes of 16 bits, the integer
# precision below the 32-bit lanes the configurations state
CONTROL_LANE_BITS = 16


def _px(inter: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor):
    s = pa[:, None] + pb[None, :]
    return s, s - 2 * inter


def _intersections(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, T) x (m, T) 0/1 float32 -> (n, m) int64 counts of common bits."""
    if a.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    return torch.round(a @ b.T).to(torch.int64)


def batch_sims(a, pa, b, pb) -> torch.Tensor:
    s, px = _px(_intersections(a, b), pa, pb)
    union2 = (s + px).to(torch.float32)
    inter2 = (s - px).to(torch.float32)
    return torch.where(union2 > 0, inter2 / torch.clamp(union2, min=1.0),
                       torch.ones_like(union2))


def index_sims(a, pa, b, pb) -> torch.Tensor:
    s, px = _px(_intersections(a, b), pa, pb)
    denom = s + px
    d = 2.0 * px.to(torch.float32) / torch.clamp(denom, min=1).to(
        torch.float32)
    d = torch.where(denom > 0, d, torch.zeros_like(d))
    return 1.0 - d


def greedy_leader(sim: torch.Tensor, tau: float) -> np.ndarray:
    """keep[i] = no kept j < i has sim[i, j] >= tau."""
    ge = (sim >= tau).cpu().numpy()
    keep = np.zeros(ge.shape[0], bool)
    for i in range(ge.shape[0]):
        keep[i] = not (ge[i, :i] & keep[:i]).any()
    return keep


class ExactIndex:
    """Rows held for brute-force search: 0/1 bitmaps and popcounts."""

    def __init__(self, capacity: int, T: int, device):
        self.bits = torch.zeros((capacity, T), dtype=torch.float32,
                                device=device)
        self.pcs = torch.zeros(capacity, dtype=torch.int64, device=device)
        self.n = 0

    def add(self, bits: torch.Tensor, pcs: torch.Tensor) -> None:
        k = bits.shape[0]
        self.bits[self.n:self.n + k] = bits
        self.pcs[self.n:self.n + k] = pcs
        self.n += k

    def hit(self, bits: torch.Tensor, pcs: torch.Tensor,
            tau: float) -> np.ndarray:
        """(B,) bool: some held row lies at or above tau."""
        out = torch.zeros(bits.shape[0], dtype=torch.bool, device=bits.device)
        for s in range(0, self.n, _CHUNK):
            e = min(s + _CHUNK, self.n)
            sim = index_sims(bits, pcs, self.bits[s:e], self.pcs[s:e])
            out |= (sim >= tau).any(1)
        return out.cpu().numpy()


def exact_pipeline(batches: list, tau: float) -> tuple[list, list]:
    """(keep, keep_in_batch) per batch, each a (B,) bool array. `batches`
    holds (bits, pcs) per batch, in order."""
    total = sum(b.shape[0] for b, _ in batches)
    dev = batches[0][0].device
    index = ExactIndex(total, batches[0][0].shape[1], dev)
    keeps, kibs = [], []
    for bits, pcs in batches:
        kib = greedy_leader(batch_sims(bits, pcs, bits, pcs), tau)
        keep = kib & ~index.hit(bits, pcs, tau)
        held = torch.from_numpy(keep).to(dev)
        index.add(bits[held], pcs[held])
        keeps.append(keep)
        kibs.append(kib)
    return keeps, kibs


def judge(batches: list, verdicts: list, first: int, tau: float, *,
          exact: tuple[list, list] | None = None) -> dict:
    """Hold `verdicts` (a (B,) bool keep array per batch, None for a batch
    whose verdicts never came) against the guarantees and the exact
    pipeline, over the batches from index `first` on (the earlier ones, the
    prefill and warm-up, only build both sides' state). Returns counts:

      missing          docs with no verdict
      batch_dup_kept   docs admitted though the exact in-batch sweep drops
                       them (the sweep is exact, so this must be 0)
      unjustified      docs dropped although the sweep keeps them and no
                       document the system admitted before lies at or
                       above tau (must be 0)
      missed           docs admitted although a document the system
                       admitted before their batch lies at or above tau:
                       the index search's own misses (not a guarantee)
      exact_dups, caught
                       docs the exact pipeline drops, and those of them
                       the system drops too: recall = caught / exact_dups
                       (1 where there are none)
    """
    keeps, kibs = exact if exact is not None else exact_pipeline(batches,
                                                                 tau)
    total = sum(b.shape[0] for b, _ in batches)
    dev = batches[0][0].device
    admitted = ExactIndex(total, batches[0][0].shape[1], dev)
    out = dict(docs=0, missing=0, batch_dup_kept=0, unjustified=0,
               missed=0, exact_dups=0, caught=0)
    for i, ((bits, pcs), got) in enumerate(zip(batches, verdicts)):
        B = bits.shape[0]
        if got is not None and len(got) != B:
            got = None
        if i >= first:
            out["docs"] += B
            if got is None:
                out["missing"] += B
            else:
                kib = kibs[i]
                out["batch_dup_kept"] += int((got & ~kib).sum())
                found = admitted.hit(bits, pcs, tau)
                out["unjustified"] += int((~got & kib & ~found).sum())
                out["missed"] += int((got & found).sum())
                ref_dup = ~keeps[i]
                out["exact_dups"] += int(ref_dup.sum())
                out["caught"] += int((ref_dup & ~got).sum())
        if got is not None:
            held = torch.from_numpy(got).to(dev)
            admitted.add(bits[held], pcs[held])
    # nothing to catch is nothing missed
    out["recall"] = (out["caught"] / out["exact_dups"] if out["exact_dups"]
                     else 1.0)
    return out


def compare(docs: list, verdicts: list, first: int, fold: dict,
            config: dict, rec: dict, *, device,
            control: bool = False) -> tuple[dict, dict | None]:
    """The judgement of one run: the documents and the program's verdicts
    per batch (None where none came), the index of the first judged batch,
    the `fold` settings, the configuration and the driver's record in;
    every compared count out (`judge`'s, with `missing` adding the
    documents the driver saw go unanswered, and `index_gap`: the program's
    live count, `rec["index_count"]`, against the documents it admitted,
    since nothing leaves an append-only index). With `control`, also the
    counts of the control put in the program's place, else None."""
    batches = batch_signatures(docs, fold, device)
    truth = exact_pipeline(batches, fold["tau"])
    judged = judge(batches, verdicts, first, fold["tau"], exact=truth)
    judged["missing"] += rec.get("missing_docs", 0)
    admitted = sum(int(np.asarray(v, bool).sum()) for v in verdicts)
    judged["index_gap"] = abs(admitted - rec["index_count"])
    if not control:
        return judged, None
    low = batch_signatures(docs, fold, device, CONTROL_LANE_BITS)
    counts = judge(batches, exact_pipeline(low, fold["tau"])[0], first,
                   fold["tau"], exact=truth)
    counts["index_gap"] = 0       # the reference's index holds what it admits
    return judged, counts


def truth(docs: list, fold: dict, config: dict, *,
          device) -> tuple[list, int]:
    """What a sound program gives on `docs` (a list of documents per
    batch): the exact online pipeline's verdicts per batch, and the live
    count its index ends with, every document admitted."""
    keeps = exact_pipeline(batch_signatures(docs, fold, device),
                           fold["tau"])[0]
    return keeps, sum(int(k.sum()) for k in keeps)
