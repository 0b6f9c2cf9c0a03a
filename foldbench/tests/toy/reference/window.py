"""The toy retention window's reference, for the tests: the exact online
pipeline of `foldbench/reference/exact.py`, where the index a batch is
searched against holds only what the W batches before it admitted, and
the live count the program's index should end with is what the last W
batches admitted. Its control is the same pipeline on 16-bit MinHash
lanes, as `exact`'s is."""
from __future__ import annotations

import numpy as np
import torch

from foldbench.reference.exact import (CONTROL_LANE_BITS, batch_sims,
                                       greedy_leader, index_sims)
from foldbench.reference.signatures import batch_signatures


def _hit(bits, pcs, held: list, tau: float) -> np.ndarray:
    """(B,) bool: some row of the batches in `held` lies at or above tau."""
    out = np.zeros(bits.shape[0], bool)
    for b, p in held:
        if b.shape[0]:
            out |= (index_sims(bits, pcs, b, p) >= tau).any(1).numpy()
    return out


def _admit(bits, pcs, keep) -> tuple:
    rows = torch.from_numpy(np.asarray(keep, bool))
    return bits[rows], pcs[rows]


def _window(batches: list, W: int, tau: float) -> tuple[list, list]:
    """(keep, keep_in_batch) per batch of the windowed exact pipeline."""
    keeps, kibs, held = [], [], []
    for bits, pcs in batches:
        kib = greedy_leader(batch_sims(bits, pcs, bits, pcs), tau)
        keep = kib & ~_hit(bits, pcs, held[-W:], tau)
        held.append(_admit(bits, pcs, keep))
        keeps.append(keep)
        kibs.append(kib)
    return keeps, kibs


def _judge(batches: list, verdicts: list, first: int, W: int, tau: float,
           sound: tuple[list, list]) -> dict:
    """`exact.judge`'s counts, each batch held against the W before it."""
    keeps, kibs = sound
    out = dict(docs=0, missing=0, batch_dup_kept=0, unjustified=0,
               missed=0, exact_dups=0, caught=0)
    admitted = []
    for i, ((bits, pcs), got) in enumerate(zip(batches, verdicts)):
        B = bits.shape[0]
        got = (np.asarray(got, bool) if got is not None and len(got) == B
               else None)
        if i >= first:
            out["docs"] += B
            if got is None:
                out["missing"] += B
            else:
                found = _hit(bits, pcs, admitted[-W:], tau)
                out["batch_dup_kept"] += int((got & ~kibs[i]).sum())
                out["unjustified"] += int((~got & kibs[i] & ~found).sum())
                out["missed"] += int((got & found).sum())
                out["exact_dups"] += int((~keeps[i]).sum())
                out["caught"] += int((~keeps[i] & ~got).sum())
        admitted.append(_admit(bits, pcs,
                               got if got is not None else np.zeros(B, bool)))
    out["recall"] = (out["caught"] / out["exact_dups"] if out["exact_dups"]
                     else 1.0)
    return out


def compare(docs: list, verdicts: list, first: int, fold: dict,
            config: dict, rec: dict, *, device,
            control: bool = False) -> tuple[dict, dict | None]:
    """`exact.compare`'s counts under the window."""
    W, tau = config["window"]["batches"], fold["tau"]
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
    counts = _judge(batches, _window(low, W, tau)[0], first, W, tau, sound)
    counts["index_gap"] = 0       # the reference's index holds what it admits
    return judged, counts


def truth(docs: list, fold: dict, config: dict, *,
          device) -> tuple[list, int]:
    """The windowed pipeline's verdicts per batch, and what the last W
    batches admitted."""
    W = config["window"]["batches"]
    keeps = _window(batch_signatures(docs, fold, device), W, fold["tau"])[0]
    return keeps, sum(int(k.sum()) for k in keeps[-W:])
