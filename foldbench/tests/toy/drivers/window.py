"""A toy retention window, for the tests: the closed loop of the `pipeline`
driver, where after each batch the slots that the batch W batches back
admitted are deleted, through the backend's slot log (`track_slots`,
`pop_slot_log`) and `delete`. W is the configuration's
`window["batches"]`. Which slots each of the last W batches took is kept
beside the prefill's snapshot, so that a restored run deletes them on
time."""
from __future__ import annotations

from collections import deque

import numpy as np

from foldbench.drive import closed_loop


def drive(ctx: dict) -> dict:
    W = ctx["config"]["window"]["batches"]
    held: deque = deque()        # the slots of each of the last W batches

    def step(pipe, tokens, lengths):
        be = pipe.backend
        be.track_slots = True
        keep, stats = pipe.process_batch(tokens, lengths)
        held.append(be.pop_slot_log(1)[0])
        if len(held) > W:
            be.delete(held.popleft())
        return keep, stats

    def save(pipe, directory):
        np.savez(directory / "window.npz", *held)

    def load(pipe, entry):
        pipe.backend.track_slots = True
        with np.load(entry / "window.npz") as z:
            held.clear()
            held.extend(z[f"arr_{i}"] for i in range(len(z.files)))

    return closed_loop(ctx, step=step, save_extra=save, load_extra=load)
