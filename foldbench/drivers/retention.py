"""The retention window: the closed loop of the `pipeline` driver, where
after every batch the program's own `LifecycleManager` (the configuration's
`lifecycle`: `ttl_batches`, `compact_watermark`, `max_live_docs`) expires
the documents the batch `ttl_batches` back admitted and compacts the index
at the watermark. The manager's spans (`lifecycle.expire`,
`lifecycle.compact` and the compaction's `compact.*`) join the stats of the
batch after which it ran. Every batch of the prefill goes through the same
step, so the window starts from an index that has expired and compacted as
a deployment's has; the manager's ledger is saved beside the prefill's
snapshot (`LifecycleManager.save`) and loaded back after every restore
(`LifecycleManager.load`), so that the prefill's documents expire on time.

Each compaction is logged with the batch after which it ran (counted from
the prefill's first), and at the end of the window the share of the
linked nodes that were tombstones (ghosts the search walks through) over
the window's batches.
"""
from __future__ import annotations

import inspect

import numpy as np

from foldbench.drive import closed_loop


def _manager_class():
    """The program's LifecycleManager, where it keeps its ledger beside a
    snapshot and records its spans on a batch's stats; raises otherwise."""
    from repro_torch.lifecycle import LifecycleManager
    if not (hasattr(LifecycleManager, "save")
            and hasattr(LifecycleManager, "load")
            and "record" in inspect.signature(
                LifecycleManager.after_batch).parameters):
        raise RuntimeError(
            "the program's LifecycleManager cannot save its ledger beside "
            "an index snapshot (save, load) or record its spans on a "
            "batch's stats (after_batch(record=...)); the retention window "
            "needs both")
    return LifecycleManager


def drive(ctx: dict) -> dict:
    Manager = _manager_class()
    config, log = ctx["config"], ctx["log"]
    policy = config["lifecycle"]
    prefill_batches = -(-config["prefill"]["docs"]
                        // config["prefill"]["batch_docs"])
    held: dict = {"pipe": None, "manager": None, "batches": 0}
    ghosts: list = []                  # tombstones / linked, per batch

    def manager(pipe):
        """The manager of `pipe`: the prefill's pipeline, then the one
        restored for the window."""
        if held["pipe"] is not pipe:
            held["pipe"] = pipe
            held["manager"] = Manager(
                pipe, ttl_steps=policy["ttl_batches"],
                max_live_docs=policy.get("max_live_docs"),
                compact_watermark=policy["compact_watermark"])
        return held["manager"]

    def step(pipe, tokens, lengths):
        mgr = manager(pipe)
        keep, stats = pipe.process_batch(tokens, lengths)
        mgr.after_batch(record=stats)
        held["batches"] += 1
        dead = pipe.dead_fraction * pipe.capacity
        ghosts.append(dead / max(dead + mgr.stats()["tracked_live"], 1))
        c = stats.get("spans", {}).get("lifecycle.compact")
        if c is not None:
            n = held["batches"]
            where = (f"window batch {n - prefill_batches - 1}"
                     if n > prefill_batches + 1 else "prefill or warm-up")
            inner = {k: e for k, e in stats["spans"].items()
                     if k.startswith("compact.")}
            repair = inner.get("compact.repair", {}).get("s", 0.0)
            syncs = c["syncs"] + sum(e["syncs"] for e in inner.values())
            log(f"compaction after batch {n} ({where}): "
                f"{c.get('rows', 0)} rows rebuilt, {c.get('reclaimed', 0)} "
                f"slots reclaimed, {c['s'] * 1e3:.1f} ms (repair "
                f"{repair * 1e3:.1f} ms), {syncs} syncs")
        return keep, stats

    def save(pipe, directory):
        manager(pipe).save(str(directory), 0)
        held.update(pipe=None, manager=None)    # the prefill's index goes

    def load(pipe, entry):
        if not manager(pipe).load(str(entry), 0):
            raise FileNotFoundError(f"no lifecycle ledger in {entry}")
        held["batches"] = prefill_batches

    rec = closed_loop(ctx, step=step, save_extra=save, load_extra=load)
    window = ghosts[-len(rec["stages"]) - ctx["trace_batches"] * bool(
        ctx["trace"]):][:len(rec["stages"])]
    if window:
        log(f"tombstones among the linked nodes over the window's "
            f"{len(window)} batches: min {min(window):.4f}, mean "
            f"{float(np.mean(window)):.4f}, max {max(window):.4f}")
    return rec
