"""What the drivers share: the generator's queue, the window's start and
end, the closed loop and the open loop.

A driver is `drivers/<name>.py`, named by a configuration's `driver` key,
with `drive(ctx) -> rec`: it restores the cell's prefill, runs the warm-up
unit, measures the window, and with tracing on runs a traced segment after
it. It returns the run's records: the time stamps and counts the metrics
read, the sequence of batches the program saw (as documents, for the
reference), the program's verdicts for each, and the index's live count.
"""
from __future__ import annotations

import gc
import time
from typing import Callable

import numpy as np

from foldbench import prefill as prefill_mod
from foldbench import trace as trace_mod
from foldbench.traffic.generate import unpad

__all__ = ["Units", "window_start", "window_end", "log_setup",
           "closed_loop", "open_loop"]

clock = time.perf_counter


class Units:
    """The generator's queue, with the time the caller waited on it."""

    def __init__(self, queue):
        self.queue = queue
        self.waited_s = 0.0

    def get(self):
        t0 = clock()
        unit = self.queue.get()
        self.waited_s += clock() - t0
        return unit


def window_start(ctx: dict) -> None:
    """Collect and freeze what set-up left, so that the window's
    collections pass over the window's own objects only; start watching
    the host."""
    gc.collect()
    gc.freeze()
    ctx["watch"].start()


def window_end(ctx: dict, rec: dict) -> None:
    rec["host"] = ctx["watch"].stop()
    gc.unfreeze()


def _valid_shingles(lengths: np.ndarray, n: int) -> int:
    ln = lengths.astype(np.int64)
    return int(np.where(ln >= n, ln - n + 1, np.minimum(ln, 1)).sum())


def log_setup(ctx: dict, setup_s: float, restored: float,
              warm: float) -> None:
    ctx["log"](f"set-up {setup_s:.3f} s: to the restored index "
               f"{restored - ctx['t_start']:.3f} s, warm-up unit "
               f"{warm - restored:.3f} s")


def closed_loop(ctx: dict, step: Callable | None = None,
                save_extra: Callable | None = None,
                load_extra: Callable | None = None) -> dict:
    """`FoldPipeline(FoldConfig(**fold))` driven closed loop: one caller,
    the next batch sent when the last completes. Every batch, those of the
    prefill too, goes through `step(pipe, tokens, lengths) -> (keep,
    stats)`, `pipe.process_batch(tokens, lengths)` where none is given;
    `save_extra` and `load_extra` are the prefill's (see `prefill.ensure`
    and `prefill.restore`)."""
    from repro_torch.core.dedup import FoldConfig, FoldPipeline
    config, units, dev = ctx["config"], ctx["units"], ctx["device"]

    def make():
        return FoldPipeline(FoldConfig(**config["fold"]), device=dev)

    if step is None:
        def step(pipe, tokens, lengths):
            return pipe.process_batch(tokens, lengths)

    entry = prefill_mod.ensure(config, ctx["mix"], ctx["cache"], make,
                               ctx["log"], step=step, save_extra=save_extra)
    t0 = clock()
    pipe = make()
    prefill_keep = prefill_mod.restore(pipe, entry, load_extra)
    ctx["on_ready"](pipe)
    t1 = clock()
    # (tokens, lengths, verdicts) in the order the program saw them
    batches: list = []
    _, tokens, lengths = units.get()
    keep, _ = step(pipe, tokens, lengths)
    batches.append((tokens, lengths, keep))
    window_start(ctx)
    t0 = clock()
    setup_s = t0 - ctx["t_start"]
    log_setup(ctx, setup_s, t1, t0)
    units.waited_s = 0.0
    end = t0 + ctx["seconds"]
    stages, done = [], []
    while clock() < end:
        _, tokens, lengths = units.get()
        keep, stats = step(pipe, tokens, lengths)
        done.append(clock())
        stages.append(stats)
        batches.append((tokens, lengths, keep))
    if done:
        each = np.diff([t0, *done])
        ctx["log"](f"the window's {len(done)} batches took, in s: median "
                   f"{np.median(each):.4f}, 90th percentile "
                   f"{np.quantile(each, 0.9):.4f}, longest {each.max():.4f}")
    rec = {"setup_s": setup_s, "window_start": t0, "done": done,
           "docs": [len(b[1]) for b in batches[1:]], "stages": stages,
           "queue_wait_s": units.waited_s}
    window_end(ctx, rec)
    if ctx["trace"]:
        todo = [units.get() for _ in range(ctx["trace_batches"])]
        n = pipe.cfg.shingle_n

        def traced():
            return [step(pipe, t, ln)[0] for _, t, ln in todo]

        keeps, events, window_s = trace_mod.capture(traced, ctx["trace_path"],
                                                  dev)
        for (_, t, ln), k in zip(todo, keeps):
            batches.append((t, ln, k))
        rec["trace"] = trace_mod.reduce(events, window_s)
        rec["trace"]["units"] = len(todo)
        rec["trace"]["shapes"] = [
            {"B": t.shape[0], "L": t.shape[1], "valid_shingles":
             _valid_shingles(ln, n)} for _, t, ln in todo]
    rec["prefill_keep"] = prefill_keep
    rec["batches"] = [(unpad(t, ln), k) for t, ln, k in batches]
    rec["first_judged"] = 1           # after the warm-up batch
    rec["index_count"] = pipe.inserted
    rec["attempted"] = sum(rec["docs"])
    rec["failed"] = 0
    return rec


def open_loop(svc, units: Units, first, base: float, until: float,
              late_s: float, state: dict, log: Callable) -> tuple:
    """Submit each request at base + its arrival (or as soon after as the
    caller is free), arrivals below `until`, and poll until the last one is
    dispatched (then flush) or `late_s` has passed since base + until.
    Returns (the requests: (arrival time, first doc id, end doc id), the
    first unit past `until`)."""
    reqs = []
    unit = first
    while True:
        now = clock()
        while unit is not None and unit[1] < until and base + unit[1] <= now:
            ticket = svc.submit(unit[2], unit[3])
            state["sent"].append((ticket.start, unit[2], unit[3]))
            reqs.append((base + unit[1], ticket.start, ticket.stop))
            unit = units.get()
            now = clock()
        svc.poll()
        drained = unit is None or unit[1] >= until
        if drained and svc.batcher.pending == 0:
            # the executor materializes a batch only when `depth` more are
            # dispatched; with no more traffic to come, collect the rest
            svc.flush()
            return reqs, unit
        if now > base + until + late_s:
            log(f"open loop: gave up waiting {late_s} s past the window's "
                f"end with {svc.backlog()} documents pending")
            return reqs, unit
        nxt = base + unit[1] if not drained else now + 0.0005
        time.sleep(min(0.0005, max(0.0, nxt - clock())))
