"""The two ways a configuration drives the program, named by its
`driver` key.

  pipeline  `FoldPipeline(FoldConfig(**fold))` through
            `DedupPipeline.process_batch`, closed loop: one caller, the
            next batch sent when the last completes.
  service   `DedupService(ServiceConfig(fold=FoldConfig(**fold),
            **service))` through `submit` and `poll`, open loop: each
            request is submitted at its scheduled arrival, or as soon
            after as the caller is free; verdicts are seen through
            `outcome_hooks`.

Each restores the cell's prefill, runs the warm-up unit, measures the
window, and with tracing on runs a traced segment after it. It returns
the run's records: the time stamps and counts the metrics read, the
sequence of batches the program saw (as documents, for the reference),
and the program's verdicts for each.
"""
from __future__ import annotations

import gc
import time
from typing import Callable

import numpy as np

from foldbench import prefill as prefill_mod
from foldbench import trace as trace_mod
from foldbench.traffic.generate import unpad

__all__ = ["DRIVERS", "Units"]

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


def _window_start(ctx: dict) -> None:
    """Collect and freeze what set-up left, so that the window's
    collections pass over the window's own objects only; start watching
    the host."""
    gc.collect()
    gc.freeze()
    ctx["watch"].start()


def _window_end(ctx: dict, rec: dict) -> None:
    rec["host"] = ctx["watch"].stop()
    gc.unfreeze()


def _valid_shingles(lengths: np.ndarray, n: int) -> int:
    ln = lengths.astype(np.int64)
    return int(np.where(ln >= n, ln - n + 1, np.minimum(ln, 1)).sum())


def _log_setup(ctx: dict, setup_s: float, restored: float,
               warm: float) -> None:
    ctx["log"](f"set-up {setup_s:.3f} s: to the restored index "
               f"{restored - ctx['t_start']:.3f} s, warm-up unit "
               f"{warm - restored:.3f} s")


def drive_pipeline(ctx: dict) -> dict:
    from repro_torch.core.dedup import FoldConfig, FoldPipeline
    config, units, dev = ctx["config"], ctx["units"], ctx["device"]

    def make():
        return FoldPipeline(FoldConfig(**config["fold"]), device=dev)

    entry = prefill_mod.ensure(config, ctx["mix"], ctx["cache"], make,
                               ctx["log"])
    t0 = clock()
    pipe = make()
    prefill_keep = prefill_mod.restore(pipe, entry)
    ctx["on_ready"](pipe)
    t1 = clock()
    # (tokens, lengths, verdicts) in the order the program saw them
    batches: list = []
    _, tokens, lengths = units.get()
    keep, _ = pipe.process_batch(tokens, lengths)
    batches.append((tokens, lengths, keep))
    _window_start(ctx)
    t0 = clock()
    setup_s = t0 - ctx["t_start"]
    _log_setup(ctx, setup_s, t1, t0)
    units.waited_s = 0.0
    end = t0 + ctx["seconds"]
    stages, done = [], []
    while clock() < end:
        _, tokens, lengths = units.get()
        keep, stats = pipe.process_batch(tokens, lengths)
        done.append(clock())
        stages.append(stats)
        batches.append((tokens, lengths, keep))
    rec = {"setup_s": setup_s, "window_start": t0, "done": done,
           "docs": [len(b[1]) for b in batches[1:]], "stages": stages,
           "queue_wait_s": units.waited_s}
    _window_end(ctx, rec)
    if ctx["trace"]:
        todo = [units.get() for _ in range(ctx["trace_batches"])]
        n = pipe.cfg.shingle_n

        def traced():
            return [pipe.process_batch(t, ln)[0] for _, t, ln in todo]

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


def _open_loop(svc, units: Units, first, base: float, until: float,
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


def drive_service(ctx: dict) -> dict:
    from repro_torch.core.dedup import FoldConfig, FoldPipeline
    from repro_torch.service import DedupService, ServiceConfig
    config, units, dev = ctx["config"], ctx["units"], ctx["device"]
    fold = FoldConfig(**config["fold"])

    def make():
        return FoldPipeline(fold, device=dev)

    entry = prefill_mod.ensure(config, ctx["mix"], ctx["cache"], make,
                               ctx["log"])
    t0 = clock()
    svc = DedupService(ServiceConfig(fold=fold, device=str(dev),
                                     **config.get("service", {})))
    prefill_keep = prefill_mod.restore(svc.pipeline, entry)
    ctx["on_ready"](svc.pipeline)
    t1 = clock()
    state: dict = {"sent": [], "done": {}, "micro": []}

    def hook(out):
        t = clock()
        mb = out.batch
        ids = mb.doc_ids[mb.valid]
        for d in ids:
            state["done"][int(d)] = t
        state["micro"].append({"t": t, "ids": ids.copy(),
                               "keep": out.keep[mb.valid].copy(),
                               "wall_s": out.wall_s,
                               "n_valid": int(mb.n_docs),
                               "rows": int(mb.tokens.shape[0])})

    svc.outcome_hooks.append(hook)
    _, tokens, lengths = units.get()
    ticket = svc.submit(tokens, lengths)
    state["sent"].append((ticket.start, tokens, lengths))
    svc.flush()
    n_warm = len(state["micro"])
    first = units.get()
    _window_start(ctx)
    t0 = clock()
    setup_s = t0 - ctx["t_start"]
    _log_setup(ctx, setup_s, t1, t0)
    units.waited_s = 0.0
    seconds = ctx["seconds"]
    reqs, nxt = _open_loop(svc, units, first, t0, seconds, ctx["late_s"],
                           state, ctx["log"])
    n_window = len(state["micro"])
    rec = {"setup_s": setup_s, "window_start": t0,
           "queue_wait_s": units.waited_s}
    _window_end(ctx, rec)
    if ctx["trace"]:
        def traced():
            base = clock() - seconds
            return _open_loop(svc, units, nxt, base, seconds
                              + ctx["trace_seconds"], ctx["late_s"], state,
                              ctx["log"])

        _, events, window_s = trace_mod.capture(traced, ctx["trace_path"],
                                                  dev)
        rec["trace"] = trace_mod.reduce(events, window_s)
        rec["trace"]["units"] = len(state["micro"]) - n_window
    svc.flush()
    lat, failed, queue = [], 0, {}
    for arrival, a, b in reqs:
        ts = [state["done"].get(d) for d in range(a, b)]
        if any(t is None for t in ts):
            failed += 1
            continue
        lat.append(max(ts) - arrival)
        for d in range(a, b):
            queue[d] = arrival
    micro = state["micro"][n_warm:n_window]
    for m in micro:
        m["queue_s"] = [m["t"] - m["wall_s"] - queue[int(d)]
                        for d in m["ids"] if int(d) in queue]
    rec.update(latency_s=lat, micro=micro, requests=len(reqs),
               docs=[m["n_valid"] for m in micro], attempted=len(reqs),
               failed=failed)
    rec["prefill_keep"] = prefill_keep
    docs = {start + i: d for start, t, ln in state["sent"]
            for i, d in enumerate(unpad(t, ln))}
    rec["batches"] = [([docs[int(d)] for d in m["ids"]], m["keep"])
                      for m in state["micro"]]
    rec["first_judged"] = n_warm
    rec["index_count"] = svc.pipeline.inserted
    submitted = set(docs)
    seen = {int(d) for m in state["micro"] for d in m["ids"]}
    rec["missing_docs"] = len(submitted - seen)
    return rec


DRIVERS = {"pipeline": drive_pipeline, "service": drive_service}
