"""The `service` driver: `DedupService(ServiceConfig(fold=FoldConfig(
**fold), **service))` through `submit` and `poll`, open loop: each request
is submitted at its scheduled arrival, or as soon after as the caller is
free; verdicts are seen through `outcome_hooks`."""
from __future__ import annotations

from foldbench import prefill as prefill_mod
from foldbench import trace as trace_mod
from foldbench.drive import (clock, log_setup, open_loop, window_end,
                             window_start)
from foldbench.traffic.generate import unpad


def drive(ctx: dict) -> dict:
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
    window_start(ctx)
    t0 = clock()
    setup_s = t0 - ctx["t_start"]
    log_setup(ctx, setup_s, t1, t0)
    units.waited_s = 0.0
    seconds = ctx["seconds"]
    reqs, nxt = open_loop(svc, units, first, t0, seconds, ctx["late_s"],
                          state, ctx["log"])
    n_window = len(state["micro"])
    rec = {"setup_s": setup_s, "window_start": t0,
           "queue_wait_s": units.waited_s}
    window_end(ctx, rec)
    if ctx["trace"]:
        def traced():
            base = clock() - seconds
            return open_loop(svc, units, nxt, base, seconds
                             + ctx["trace_seconds"], ctx["late_s"], state,
                             ctx["log"])

        _, events, window_s = trace_mod.capture(traced, ctx["trace_path"],
                                                  dev)
        rec["trace"] = trace_mod.reduce(events, window_s)
        rec["trace"]["units"] = len(state["micro"]) - n_window
    svc.flush()
    lat, failed, queue = [], 0, {}
    served = {"docs": 0, "last": t0}
    for arrival, a, b in reqs:
        ts = [state["done"].get(d) for d in range(a, b)]
        if any(t is None for t in ts):
            failed += 1
            continue
        lat.append(max(ts) - arrival)
        served["docs"] += b - a
        served["last"] = max(served["last"], max(ts))
        for d in range(a, b):
            queue[d] = arrival
    micro = state["micro"][n_warm:n_window]
    for m in micro:
        m["queue_s"] = [m["t"] - m["wall_s"] - queue[int(d)]
                        for d in m["ids"] if int(d) in queue]
    rec.update(latency_s=lat, served=served, micro=micro,
               requests=len(reqs), docs=[m["n_valid"] for m in micro],
               attempted=len(reqs), failed=failed)
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
