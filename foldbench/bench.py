"""One run of one cell: the producer of traffic, the configuration's
driver, the reference and the comparison, the metrics and the result.

Everything that belongs to one cell is found by name: the cell in the
root `BENCHMARK.json`, its configuration in `configs/<config>.json`, its
traffic in `traffic/<traffic>.json`, the configuration's driver in
`drivers/<driver>.py` (a `drive(ctx)` that returns the run's record), its
reference in `reference/<reference>.py` (`exact` where it names none: a
`compare(...)` that returns every compared count and its control's, and a
`truth(...)` that gives a sound program's verdicts), each metric's reader in
`metrics/<metric>.py` (a `read(rec)` that returns a number, or None where
the run holds nothing for it to read).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import multiprocessing as mp
import os
import sys
import time
from pathlib import Path

import numpy as np

from foldbench.drive import Units
from foldbench.hostwatch import HostWatch
from foldbench.traffic.generate import (load_mix, prefill_batches, produce,
                                        unpad)

__all__ = ["ROOT", "load_spec", "load_config", "cell_metrics", "read_metric",
           "load_piece", "run"]

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# units of a traced segment: batches (closed loop), seconds (open loop)
TRACE_BATCHES = 2
TRACE_SECONDS = 3.0
# how long past the window's end an open loop waits for verdicts
LATE_S = 60.0


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_config(name: str) -> dict:
    with open(HERE / "configs" / f"{name}.json") as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics a run of `cell` reports: its end-to-end ones without
    tracing, its per-layer ones with."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_piece(kind: str, name: str, root: Path = HERE):
    """The module `<root>/<kind>/<name>.py`: a driver (`kind` "drivers"),
    a reference ("reference") or a metric's reader ("metrics")."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} piece {name!r}: {path} is not a "
                                f"file")
    spec = importlib.util.spec_from_file_location(
        f"foldbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name: str, rec: dict):
    return load_piece("metrics", name).read(rec)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """The top-level names of loaded modules that must not be: JAX and
    the JAX package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _generator_core() -> int | None:
    """The last core this process may use, where it may use two or more:
    the traffic generator's, at a lower priority than the caller's."""
    try:
        cores = sorted(os.sched_getaffinity(0))
    except AttributeError:
        return None
    return cores[-1] if len(cores) > 1 else None


def _start_producer(mix, config, seed, seconds, trace_seconds, core):
    ctx = mp.get_context("spawn")
    q = ctx.Queue(maxsize=64 if mix["loop"] == "closed" else 8192)
    stop = ctx.Event()
    proc = ctx.Process(target=produce, daemon=True,
                       args=(mix, config["prefill"], seed, seconds,
                             trace_seconds, q, stop, core))
    proc.start()
    return proc, q, stop


def _stop_producer(proc, q, stop) -> None:
    stop.set()
    deadline = time.monotonic() + 30
    while proc.is_alive() and time.monotonic() < deadline:
        try:
            while True:
                q.get_nowait()
        except Exception:   # queue.Empty, or a queue torn down
            pass
        proc.join(timeout=0.1)
    if proc.is_alive():
        proc.terminate()
        proc.join(timeout=10)
    q.close()
    q.join_thread()


def _sequence(rec: dict, mix: dict, config: dict) -> tuple[list, list, int]:
    """(documents per batch, verdicts per batch, index of the first judged
    batch) over the prefill and everything the run sent after it."""
    docs, verdicts = [], []
    keep = rec["prefill_keep"]
    at = 0
    for tokens, lengths in prefill_batches(mix, config["prefill"]):
        docs.append(unpad(tokens, lengths))
        verdicts.append(keep[at:at + len(lengths)])
        at += len(lengths)
    first = len(docs) + rec["first_judged"]
    for d, k in rec["batches"]:
        docs.append(d)
        verdicts.append(np.asarray(k, bool))
    return docs, verdicts, first


def _checks(judged: dict, limits: dict) -> dict:
    """Each compared number beside its limit, {"max": x} or {"min": x}."""
    return {name: {"value": judged[name], **lim}
            for name, lim in limits.items()}


def _passes(checks: dict) -> bool:
    return all(c["value"] <= c["max"] if "max" in c else c["value"] >= c["min"]
               for c in checks.values())


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", spec: dict | None = None,
        config: dict | None = None, mix: dict | None = None,
        cache: Path | None = None, t_start: float | None = None,
        control: bool = False, on_ready=None, log=_log,
        pieces: Path = HERE) -> dict:
    """Run one cell once; returns the result line (a dict). `spec`,
    `config` and `mix` default to the files the cell names; `control` adds
    the control's comparison under the key "control"; `on_ready(pipeline)`
    is called once the prefill is restored (the tests plant faults
    there); the driver and the reference are found under `pieces`."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or load_spec()
    cell = next((c for c in spec["workloads"] if c["name"] == cell_name),
                None)
    if cell is None:
        raise KeyError(f"no cell {cell_name!r} in BENCHMARK.json")
    config = config or load_config(cell["config"])
    mix = mix or load_mix(cell["traffic"])
    driver = load_piece("drivers", config["driver"], pieces)
    reference = load_piece("reference", config.get("reference", "exact"),
                           pieces)
    dev = torch.device(device)
    trace_seconds = TRACE_SECONDS if trace and mix["loop"] == "open" else 0.0
    proc, q, stop = _start_producer(mix, config, seed, seconds,
                                    trace_seconds, _generator_core())
    ctx = {"config": config, "mix": mix, "device": dev, "units": Units(q),
           "watch": HostWatch(proc.pid),
           "cache": cache or HERE / "cache" / "prefill",
           "trace_path": (cache or HERE / "cache") / "trace.json",
           "t_start": t_start, "seconds": seconds, "trace": trace,
           "trace_batches": TRACE_BATCHES, "trace_seconds": TRACE_SECONDS,
           "late_s": LATE_S, "log": log,
           "on_ready": on_ready or (lambda p: None)}
    try:
        rec = driver.drive(ctx)
    finally:
        _stop_producer(proc, q, stop)
    log(f"the window's host: {rec['host']}")
    if rec["queue_wait_s"] > 0.01:
        log(f"the window spent {rec['queue_wait_s']:.3f} s taking units from "
            f"the traffic generator's queue")
    launches = _launch_counts()
    if launches is not None:
        log(f"kernel launches in the run: {launches}")
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": 1,
                  "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                        if dev.type == "cuda" else 0)}
    if trace and "trace" in rec:
        device_rec["busy_s"] = rec["trace"]["busy_s"]
        device_rec["window_s"] = rec["trace"]["window_s"]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    from repro_torch.core.dedup import FoldConfig
    fold = dataclasses.asdict(FoldConfig(**config["fold"]))
    rec["fold"] = fold
    t_ref = time.perf_counter()
    docs, verdicts, first = _sequence(rec, mix, config)
    judged, counts = reference.compare(docs, verdicts, first, fold, config,
                                       rec, device=dev, control=control)
    if control and counts is None:
        raise ValueError(f"reference {reference.__file__} gave no control "
                         f"counts; a reference has to judge its control")
    rec["judge"] = judged
    checks = _checks(judged, config["limits"])
    out_control = None
    if counts is not None:
        cchecks = _checks(counts, config["limits"])
        out_control = {"correct": _passes(cchecks), "checks": cchecks,
                       "counts": counts}
    log(f"reference and comparison took {time.perf_counter() - t_ref:.1f} s "
        f"over {sum(len(d) for d in docs)} documents in {len(docs)} batches "
        f"({first} before the judged ones); counts {judged}")

    metrics = {}
    for m in cell_metrics(spec, cell_name, trace):
        value = read_metric(m["name"], rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": _passes(checks), "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics,
              "device": device_rec}
    if trace and "trace" in rec:
        result["breakdown"] = {"device_ops": rec["trace"]["top_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    if out_control is not None:
        result["control"] = out_control
    result["checks"] = checks
    return result


def _launch_counts():
    lib = sys.modules.get("repro_torch.kernels._lib")
    return dict(lib.LAUNCHES) if lib is not None else None


def report(result: dict) -> None:
    """The last lines on standard error (each compared number beside its
    limit), then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        op, lim = ("<=", c["max"]) if "max" in c else (">=", c["min"])
        print(f"check {name} {c['value']} {op} {lim}", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
