"""A torch.profiler trace of a few steady units of work, reduced to what
the per-layer metrics and the `breakdown` read.

  busy_s       the union of the device's kernel, memcpy and memset
               intervals (overlapping operations count once)
  window_s     the host's wall time around the traced units, each end
               synchronised with the card
  device_ops   the host's calls that enqueue a device operation: one launch
               call per kernel, one copy or set call per memcpy or memset
  kernels      each kernel's event durations, by name
  top_ops      the device operations that took the most time, by name
  idle_gaps    the idle time between device operations, by the host
               operation that was running in the middle of each gap (the
               innermost CPU op or runtime call of the host's main thread)

The trace goes to a fixed file in the cache directory and is deleted once
read.
"""
from __future__ import annotations

import collections
import json
import os
import time
from pathlib import Path

import numpy as np

__all__ = ["capture", "reduce"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")
_COPY_CALLS = ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")
_TOP = 10


def capture(fn, path: Path, device):
    """Run fn() under torch.profiler; returns (fn's result, the trace's
    events, the wall seconds of the traced region)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window_s = time.perf_counter() - t0
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, events, window_s


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted, merged copy of (n, 2) [start, end) intervals."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def _host_at(events: list, points: np.ndarray) -> list:
    """The innermost host event of the busiest host thread that is running
    at each of `points` (ascending, microseconds); None where none is."""
    host = [e for e in events if e.get("cat") in _HOST_CATS
            and e.get("ph") == "X"]
    if not host:
        return [None] * len(points)
    tid = collections.Counter(e.get("tid") for e in host).most_common(1)[0][0]
    host = sorted((e for e in host if e.get("tid") == tid),
                  key=lambda e: (e["ts"], -e.get("dur", 0)))
    names, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i]["ts"] <= p:
            e = host[i]
            while stack and stack[-1][0] <= e["ts"]:
                stack.pop()
            stack.append((e["ts"] + e.get("dur", 0), e.get("name", "")))
            i += 1
        while stack and stack[-1][0] <= p:
            stack.pop()
        names.append(stack[-1][1] if stack else None)
    return names


def reduce(events: list, window_s: float) -> dict:
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    iv = np.asarray([[e["ts"], e["ts"] + e.get("dur", 0)] for e in dev],
                    float).reshape(-1, 2)
    merged = _union(iv)
    busy_s = float((merged[:, 1] - merged[:, 0]).sum()) / 1e6
    kernels: dict[str, list] = collections.defaultdict(list)
    by_name: dict[str, float] = collections.defaultdict(float)
    for e in dev:
        d = e.get("dur", 0) / 1e6
        by_name[e.get("name", "")] += d
        if e.get("cat") == "kernel":
            kernels[e.get("name", "")].append(d)
    ops = 0
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        name = e.get("name", "")
        if name in _LAUNCH_CALLS or name.startswith(_COPY_CALLS):
            ops += 1
    gaps: dict[str, float] = collections.defaultdict(float)
    if len(merged) > 1:
        starts, ends = merged[1:, 0], merged[:-1, 1]
        mids = (starts + ends) / 2
        for name, g in zip(_host_at(events, mids), starts - ends):
            gaps[(name or "(no host op)")[:120]] += g / 1e6

    def top(d: dict) -> list:
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:_TOP]]

    return {"busy_s": busy_s, "window_s": window_s, "device_ops": ops,
            "kernels": dict(kernels), "top_ops": top(by_name),
            "idle_gaps": top(gaps)}
