"""Cells cut to a size a CPU test run holds: the same files, with the
index, the prefill, the batches and the load made small."""
from __future__ import annotations

import contextlib
from pathlib import Path

import torch

from foldbench import bench
from foldbench.traffic.generate import load_mix

SEED = 2**31 + 12345          # past 32 signed bits, as the seeds of a check
# torch's threads in a CPU run. The suite runs six workers on a few cores.
# A pool of every core waits at each parallel region for all of its threads,
# so beside one busy 8-thread process a 32-document batch took 10 s (16.9 s
# beside two, 38-40 s beside five; 0.14 s alone) and a 6 s window held a
# single batch; at two threads the window held 13 batches beside one.
THREADS = 2


def tiny(cell: str, prefill_docs: int = 32) -> tuple[dict, dict, dict]:
    """(spec, config, mix) of `cell`, made small."""
    spec = bench.load_spec()
    c = next(x for x in spec["workloads"] if x["name"] == cell)
    config = bench.load_config(c["config"])
    config["fold"]["capacity"] = 4096
    config["prefill"] = {"docs": prefill_docs, "batch_docs": 32, "seed": 11}
    mix = load_mix(c["traffic"])
    if mix["loop"] == "closed":
        mix["batch_docs"] = mix["warmup_docs"] = 32
    else:
        mix["warmup_docs"] = 16
        mix["rate_docs_per_s"] = 60.0
        config["service"]["max_batch"] = 16
    return spec, config, mix


@contextlib.contextmanager
def cpu_threads():
    """torch's intra-op pool held to at most THREADS threads inside."""
    old = torch.get_num_threads()
    torch.set_num_threads(min(THREADS, old))
    try:
        yield
    finally:
        torch.set_num_threads(old)


def tiny_run(cell: str, cache: Path, *, seconds: float = 2.0,
             trace: bool = False, control: bool = False, on_ready=None,
             seed: int = SEED, prefill_docs: int = 32,
             config_update: dict | None = None,
             pieces: Path = bench.HERE) -> dict:
    """One CPU run of `cell` made small; `config_update` replaces keys of
    its configuration, and the driver and reference are found under
    `pieces`."""
    spec, config, mix = tiny(cell, prefill_docs)
    config.update(config_update or {})
    with cpu_threads():
        return bench.run(cell, seed, seconds, trace, device="cpu", spec=spec,
                         config=config, mix=mix, cache=cache,
                         control=control, on_ready=on_ready,
                         log=lambda msg: None, pieces=pieces)
