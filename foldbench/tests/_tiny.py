"""Cells cut to a size a CPU test run holds: the same files, with the
index, the prefill, the batches and the load made small."""
from __future__ import annotations

from pathlib import Path

from foldbench import bench
from foldbench.traffic.generate import load_mix

SEED = 2**31 + 12345          # past 32 signed bits, as the seeds of a check


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


def tiny_run(cell: str, cache: Path, *, seconds: float = 2.0,
             trace: bool = False, control: bool = False, on_ready=None,
             seed: int = SEED, prefill_docs: int = 32) -> dict:
    spec, config, mix = tiny(cell, prefill_docs)
    return bench.run(cell, seed, seconds, trace, device="cpu", spec=spec,
                     config=config, mix=mix, cache=cache, control=control,
                     on_ready=on_ready, log=lambda msg: None)
