"""The prefilled index a cell's window starts from, built once per checkout
and restored by every later run.

The prefill is the configuration's `prefill` documents of the mix's preset,
from the configuration's own prefill seed, sent through the driver's
per-batch step (the program's own `process_batch` unless the driver gives
another) in batches of `prefill["batch_docs"]` and saved with the backend's
`save`. It is cached under `cache/prefill/<tree>-<params>/`:

  tree    hash of every file under `src/repro_torch/` and of the traffic
          generator, so that a changed program or generator never restores
          a snapshot another tree built;
  params  hash of every configuration key a driver or the program reads
          (all but the prose and the limits, `PROSE`) and of the preset's
          parameters.

A missing key builds; writing a new key removes the entries of other
trees. The entry holds the checkpoint, the prefill's verdicts (the
program's output, which the comparison reads to know what the program
admitted), the files the driver's `save_extra` wrote (state the driver
keeps beside the index, such as which slots expire when) and `meta.json`,
written last: an entry without it is not used. Every run, the first one
too, restores the saved snapshot, so the index a window starts from is the
same bytes in every run.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import time
from pathlib import Path

import numpy as np

from foldbench.traffic.corpus import DATASET_PRESETS
from foldbench.traffic.generate import prefill_batches

__all__ = ["PROSE", "tree_hash", "cache_key", "ensure", "restore"]

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# configuration keys that only describe or judge the deployment: nothing
# that builds the prefill reads them, so they stay out of its key
PROSE = ("source", "deployment", "guarantees", "limits", "reduced",
         "assumed")


def tree_hash(src: Path = ROOT / "src" / "repro_torch") -> str:
    """Hash of the program's sources and the traffic generator."""
    h = hashlib.sha256()
    files = sorted(p for p in src.rglob("*") if p.is_file()
                   and "__pycache__" not in p.parts)
    files += sorted((HERE / "traffic").glob("*.py"))
    for p in files:
        h.update(str(p.relative_to(ROOT)).encode())
        h.update(b"\0")
        h.update(p.read_bytes())
        h.update(b"\0")
    return h.hexdigest()[:16]


def cache_key(config: dict, mix: dict) -> str:
    params = {"config": {k: v for k, v in config.items() if k not in PROSE},
              "preset": dataclasses.asdict(DATASET_PRESETS[mix["preset"]])}
    p = hashlib.sha256(json.dumps(params, sort_keys=True).encode())
    return f"{tree_hash()}-{p.hexdigest()[:16]}"


def ensure(config: dict, mix: dict, cache_root: Path, make_pipeline,
           log, step=None, save_extra=None) -> Path:
    """The cache entry of this cell's prefill, built if missing.
    `make_pipeline()` gives a fresh pipeline of the configuration;
    `step(pipe, tokens, lengths) -> (keep, stats)`, where given, takes
    each prefill batch in place of `pipe.process_batch(tokens, lengths)`;
    `save_extra(pipe, directory)`, where given, writes the driver's own
    files into the entry before `meta.json`."""
    key = cache_key(config, mix)
    entry = cache_root / key
    if (entry / "meta.json").exists():
        return entry
    cache_root.mkdir(parents=True, exist_ok=True)
    staging = cache_root / f"{key}.partial"
    shutil.rmtree(staging, ignore_errors=True)
    t0 = time.perf_counter()
    pipe = make_pipeline()
    keeps = [(step(pipe, tokens, lengths) if step is not None
              else pipe.process_batch(tokens, lengths))[0]
             for tokens, lengths in prefill_batches(mix, config["prefill"])]
    pipe.save(str(staging), 0)
    np.save(staging / "keeps.npy", np.concatenate(keeps))
    if save_extra is not None:
        save_extra(pipe, staging)
    meta = {"key": key, "docs": int(sum(len(k) for k in keeps)),
            "admitted": int(sum(int(k.sum()) for k in keeps)),
            "build_s": time.perf_counter() - t0}
    (staging / "meta.json").write_text(json.dumps(meta))
    del pipe
    tree = key.split("-")[0]
    for old in cache_root.iterdir():
        if old.name != f"{key}.partial" and not old.name.startswith(tree):
            shutil.rmtree(old, ignore_errors=True)
    staging.rename(entry)
    log(f"prefill built: {meta}")
    return entry


def restore(pipe, entry: Path, load_extra=None) -> np.ndarray:
    """Restore the snapshot into `pipe`, then hand the entry to
    `load_extra(pipe, entry)`, where given, to read what `save_extra`
    wrote; returns the prefill's verdicts."""
    pipe.restore(str(entry))
    if load_extra is not None:
        load_extra(pipe, entry)
    return np.load(entry / "keeps.npy")
