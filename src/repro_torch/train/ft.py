"""Fault tolerance for long runs (port of `repro/train/ft.py`).

  * checkpoint/restart: `ElasticTrainer` checkpoints every `ckpt_every`
    steps (async), survives injected failures, and resumes from the
    latest committed step with bit-exact state (tests/test_torch_train.py;
    on a card under `torch.use_deterministic_algorithms(True)`, since the
    backward of an index or a gather adds with atomics there).
  * deterministic data: where `make_batch(step)` depends on the step
    only, a resumed run consumes exactly the batches it would have
    (`launch.train`'s batches depend on the step only within one process).
  * checkpoints are the reference's layout (`repro_torch.train.checkpoint`),
    so a run saved by either package resumes in the other.
  * `StepWatchdog` flags stragglers at K x the trailing median step time.

The train step updates params and moments in place, so a resume copies
the restored leaves into the trainer's tensors, on their device and in
their dtype. On a mesh (DTensor leaves) every rank gathers each leaf and
rank 0 alone writes it, in the one-device layout, so a meshed run's
checkpoint restores into the one-device trainer and back; a resume keeps
each rank's block of the restored leaf.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.train import checkpoint as ckpt

__all__ = ["ElasticTrainer", "StepWatchdog"]


class StepWatchdog:
    """Tracks step latencies; flags stragglers at K x trailing-p50."""

    def __init__(self, factor: float = 3.0, window: int = 50):
        self.factor = factor
        self.window = window
        self.history: list[float] = []

    def observe(self, dt: float) -> bool:
        self.history.append(dt)
        hist = self.history[-self.window:]
        if len(hist) < 10:
            return False
        p50 = float(np.median(hist[:-1]))
        return dt > self.factor * p50


class ElasticTrainer:
    """Checkpointed training loop with failure injection for tests.

    `make_batch(step) -> batch` must be deterministic in `step` so that
    resume replays the exact stream.
    """

    def __init__(self, train_step, params, opt_state, make_batch,
                 ckpt_dir: str, ckpt_every: int = 10, async_save: bool = True):
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.make_batch = make_batch
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.async_save = async_save
        self.step = 0
        self.watchdog = StepWatchdog()
        self.metrics_log: list[dict] = []

    def _tree(self) -> dict:
        return {"params": self.params, "opt": self.opt_state}

    def maybe_resume(self) -> bool:
        last = ckpt.latest_step(self.ckpt_dir)
        if last is None:
            return False
        tree = self._tree()
        saved = ckpt.restore(self.ckpt_dir, last, tree)
        with torch.no_grad():
            for t, a in zip(ckpt._flatten(tree), ckpt._flatten(saved)):
                src = torch.as_tensor(a)
                if src.shape != t.shape or src.dtype != t.dtype:
                    raise ValueError(
                        f"checkpoint leaf {tuple(src.shape)} {src.dtype} "
                        f"does not fit {tuple(t.shape)} {t.dtype}")
                if isinstance(t, DTensor):
                    # every rank read the same file: keep its own block
                    src = distribute_tensor(src.to(t.device), t.device_mesh,
                                            t.placements, src_data_rank=None)
                    t = t.to_local()
                    src = src.to_local()
                t.copy_(src)
        self.step = last
        return True

    def _save(self) -> None:
        tree = self._tree()
        leaves = ckpt._flatten(tree)
        if any(isinstance(t, DTensor) for t in leaves):
            # a collective on every rank, then rank 0 writes
            tree = ckpt._unflatten(tree, [
                t.full_tensor() if isinstance(t, DTensor) else t
                for t in leaves])
            if dist.get_rank() != 0:
                return
        if self.async_save:
            ckpt.save_async(self.ckpt_dir, self.step, tree)
        else:
            ckpt.save(self.ckpt_dir, self.step, tree)

    def run(self, n_steps: int, *, fail_at: int | None = None):
        """Run to self.step == n_steps; raises RuntimeError at `fail_at`
        (failure injection for tests) AFTER completing that step's compute
        but before its checkpoint — the worst-case loss window."""
        while self.step < n_steps:
            t0 = time.perf_counter()
            batch = self.make_batch(self.step)
            t_batch = time.perf_counter() - t0
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            logged = {k: float(v) for k, v in metrics.items()}  # the sync
            self.step += 1
            dt = time.perf_counter() - t0
            # batch_s: the part of dt spent making the batch (the dedup
            # ingest when the packer runs dry)
            self.metrics_log.append({"step": self.step, "dt": dt,
                                     "batch_s": t_batch, **logged})
            if self.watchdog.observe(dt):
                self.metrics_log[-1]["straggler"] = True
            if fail_at is not None and self.step == fail_at:
                raise RuntimeError(f"injected failure at step {self.step}")
            if self.step % self.ckpt_every == 0:
                self._save()
        ckpt.wait_pending()
        return self.metrics_log
