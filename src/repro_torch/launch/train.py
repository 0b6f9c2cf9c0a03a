"""Training entry point: FOLD-deduplicated corpus -> packed batches -> LM
training (port of `repro/launch/train.py`).

The end-to-end production path: a streaming corpus is deduplicated online
by FOLD (the port's `DedupIngest`, or its `DedupService` with
`--service`), admitted docs are packed into fixed-shape batches, and the
selected architecture trains with checkpoints and elastic resume
(`ElasticTrainer`). Weights are drawn from a seeded generator; nothing is
downloaded.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
      --steps 50 --batch 8 --seq 256 --ckpt-dir runs/run1 [--device cpu]

With no `--device` it runs on the card and raises without one. The
default is a REDUCED config; `--full` takes the full one. `--mesh` (the
reference's data/model mesh) needs the port's `dist/` on several cards,
which does not exist yet, and is refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.dedup import FoldConfig
from repro_torch.data import (DATASET_PRESETS, DedupIngest, PackedBatches,
                              SyntheticCorpus)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params, tree_size
from repro_torch.models.config import ModelConfig
from repro_torch.train import (ElasticTrainer, OptConfig, make_train_step,
                               opt_init)

__all__ = ["TrainRun", "make_ingest", "make_batch_fn", "main"]

MESH_REFUSED = ("--mesh needs the port's dist/ (shards on several cards), "
                "which is ROADMAP.md queue 1, item 9; the port trains on "
                "one device")


def make_ingest(cfg: ModelConfig, dataset: str, *, dedup: bool = True,
                service: bool = False, backend: str = "hnsw",
                device=None):
    """(source, ingest): the corpus preset with the model's vocab, and its
    dedup stage (None without dedup) on `device`, over the index the
    reference's `launch/train.py` sets."""
    fold_cfg = FoldConfig(capacity=1 << 15, ef_construction=48, ef_search=48,
                          threshold_space="minhash")
    corpus_cfg = dataclasses.replace(DATASET_PRESETS[dataset],
                                     vocab=cfg.vocab)  # ids within model vocab
    src = SyntheticCorpus(corpus_cfg)
    if not dedup:
        return src, None
    if service:
        from repro_torch.service import DedupService, ServiceConfig
        svc = DedupService(ServiceConfig(fold=fold_cfg, max_batch=256,
                                         max_wait_ms=0.0, backend=backend,
                                         device=device))  # foldlint: disable=F141 (the port's ServiceConfig adds device)
        return src, DedupIngest(src, service=svc)
    return src, DedupIngest(src, fold_cfg, backend=backend, device=device)


def make_batch_fn(src, ingest, batch: int, seq: int, device):
    """make_batch(step) -> {tokens, labels, loss_mask} on `device`, packed
    from admitted docs pulled 256 at a time. Batches are cached per step in
    this process, so a resume within it replays them. A `main` started
    anew (a resume in a new process) has a new corpus, index and cache:
    its first step trains on the stream's first batch, as the reference's
    `launch/train.py` does."""
    packer = PackedBatches(batch=batch, seq_len=seq + 1)

    def fill_packer():
        while True:
            if ingest is None:
                toks, lens, _ = src.next_batch(256)
            else:
                toks, lens, _stats = ingest.next_clean_batch(256)
            packer.add_docs(toks, lens)
            b = packer.pop_batch()
            if b is not None:
                return b

    cache: dict[int, dict] = {}

    def make_batch(step: int) -> dict:
        if step not in cache:
            tokens, mask = fill_packer()
            cache[step] = {
                "tokens": torch.as_tensor(tokens[:, :-1], dtype=torch.int64,
                                          device=device),
                "labels": torch.as_tensor(tokens[:, 1:], dtype=torch.int64,
                                          device=device),
                "loss_mask": torch.as_tensor(mask[:, 1:], dtype=torch.float32,
                                             device=device)}
        return cache[step]

    make_batch.cache = cache
    return make_batch


@dataclasses.dataclass
class TrainRun:
    cfg: ModelConfig
    trainer: ElasticTrainer
    log: list                  # the trainer's metrics log, one row a step
    seconds: float             # wall time of the run, ingest included
    tokens_per_s: float        # steps * batch * seq / seconds
    ingest: DedupIngest | None
    batches: dict              # step -> the batch it trained on
    n_params: int
    resumed_from: int | None


def main(argv: list[str] | None = None) -> TrainRun:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--full", action="store_true",
                    help="use the full (paper-exact) config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--dataset", default="common_crawl")
    ap.add_argument("--no-dedup", action="store_true")
    ap.add_argument("--service", action="store_true",
                    help="service-backed dedup ingestion: micro-batched, "
                         "pipelined, auto-growing index (repro_torch.service)")
    ap.add_argument("--dedup-backend", default="hnsw",
                    help="repro_torch.index registry key for the dedup index "
                         "(hnsw, dpk, flat_lsh, prefix_filter, hnsw_raw, "
                         "brute, hnsw_sharded)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="", help="refused: see ROADMAP.md "
                    "queue 1, item 9")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.mesh:
        ap.error(MESH_REFUSED)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    if cfg.family == "encdec":
        ap.error("use whisper example for encdec")
    print(f"arch={cfg.name} family={cfg.family} reduced={not args.full} "
          f"device={device}")

    # ---- data: FOLD-deduplicated ingestion ------------------------------
    src, ingest = make_ingest(cfg, args.dataset, dedup=not args.no_dedup,
                              service=args.service,
                              backend=args.dedup_backend, device=device)
    make_batch = make_batch_fn(src, ingest, args.batch, args.seq, device)

    # ---- model + optimizer ----------------------------------------------
    params = init_params(T.param_specs(cfg),
                         torch.Generator(device).manual_seed(0), device)
    n_params = tree_size(params)
    print(f"params: {n_params/1e6:.1f} M")
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                        decay_steps=args.steps)
    opt_state = opt_init(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, grad_accum=args.grad_accum)

    # ---- loop with checkpoint/restart -----------------------------------
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             f"fold_{cfg.name}")
    tr = ElasticTrainer(step_fn, params, opt_state, make_batch, ckpt_dir,
                        ckpt_every=args.ckpt_every)
    resumed = None
    if tr.maybe_resume():
        resumed = tr.step
        print(f"resumed from step {tr.step}")
    t0 = time.perf_counter()
    log = tr.run(args.steps)
    dt = time.perf_counter() - t0
    tok_s = args.steps * args.batch * args.seq / dt
    print(f"done: {args.steps} steps in {dt:.1f}s ({tok_s:.0f} tok/s)")
    print("loss first->last:",
          round(log[0]["loss"], 3), "->", round(log[-1]["loss"], 3))
    if ingest is not None:
        print(f"dedup: admitted {ingest.total_admitted}/{ingest.total_in} docs")
    return TrainRun(cfg, tr, log, dt, tok_s, ingest, make_batch.cache,
                    n_params, resumed)


if __name__ == "__main__":
    main()
