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
default is a REDUCED config; `--full` takes the full one.

`--mesh D,M` (or `P,D,M`, or `D`) trains on a ("data", "model") mesh
(("pod", "data", "model") with three dims) through `repro_torch.dist`:
params and moments are DTensors placed by `make_plan`, the batch by
`batch_pspecs`, and the activations anchored as in the reference. torch
runs one process per rank: a mesh of several ranks runs under `torchrun`
(NCCL on the card, gloo with `--device cpu`), and the mesh's size must
equal `WORLD_SIZE`; a one-rank mesh starts its own one-rank group.
Every rank draws the same seeded params and keeps its shard; rank 0
alone runs the FOLD ingest and scatters each batch, so the dedup
verdicts are those of one ingest; checkpoints are gathered and written
by rank 0 in the one-device layout.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
      --mesh 2,2 --steps 2 --batch 4 --seq 32
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import socket
import tempfile
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.dedup import FoldConfig
from repro_torch.data import (DATASET_PRESETS, DedupIngest, PackedBatches,
                              SyntheticCorpus)
from repro_torch.device import resolve_device
from repro_torch.dist import act
from repro_torch.dist.sharding import batch_pspecs, distribute, make_plan
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params, tree_size
from repro_torch.models.config import ModelConfig
from repro_torch.train import (ElasticTrainer, OptConfig, make_train_step,
                               opt_init)

__all__ = ["TrainRun", "make_ingest", "make_batch_fn", "make_mesh", "main"]


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


def make_mesh(spec: str, device: torch.device) -> tuple[DeviceMesh, bool]:
    """(mesh, started): the `--mesh` shape over the default process
    group, which is started here when none is up (`started`): from
    torchrun's environment, or as a one-rank group on a free localhost
    port. NCCL on the card, gloo on the CPU; nothing falls back."""
    shape = tuple(int(x) for x in spec.split(","))
    axes = mesh_axes(len(shape))
    started = not dist.is_initialized()
    if started:
        backend = "nccl" if device.type == "cuda" else "gloo"
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, world_size=world,
                                    rank=int(os.environ["RANK"]))
        else:
            if world != 1:
                raise RuntimeError("a mesh of several ranks runs under "
                                   "torchrun")
            with socket.socket() as sk:
                sk.bind(("localhost", 0))
                port = sk.getsockname()[1]
            dist.init_process_group(backend, world_size=1, rank=0,
                                    init_method=f"tcp://localhost:{port}")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"--mesh {spec} has {math.prod(shape)} ranks; the "
                         f"process group has {dist.get_world_size()}")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    return init_device_mesh(device.type, shape, mesh_dim_names=axes), started


def _meshed_batches(make_batch, cfg: ModelConfig, mesh: DeviceMesh,
                    batch: int, seq: int, device):
    """make_batch(step) for a meshed run: rank 0 packs the batch from its
    ingest; every rank receives its block (`batch_pspecs`), scattered from
    rank 0."""
    specs = batch_pspecs(cfg, mesh, "train", batch)
    dtypes = {"tokens": torch.int64, "labels": torch.int64,
              "loss_mask": torch.float32}
    cache: dict[int, dict] = {}

    def meshed(step: int) -> dict:
        if step not in cache:
            if dist.get_rank() == 0:
                full = make_batch(step)
            else:
                full = {k: torch.empty((batch, seq), dtype=dt, device=device)
                        for k, dt in dtypes.items()}
            cache[step] = distribute(full, specs, mesh, src_data_rank=0)
        return cache[step]

    meshed.cache = cache
    return meshed


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
    mesh: DeviceMesh | None    # the --mesh run's mesh, else None


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
    ap.add_argument("--mesh", default="",
                    help="e.g. 4,2 for (data,model), 2,4,2 for "
                         "(pod,data,model); several ranks need torchrun")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    if cfg.family == "encdec":
        ap.error("use whisper example for encdec")
    mesh, started = (make_mesh(args.mesh, device) if args.mesh
                     else (None, False))
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"arch={cfg.name} family={cfg.family} reduced={not args.full} "
        f"device={device}" + (f" mesh={args.mesh}" if mesh else ""))

    # ---- data: FOLD-deduplicated ingestion (rank 0 alone on a mesh) ------
    ingest = None
    make_batch = None
    if lead:
        src, ingest = make_ingest(cfg, args.dataset, dedup=not args.no_dedup,
                                  service=args.service,
                                  backend=args.dedup_backend, device=device)
        make_batch = make_batch_fn(src, ingest, args.batch, args.seq, device)

    # ---- model + optimizer ----------------------------------------------
    specs = T.param_specs(cfg)
    params = init_params(specs, torch.Generator(device).manual_seed(0),
                         device)
    n_params = tree_size(params)
    say(f"params: {n_params/1e6:.1f} M")
    if mesh is not None:
        # every rank drew the same params: each keeps its own block
        params = distribute(params, make_plan(cfg, mesh).params(specs), mesh,
                            src_data_rank=None)
        make_batch = _meshed_batches(make_batch, cfg, mesh, args.batch,
                                     args.seq, device)
        act.set_mesh(mesh)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                        decay_steps=args.steps)
    # moments placed as the params (make_plan's fsdp=True placements)
    opt_state = opt_init(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, grad_accum=args.grad_accum)

    # ---- loop with checkpoint/restart -----------------------------------
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             f"fold_{cfg.name}")
    tr = ElasticTrainer(step_fn, params, opt_state, make_batch, ckpt_dir,
                        ckpt_every=args.ckpt_every)
    try:
        resumed = None
        if tr.maybe_resume():
            resumed = tr.step
            say(f"resumed from step {tr.step}")
        t0 = time.perf_counter()
        log = tr.run(args.steps)
        dt = time.perf_counter() - t0
    finally:
        if mesh is not None:
            act.clear()
        if started:
            dist.destroy_process_group()
    tok_s = args.steps * args.batch * args.seq / dt
    say(f"done: {args.steps} steps in {dt:.1f}s ({tok_s:.0f} tok/s)")
    say("loss first->last:",
        round(log[0]["loss"], 3), "->", round(log[-1]["loss"], 3))
    if ingest is not None:
        say(f"dedup: admitted {ingest.total_admitted}/{ingest.total_in} docs")
    return TrainRun(cfg, tr, log, dt, tok_s, ingest, make_batch.cache,
                    n_params, resumed, mesh)


if __name__ == "__main__":
    main()
