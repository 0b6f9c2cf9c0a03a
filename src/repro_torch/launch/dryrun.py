"""Multi-pod dry run: one run of every (arch x shape x mesh) cell on the
meta device over a fake production mesh (the port's analog of
`repro/launch/dryrun.py`).

The reference lowers and compiles each cell onto 512 host placeholder
devices and reads XLA's memory and cost analyses. The port has no
compiler to ask, so it runs the step itself, once, where nothing is
allocated: by design this entry point runs on the meta device, over
torch's fake process group (`FakeStore`, a test-only torch API used here
and nowhere else in the port) of 256 or 512 ranks, all in this one
process. Per cell this:
  1. builds abstract params, moments, batch and caches (meta tensors),
     each distributed over the mesh as a DTensor with the plan's
     placements (every rank's block shape, nothing allocated),
  2. runs the train step (forward and backward, so remat's recompute is
     counted), the prefill or the decode step once under `CostMode`,
  3. records per device: FLOPs, bytes, collective and wire bytes
     (`launch/hlocost.py`), and the argument and output bytes of the
     rank's shards,
  4. writes experiments/dryrun_torch/<mesh>/<arch>__<shape>.json.

What the port cannot observe stays null, each with its reason: temp
bytes (meta tensors have no allocator), lower and compile times (nothing
is compiled). The `fold_dedup` cell is recorded as not measured: its
sharded step is data-dependent and does not run on meta tensors. A cell
that raises is a failure and the run exits 1.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import traceback

import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, cells_for
from repro_torch.dist import act
from repro_torch.dist.sharding import (P, batch_pspecs, cache_pspecs,
                                       distribute, dp_axes, make_plan)
from repro_torch.launch.hlocost import CostMode
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.common import abstract_params, tree_map, tree_size
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import OptConfig, OptState
from repro_torch.train.step import (make_decode_step, make_prefill_step,
                                    make_train_step)

__all__ = ["input_specs", "auto_grad_accum", "lower_cell", "fake_world",
           "main", "HBM_BUDGET", "FOLD_NOT_MEASURED", "TEMP_NULL"]

# 75% of the 80 GB of an NVIDIA H100 80GB HBM3: the share of HBM the
# reference's budget leaves a v5e (12 of 16 GB)
HBM_BUDGET = 60e9
HBM_BUDGET_DEVICE = "NVIDIA H100 80GB HBM3"

TEMP_NULL = ("meta tensors have no allocator: the port observes no "
             "temporary buffers, so none are recorded")
TIMES_NULL = "eager PyTorch lowers and compiles nothing"
FOLD_NOT_MEASURED = (
    "the sharded dedup step is data-dependent (HNSW beam searches whose "
    "steps read the state) and does not run on meta tensors, and a real "
    "10M-doc state of 256 shards does not fit one process; not measured")
BYTES_NOTE = ("unfused upper bound: the inputs and outputs of every "
              "non-view op, not a fused kernel's traffic")


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of `size` ranks (this process is rank 0),
    taken down on exit; a fake group of that size already up is kept."""
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == size):
            yield
            return
        raise RuntimeError("another process group is up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------- input specs
def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta stand-ins for every model input of the cell (the reference's
    int32 tokens)."""
    sh = SHAPES[shape_name]
    B, S = sh.batch, sh.seq
    f32, i32 = torch.float32, torch.int32

    def m(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    if sh.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            specs = {"frames": m((B, cfg.encoder_seq, cfg.d_model), f32),
                     "tokens": m((B, S), i32)}
        elif cfg.family == "vlm":
            specs = {"patch_embeds": m((B, cfg.prefix_len, cfg.d_model), f32),
                     "tokens": m((B, S - cfg.prefix_len), i32)}
        else:
            specs = {"tokens": m((B, S), i32)}
        if sh.kind == "train":
            lab_s = S if cfg.family != "vlm" else S - cfg.prefix_len
            specs["labels"] = m((B, lab_s), i32)
            specs["loss_mask"] = m((B, lab_s), f32)
        return specs
    # decode: one new token against a KV cache of length S
    return {"token": m((B,), i32), "pos": m((B,), i32)}


def _specs_for(cfg: ModelConfig):
    return (W.whisper_param_specs(cfg) if cfg.family == "encdec"
            else T.param_specs(cfg))


def _dp_size(mesh) -> int:
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a)) for a in dp_axes(mesh))


def auto_grad_accum(cfg: ModelConfig, sh, mesh) -> int:
    """Pick grad accumulation so the remat-saved layer carries fit
    `HBM_BUDGET`: the reference's model (temp ~= 4x the bf16 per-layer
    residual carries L * B_local * S * d, fitted on a TPU), halved per
    doubling, capped so each micro-batch still covers the DP axes."""
    if sh.kind != "train":
        return 1
    dp = _dp_size(mesh)
    b_loc = max(sh.batch // dp, 1)
    layers = cfg.n_layers + cfg.encoder_layers
    est = 4.0 * layers * b_loc * sh.seq * cfg.d_model * 2
    ga = 1
    while est / ga > HBM_BUDGET and ga < max(sh.batch // dp, 1):
        ga *= 2
    return ga


def _local_bytes(tree) -> int:
    """Bytes of this rank's blocks of a tree of (D)Tensors."""
    from torch.distributed.tensor import DTensor
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for k in t:
                walk(t[k])
        elif isinstance(t, (tuple, list)):
            for x in t:
                walk(x)
        elif isinstance(t, torch.Tensor):
            leaves.append(t.to_local() if isinstance(t, DTensor) else t)
    walk(tree)
    return sum(t.numel() * t.element_size() for t in leaves)


def _abstract_caches(cfg: ModelConfig, batch: int, smax: int):
    maker = (W.whisper_init_caches if cfg.family == "encdec"
             else T.init_caches)
    return maker(cfg, batch, smax, "meta")


# ------------------------------------------------------------------ one cell
def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               grad_accum: int | None = None, variant: str = "baseline",
               opt_overrides: dict | None = None) -> dict:
    """Run one cell once on the fake mesh; returns its record.

    variant:
      baseline — FSDP(embed->data) + TP(model); the paper-era default.
      zero1    — params TP-only (replicated over data), optimizer moments
                 FSDP-sharded.
    """
    if arch == "fold_dedup":
        mesh_tag = "2x16x16" if multi_pod else "16x16"
        return {"arch": "fold_dedup", "shape": shape_name, "kind": "dedup",
                "mesh": mesh_tag, "devices": 512 if multi_pod else 256,
                "n_params": 0, "measured": False,
                "not_measured_reason": FOLD_NOT_MEASURED}
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        return _run_cell(mesh, arch, shape_name, grad_accum, variant,
                         opt_overrides)


def _run_cell(mesh, arch, shape_name, grad_accum, variant, opt_overrides):
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    if grad_accum is None:
        grad_accum = auto_grad_accum(cfg, sh, mesh)
    plan = make_plan(cfg, mesh, fsdp=(variant != "zero1"))
    opt_plan = make_plan(cfg, mesh, fsdp=True)   # moments always sharded
    specs = _specs_for(cfg)
    params_abs = abstract_params(specs)
    n_params = tree_size(params_abs)
    params = distribute(params_abs, plan.params(specs), mesh,
                        src_data_rank=None)

    act.set_mesh(mesh)
    try:
        mode = CostMode()
        if sh.kind == "train":
            opt_cfg = OptConfig(state_dtype=("bfloat16" if cfg.param_dtype
                                             == "bfloat16" else "float32"),
                                **(opt_overrides or {}))
            zeros = tree_map(lambda p: torch.empty(
                p.shape, dtype=opt_cfg.sdt, device="meta"), params_abs)
            mv = opt_plan.params(specs)
            opt = OptState(m=distribute(zeros, mv, mesh, src_data_rank=None),
                           v=distribute(zeros, mv, mesh, src_data_rank=None),
                           step=torch.zeros((), dtype=torch.int32,
                                            device="meta"))
            batch = distribute(input_specs(cfg, shape_name),
                               batch_pspecs(cfg, mesh, "train", sh.batch),
                               mesh, src_data_rank=None)
            step = make_train_step(cfg, opt_cfg, grad_accum=grad_accum)
            args = (params, opt, batch)
            with mode:
                out = step(*args)
        elif sh.kind == "prefill":
            batch = distribute(input_specs(cfg, shape_name),
                               batch_pspecs(cfg, mesh, "prefill", sh.batch),
                               mesh, src_data_rank=None)
            args = (params, batch)
            with mode:
                out = make_prefill_step(cfg)(*args)
        else:  # decode
            caches_abs = _abstract_caches(cfg, sh.batch, sh.seq)
            caches = distribute(caches_abs, cache_pspecs(cfg, mesh, caches_abs,
                                                         sh.batch),
                                mesh, src_data_rank=None)
            b = batch_pspecs(cfg, mesh, "prefill", sh.batch)["tokens"][0]
            inp = distribute(input_specs(cfg, shape_name),
                             {"token": P(b), "pos": P(b)}, mesh,
                             src_data_rank=None)
            args = (params, caches, inp["token"], inp["pos"])
            with mode:
                out = make_decode_step(cfg)(*args)
    finally:
        act.clear()

    cost = mode.cost
    names = mesh.mesh_dim_names
    return {
        "arch": arch, "shape": shape_name, "kind": sh.kind,
        "grad_accum": grad_accum, "variant": variant,
        "mesh": "x".join(str(mesh.size(i)) for i in range(len(names))),
        "devices": mesh.size(), "n_params": int(n_params), "measured": True,
        "flops_per_device": cost.flops,
        "bytes_per_device": cost.bytes,
        "bytes_note": BYTES_NOTE,
        "collective_bytes_per_device": dict(cost.collectives),
        "wire_bytes_per_device": cost.wire_bytes,
        "memory_analysis": {
            "argument_size": _local_bytes(args),
            "output_size": _local_bytes(out),
            "temp_size": None,
            "generated_code_size": None,
        },
        "temp_size_null_reason": TEMP_NULL,
        "t_lower_s": None, "t_compile_s": None,
        "times_null_reason": TIMES_NULL,
        "hbm_budget_bytes": HBM_BUDGET,
        "hbm_budget_device": HBM_BUDGET_DEVICE,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for a in list_archs():
            for s in cells_for(a):
                cells.append((a, s))
        cells.append(("fold_dedup", "ingest_100k"))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape or --all")
        cells.append((args.arch, args.shape))

    mesh_tag = "pod2x16x16" if args.multi_pod else "pod16x16"
    outdir = os.path.join(args.out, mesh_tag)
    os.makedirs(outdir, exist_ok=True)
    failures = 0
    with fake_world(512 if args.multi_pod else 256):
        for arch, shape in cells:
            tag = f"{arch.replace('.', '_')}__{shape}"
            try:
                res = lower_cell(arch, shape, multi_pod=args.multi_pod)
                with open(os.path.join(outdir, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=1)
                if not res["measured"]:
                    print(f"NOT MEASURED {tag}: {res['not_measured_reason']}",
                          flush=True)
                    continue
                print(f"OK  {tag}: flops/dev={res['flops_per_device']:.3e} "
                      f"wire/dev={res['wire_bytes_per_device']:.3e}B "
                      f"args/dev={res['memory_analysis']['argument_size']:.3e}B",
                      flush=True)
            except Exception as e:   # a cell that cannot run: exit 1
                failures += 1
                act.clear()
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
