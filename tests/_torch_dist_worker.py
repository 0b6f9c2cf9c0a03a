"""Four gloo ranks on the CPU for tests/test_torch_dist_train.py.

  python tests/_torch_dist_worker.py OUTDIR PORT

Reads OUTDIR/inputs.npz (params and a batch per case, written by the
test), spawns 4 ranks on a (2, 2) ("data", "model") mesh over gloo, and on
each rank: distributes the params by `make_plan` and the batch by
`batch_pspecs`, runs one meshed train step, checks every param's and
moment's local block against the plan, gathers the results and (rank 0)
writes them to OUTDIR/results.npz; then runs the training CLI with
`--mesh 2,2` on the same group at f32 compute and (rank 0) writes its
losses. Imports
nothing of JAX."""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CASES = {"qwen1.5-4b": "bfloat16", "falcon-mamba-7b": "bfloat16",
         "grok-1-314b": "float32"}
OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=10)
CLI = ["--device", "cpu", "--mesh", "2,2", "--steps", "2", "--batch", "4",
       "--seq", "32", "--ckpt-every", "2"]


def f32_reduced_config(arch: str):
    """The REDUCED config at f32 compute: the CLI runs on it here."""
    from repro_torch.configs import reduced_config
    return dataclasses.replace(reduced_config(arch), compute_dtype="float32")


def unflatten(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _block(shape: tuple, spec) -> tuple:
    """The block shape `spec` gives a rank of the (2, 2) mesh."""
    out = list(shape)
    for d, part in enumerate(spec):
        if part is not None:
            out[d] //= 2 ** len(part if isinstance(part, tuple) else (part,))
    return tuple(out)


def _rank(rank: int, outdir: str, port: str) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port,
                      RANK=str(rank), WORLD_SIZE="4", LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import reduced_config
    from repro_torch.dist import act
    from repro_torch.dist.sharding import batch_pspecs, distribute, make_plan
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.models.common import params_from_numpy, tree_leaves
    from repro_torch.train import OptConfig, make_train_step, opt_init

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    inputs = dict(np.load(os.path.join(outdir, "inputs.npz")))
    res: dict[str, np.ndarray] = {}
    try:
        for arch, cdt in CASES.items():
            cfg = dataclasses.replace(reduced_config(arch), compute_dtype=cdt)
            specs = T.param_specs(cfg)
            pspecs = make_plan(cfg, mesh).params(specs)
            params = distribute(
                params_from_numpy(unflatten(inputs, f"{arch}|p|"),
                                  device="cpu"),
                pspecs, mesh, src_data_rank=None)
            batch = distribute(
                {k: torch.from_numpy(v) for k, v in
                 unflatten(inputs, f"{arch}|b|").items()},
                batch_pspecs(cfg, mesh, "train", 4), mesh)
            oc = OptConfig(**OPT)
            opt = opt_init(params, oc)
            act.set_mesh(mesh)
            try:
                params, opt, met = make_train_step(cfg, oc)(params, opt,
                                                            batch)
            finally:
                act.clear()
            ok = all(
                tuple(t.to_local().shape) == _block(tuple(t.shape), s)
                and t.placements == m.placements == v.placements
                for t, m, v, s in zip(tree_leaves(params),
                                      tree_leaves(opt.m), tree_leaves(opt.v),
                                      tree_leaves(pspecs)))
            oks = [torch.tensor(int(ok))]
            dist.all_reduce(oks[0])
            res[f"{arch}|local_ok"] = np.int64(oks[0])
            for tag, tree in (("p", params), ("m", opt.m), ("v", opt.v)):
                for name, t in flatten(tree).items():
                    res[f"{arch}|{tag}|{name}"] = t.full_tensor().numpy()
            res[f"{arch}|loss"] = met["loss"].numpy()
            res[f"{arch}|grad_norm"] = met["grad_norm"].numpy()
        launch_train.reduced_config = f32_reduced_config
        run = launch_train.main(CLI + ["--ckpt-dir",
                                       os.path.join(outdir, "cli")])
        res["cli|loss"] = np.array([r["loss"] for r in run.log])
        res["cli|grad_norm"] = np.array([r["grad_norm"] for r in run.log])
        res["cli|dtensor"] = np.int64(all(
            type(t).__name__ == "DTensor"
            for t in tree_leaves(run.trainer.params)))
        if rank == 0:
            np.savez(os.path.join(outdir, "results.npz"), **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(_rank, args=(sys.argv[1], sys.argv[2]), nprocs=4)
