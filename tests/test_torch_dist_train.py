"""Meshed training (`repro_torch.dist` under `make_train_step` and
`python -m repro_torch.launch.train --mesh`) on 4 gloo ranks on the CPU.

ONE module fixture starts `tests/_torch_dist_worker.py` in a subprocess:
it spawns 4 ranks on a (2, 2) ("data", "model") mesh, runs one train step
per case on params and a batch this module writes (numpy, from seeds),
gathers the results and writes them to `tmp_path` as npz, then runs the
training CLI with `--mesh 2,2` on the same group. Every rank destroys its
process group; this process never starts one.

The step is held against the port's one-device step and, for REDUCED
qwen1.5-4b, JAX's jitted `make_train_step` on one device, both fed the
same numpy params, with the tolerances of the reference's
`tests/test_dist.py::test_spmd_train_4dev_matches_1dev`: loss 1e-3, params
2e-3 (lr 1e-3 with one warm-up step moves each param by lr times about
+-1, so a gradient sign that rounds the other way lands just under 2e-3).
REDUCED qwen1.5-4b and falcon-mamba-7b (its `ssm_inner` over "model") run
at their bf16 compute. REDUCED grok-1-314b (its experts over "data") runs
at f32 compute: at bf16 a product whose contraction dim is sharded over
"model" is summed from bf16 partial sums, which round otherwise than one
device's single bf16 matmul, and a near-tied expert choice can flip and
move the loss by more than 1e-3. At f32 the meshed step equals one
device's to rounding.

The CLI runs `--mesh 2,2` on the REDUCED config at f32 compute (both
runs read `f32_reduced_config`): its two losses equal the unmeshed CLI's
within 1e-3. At bf16 the second step's loss can differ by more: Adam's
first step moves each param by +-lr, so every gradient whose sign is
within bf16 rounding of zero moves the other way (CPU bf16 matmuls also
round by their local shapes)."""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.train import OptConfig as JaxOptConfig
from repro.train import make_train_step as jax_make_train_step
from repro.train import opt_init as jax_opt_init
from repro_torch.configs import reduced_config
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import main
from repro_torch.models import transformer as T
from repro_torch.models.common import params_from_numpy, tree_leaves
from repro_torch.train import OptConfig, make_train_step, opt_init

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
from _torch_dist_worker import (CASES, CLI, OPT, f32_reduced_config,  # noqa: E402
                                flatten, unflatten)

B, S = 4, 32


def _numpy_params(specs, seed: int) -> dict:
    """Seeded numpy params by the specs' init rules (normal * std, zeros,
    ones), leaf by leaf in sorted-key order."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if t.init == "zeros":
            return np.zeros(t.shape, np.float32)
        if t.init == "ones":
            return np.ones(t.shape, np.float32)
        fan = int(np.prod([t.shape[a] for a in t.fan_in_axes])) \
            if t.fan_in_axes else 0
        std = t.scale if t.scale is not None else (
            1.0 / np.sqrt(max(fan, 1)) if fan else 0.02)
        return (rng.standard_normal(t.shape) * std).astype(np.float32)

    return walk(specs)


def _cfg(arch: str):
    return dataclasses.replace(reduced_config(arch),
                               compute_dtype=CASES[arch])


def _inputs() -> dict:
    flat = {}
    for i, arch in enumerate(CASES):
        cfg = _cfg(arch)
        for k, v in flatten(_numpy_params(T.param_specs(cfg), i)).items():
            flat[f"{arch}|p|{k}"] = v
        t = np.random.default_rng(10 + i).integers(0, cfg.vocab, (B, S + 1))
        flat[f"{arch}|b|tokens"] = t[:, :-1]
        flat[f"{arch}|b|labels"] = t[:, 1:]
        flat[f"{arch}|b|loss_mask"] = np.ones((B, S), np.float32)
    return flat


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_train")
    inputs = _inputs()
    np.savez(out / "inputs.npz", **inputs)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = str(sk.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_dist_worker.py"),
         str(out), port], capture_output=True, text=True, env=env,
        timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return inputs, dict(np.load(out / "results.npz")), out


def _one_device(arch: str, inputs: dict):
    cfg = _cfg(arch)
    params = params_from_numpy(unflatten(inputs, f"{arch}|p|"), device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in unflatten(inputs, f"{arch}|b|").items()}
    oc = OptConfig(**OPT)
    opt = opt_init(params, oc)
    params, opt, met = make_train_step(cfg, oc)(params, opt, batch)
    return params, opt, met


def _max_diff(tree, res, arch, tag) -> float:
    return max(float(np.max(np.abs(t.numpy() - res[f"{arch}|{tag}|{k}"])))
               for k, t in flatten(tree).items())


@pytest.mark.parametrize("arch", list(CASES))
def test_meshed_step_matches_one_device(meshed, arch):
    inputs, res, _ = meshed
    params, opt, met = _one_device(arch, inputs)
    assert abs(float(met["loss"]) - float(res[f"{arch}|loss"])) < 1e-3
    assert _max_diff(params, res, arch, "p") < 2e-3
    # the moments see the gradients themselves
    assert _max_diff(opt.m, res, arch, "m") < 2e-3
    assert abs(float(met["grad_norm"]) - float(res[f"{arch}|grad_norm"])) \
        < 1e-2 * float(met["grad_norm"])


def test_meshed_qwen_step_matches_jax(meshed):
    arch = "qwen1.5-4b"
    inputs, res, _ = meshed
    cfg = jax_reduced_config(arch)
    params = jax.tree.map(jnp.asarray, unflatten(inputs, f"{arch}|p|"))
    batch = {k: jnp.asarray(v, jnp.float32 if k == "loss_mask"
                            else jnp.int32)
             for k, v in unflatten(inputs, f"{arch}|b|").items()}
    oc = JaxOptConfig(**OPT)
    p1, _, m1 = jax.jit(jax_make_train_step(cfg, oc))(
        params, jax_opt_init(params, oc), batch)
    assert abs(float(m1["loss"]) - float(res[f"{arch}|loss"])) < 1e-3
    d = max(float(np.max(np.abs(np.asarray(v) - res[f"{arch}|p|{k}"])))
            for k, v in flatten(p1).items())
    assert d < 2e-3


def test_every_rank_holds_the_plans_blocks(meshed):
    _, res, _ = meshed
    for arch in CASES:
        # params, m and v: each rank's local shape is the plan's, and the
        # moments are placed as the params (all 4 ranks agreed)
        assert int(res[f"{arch}|local_ok"]) == 4


def test_meshed_cli_matches_the_unmeshed_cli_and_resumes_one_device(
        meshed, tmp_path, monkeypatch):
    _, res, out = meshed
    monkeypatch.setattr(launch_train, "reduced_config", f32_reduced_config)
    assert int(res["cli|dtensor"]) == 1
    plain_args = [a for a in CLI if a not in ("--mesh", "2,2")]
    plain = main(plain_args + ["--ckpt-dir", str(tmp_path / "plain")])
    got = np.array([r["loss"] for r in plain.log])
    assert np.max(np.abs(got - res["cli|loss"])) < 1e-3
    # the meshed run's checkpoint (step 2, gathered by rank 0) resumes the
    # one-device trainer
    three = [("3" if a == "2" and plain_args[i - 1] == "--steps" else a)
             for i, a in enumerate(plain_args)]
    resumed = main(three + ["--ckpt-dir", str(out / "cli")])
    assert resumed.resumed_from == 2 and resumed.mesh is None
    assert all(isinstance(t, torch.Tensor) and type(t) is torch.Tensor
               for t in tree_leaves(resumed.trainer.params))
