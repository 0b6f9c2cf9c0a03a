"""The port's LM examples against the reference's: `train_dedup_lm` and
`serve_demo` (`examples/*_torch.py` against `examples/*.py`), each run in
this process with the same small flags (the reference through `sys.argv`,
the port with `--device cpu`).

train_dedup_lm at `--tiny --steps 2 --batch 2 --seq 64` (demo-2m, bf16
compute). The two draw their weights differently (`PRNGKey(0)` against a
torch generator), so the port example's `init_params` name is replaced by
one that returns the reference example's own weights through
`params_from_numpy`. The reference's train step runs under
`jax.disable_jit()` (the example's `jax` name is replaced by one whose
`jit` calls the step eagerly): XLA keeps f32 between fused bf16 ops, and the 1e-3
relative bound on the first step's loss is the one
tests/test_torch_train_grads.py holds dense models to against the
reference run op by op (the gap measured here is 3.3e-05; jitted, the
reference stands 1.8e-04 away). Later losses are not held: Adam's first step
turns gradient noise into lr * sign(g). The dedup line (admitted/in) and
the parameter count are exact.

serve_demo at `--arch zamba2-7b --batch 2 --prompt-len 4 --gen 4` (the
REDUCED config its docstring names): the same arch, parameter count and
cache length, finite logits and a full run; the tokens are not compared
(different weights; tests/test_torch_serve.py holds `generate` against
JAX).
"""
from __future__ import annotations

import os
import re
import sys

import jax
import numpy as np
import torch

from repro_torch.models.common import params_from_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_examples_util import run_example, run_reference  # noqa: E402

TRAIN_FLAGS = ["--tiny", "--steps", "2", "--batch", "2", "--seq", "64"]
SERVE_FLAGS = ["--arch", "zamba2-7b", "--batch", "2", "--prompt-len", "4",
               "--gen", "4"]
FIRST_LOSS_RTOL = 1e-3


class _EagerJax:
    """The reference example's `jax`, whose `jit` gives a function that
    runs the step under `jax.disable_jit()` and records its loss."""

    def __init__(self, losses: list):
        self.losses = losses

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **_):
        def eager(*args):
            with jax.disable_jit():
                out = fn(*args)
            self.losses.append(float(out[2]["loss"]))
            return out
        return eager


def test_train_dedup_lm_matches_the_reference():
    ref = {"losses": []}

    def ref_setup(ns):
        init = ns["init_params"]

        def keep(*a, **k):
            ref["params"] = init(*a, **k)
            return ref["params"]
        ns["init_params"] = keep
        ns["jax"] = _EagerJax(ref["losses"])

    want = run_reference("train_dedup_lm", argv=TRAIN_FLAGS, setup=ref_setup)
    ours = []

    def port_setup(mod):
        make_step = mod.make_train_step

        def recording(*a, **k):
            step = make_step(*a, **k)

            def run(*args):
                out = step(*args)
                ours.append(float(out[2]["loss"]))
                return out
            return run
        mod.init_params = lambda specs, gen, device: params_from_numpy(
            jax.tree.map(np.asarray, ref["params"]), device=device)
        mod.make_train_step = recording

    got = run_example("train_dedup_lm", TRAIN_FLAGS + ["--device", "cpu"],
                      setup=port_setup)["text"]
    assert len(ours) == len(ref["losses"]) == 2
    assert abs(ours[0] - ref["losses"][0]) <= FIRST_LOSS_RTOL * abs(
        ref["losses"][0]), (ours, ref["losses"])
    assert np.isfinite(ours).all()
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w) == 3
    assert g[0] == w[0] == "model: 8.7M params"
    assert g[1].startswith("step    0 loss ") and w[1].startswith(
        "step    0 loss ")
    dedup = re.compile(r"^loss [\d.]+ -> [\d.]+; dedup admitted (\d+)/(\d+)$")
    assert dedup.match(g[2]).groups() == dedup.match(w[2]).groups()


def test_serve_demo_matches_the_reference():
    want = run_reference("serve_demo", argv=SERVE_FLAGS)
    got = run_example("serve_demo", SERVE_FLAGS + ["--device", "cpu"])["text"]
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w) == 3
    assert g[0] == w[0] + " device=cpu"
    assert w[0].startswith("arch=zamba2-7b params=")
    shape = re.compile(r"prefill 4 steps: [\d.]+s \| decode 3 steps: "
                       r"[\d.]+s \([\d.]+ tok/s batched\)$")
    assert shape.match(g[1]) and shape.match(w[1])
    tokens = re.compile(r"sample tokens: \[(\d+), (\d+), (\d+), (\d+)\]$")
    assert tokens.match(g[2]) and tokens.match(w[2])
    assert torch.get_default_device().type == "cpu"
