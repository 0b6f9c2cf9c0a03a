"""The port's training substrate (`repro_torch.train`: optimizer, step,
checkpoint, ft) held against the JAX package on the CPU, and the
reference's own training tests (tests/test_train.py) run on the port.

Weights are the reference's `init_params(..., PRNGKey(0))` carried over
with `params_from_numpy`; batches come from `np.random.default_rng`.

Tolerances:
  * `lr_at`: 1 f32 ulp (the cosine is computed by two libraries).
  * `opt_update` on the same params, grads and state: rtol=1e-6 on
    params, m and v (each product and sum rounds in the reference's
    order; XLA may contract a product and a sum into one FMA), atol 1e-6
    of each leaf's largest |value| (a value cancelled near 0 has no
    relative bound); `step` exact; with bfloat16 moments, m and v within
    one bf16 ulp.
  * A full train step at f32 compute (REDUCED qwen1.5-4b), with
    grad_accum 1 and 2 (JAX's `lax.scan` over micro-batches): the loss within
    1e-5 relative, `grad_norm` within 1e-5 relative, and the params after
    the step within 1e-5 of each leaf's largest |value| wherever the
    reference's gradient is at least 1e-3 of its leaf's largest |grad|.
    Below that the gradient is rounding noise in both packages (the key
    bias's gradient is 0 in exact arithmetic: softmax ignores a shift
    that is the same for every key), and AdamW's first step moves a value
    by lr * g / (|g| + eps), about lr * sign(g); there each value is held
    within the most one step can move it, lr * (1 + weight_decay * |p|).
  * grad_accum=2's gradients: bit for bit the sum of its micro-batches'
    own gradients in the param dtype, halved (f32 and bf16 params); at
    f32 within 1e-5 of each leaf's largest |grad| of the whole batch's.
  * The reference's tests keep their own tolerances.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import transformer as JT
from repro.models.common import init_params as jax_init_params
from repro.train import OptConfig as JaxOptConfig
from repro.train import checkpoint as jckpt
from repro.train import make_train_step as jax_make_train_step
from repro.train import opt_init as jax_opt_init
from repro.train.optimizer import lr_at as jax_lr_at
from repro.train.optimizer import opt_update as jax_opt_update
from repro.train.step import make_loss_fn as jax_make_loss_fn
from repro_torch.configs import reduced_config
from repro_torch.models.common import (params_from_numpy, tree_leaves,
                                       tree_map)
from repro_torch.train import (ElasticTrainer, OptConfig, OptState,
                               StepWatchdog, checkpoint, make_train_step,
                               opt_init, opt_update)
from repro_torch.train.optimizer import lr_at
from repro_torch.train.step import make_grad_fn

torch.set_num_threads(2)

ARCH = "qwen1_5_4b"
CFG = reduced_config(ARCH)


@functools.cache
def _jax_params(cdt: str = "bfloat16"):
    cfg = dataclasses.replace(jax_reduced_config(ARCH), compute_dtype=cdt)
    return jax.tree.map(np.asarray,
                        jax_init_params(JT.param_specs(cfg),
                                        jax.random.PRNGKey(0)))


def _params():
    return params_from_numpy(_jax_params(), device="cpu")


def _np_batch(i, B=4, S=64):
    r = np.random.default_rng(5000 + i)
    t = r.integers(0, CFG.vocab, (B, S + 1))
    return {"tokens": t[:, :-1].astype(np.int32),
            "labels": t[:, 1:].astype(np.int32),
            "loss_mask": np.ones((B, S), np.float32)}


def _batch(i, B=4, S=64):
    return {k: torch.from_numpy(v) for k, v in _np_batch(i, B, S).items()}


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("step", [0, 1, 10, 11, 55, 100, 250])
def test_lr_at_matches_reference(step):
    oc = dict(lr=1e-3, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    got = lr_at(torch.tensor(step, dtype=torch.int32), OptConfig(**oc))
    want = jax_lr_at(jnp.int32(step), JaxOptConfig(**oc))
    assert got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)


def _opt_inputs(state_dtype: str):
    """A params tree with 3-D stacked, 2-D and 1-D leaves, gradients of
    norm well above grad_clip, and moments as after a few steps."""
    rng = np.random.default_rng(7)
    shapes = {"embed": (40, 16), "final_norm": (16,),
              "groups": {"p0": {"w": (3, 16, 24), "ln": (3, 16)}}}

    def draw(scale):
        def walk(s):
            if isinstance(s, dict):
                return {k: walk(v) for k, v in s.items()}
            return (rng.normal(size=s) * scale).astype(np.float32)
        return walk(shapes)

    params, grads = draw(0.05), draw(0.5)
    m, v = draw(0.01), jax.tree.map(np.abs, draw(0.001))
    sdt = jnp.bfloat16 if state_dtype == "bfloat16" else jnp.float32
    m, v = (jax.tree.map(lambda a: np.asarray(jnp.asarray(a, sdt)), t)
            for t in (m, v))
    return params, grads, m, v


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_opt_update_matches_reference(state_dtype):
    oc = dict(lr=1e-3, warmup_steps=2, decay_steps=50, state_dtype=state_dtype)
    params, grads, m, v = _opt_inputs(state_dtype)
    jstate = jax_opt_init(params, JaxOptConfig(**oc))._replace(
        m=m, v=v, step=jnp.int32(3))
    jp, js, jm = jax_opt_update(grads, jstate, params, JaxOptConfig(**oc))
    assert float(jm["grad_norm"]) > 1.0       # the clip is exercised

    tp = params_from_numpy(params, device="cpu")
    tg = params_from_numpy(grads, device="cpu")
    ts = OptState(params_from_numpy(m, device="cpu"),
                  params_from_numpy(v, device="cpu"),
                  torch.tensor(3, dtype=torch.int32))
    p_before = tp["groups"]["p0"]["w"]
    tp2, ts2, tm = opt_update(tg, ts, tp, OptConfig(**oc))
    assert tp2["groups"]["p0"]["w"] is p_before          # in place
    assert ts2.step.dtype == torch.int32 and int(ts2.step) == int(js.step)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    assert float(tm["lr"]) == float(jm["lr"])
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp2)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6,
                                   atol=1e-6 * np.abs(a).max())
    for ja, ta in ((js.m, ts2.m), (js.v, ts2.v)):
        for a, b in zip(jax.tree.leaves(ja), tree_leaves(ta)):
            a = np.asarray(a, np.float32)
            b = b.float().numpy()
            if state_dtype == "bfloat16":
                ulp = np.spacing(np.abs(a).astype(jnp.bfloat16)).astype(
                    np.float32)
                assert (np.abs(b - a) <= ulp).all()
            else:
                np.testing.assert_allclose(b, a, rtol=1e-6,
                                           atol=1e-6 * np.abs(a).max())


def _check_step_against_jax(grad_accum: int, i: int) -> None:
    """One train step at f32 compute on batch i, the port's against JAX's
    jitted one (its `lax.scan` over micro-batches when grad_accum > 1)."""
    jc = dataclasses.replace(jax_reduced_config(ARCH), compute_dtype="float32")
    tc = dataclasses.replace(CFG, compute_dtype="float32")
    oc = dict(lr=1e-3, warmup_steps=1, decay_steps=100)
    jp = _jax_params("float32")
    b = _np_batch(i)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    grads = jax.grad(lambda p, x: jax_make_loss_fn(jc)(p, x)[0])(jp, jbatch)
    jp2, _, jm = jax.jit(jax_make_train_step(
        jc, JaxOptConfig(**oc), grad_accum=grad_accum))(
        jp, jax_opt_init(jp, JaxOptConfig(**oc)), jbatch)

    tp = params_from_numpy(jp, device="cpu")
    tp2, ts2, tm = make_train_step(tc, OptConfig(**oc),
                                   grad_accum=grad_accum)(
        tp, opt_init(tp, OptConfig(**oc)), _batch(i))
    assert set(tm) == set(jm) == {"loss", "lr", "grad_norm"}
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    assert int(ts2.step) == 1
    lr, wd = float(jm["lr"]), 0.1
    for p0, a, c, g in zip(jax.tree.leaves(jp), jax.tree.leaves(jp2),
                           tree_leaves(tp2), jax.tree.leaves(grads)):
        a, c, g, p0 = np.asarray(a), c.numpy(), np.asarray(g), np.asarray(p0)
        held = np.abs(g) >= 1e-3 * np.abs(g).max()
        err = np.abs(c - a)
        assert (err[held] <= 1e-5 * np.abs(a).max()).all()
        assert (err <= 2 * lr * (1 + wd * np.abs(p0)) + 1e-7).all()


def test_train_step_matches_jax_at_f32():
    _check_step_against_jax(1, 0)


def test_train_step_grad_accum_matches_jax_at_f32():
    _check_step_against_jax(2, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_accum_sums_every_micro_batch(dtype):
    """grad_accum=2's gradients are its two micro-batches' grad_accum=1
    gradients summed in the param dtype and halved, bit for bit, and at
    f32 equal the whole batch's within 1e-5 of each leaf's largest
    |grad|; its loss is their mean."""
    cfg = dataclasses.replace(CFG, compute_dtype="float32")
    dt = getattr(torch, dtype)
    params = tree_map(lambda t: t.to(dt), _params())
    b = _batch(2)
    half = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in b.items()}
    l0, g0 = make_grad_fn(cfg)(params, {k: v[0] for k, v in half.items()})
    l1, g1 = make_grad_fn(cfg)(params, {k: v[1] for k, v in half.items()})
    loss, got = make_grad_fn(cfg, grad_accum=2)(params, b)
    assert torch.equal(loss, (l0 + l1) / 2)
    for g, a, c, p in zip(tree_leaves(got), tree_leaves(g0), tree_leaves(g1),
                          tree_leaves(params)):
        assert g.dtype == p.dtype
        assert torch.equal(g, (a + c) / 2)
    if dtype == "float32":
        _, full = make_grad_fn(cfg)(params, b)
        for g, w in zip(tree_leaves(got), tree_leaves(full)):
            assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


# ------------------------------------- the reference's tests, on the port
def test_memorization():
    params = _params()
    oc = OptConfig(lr=1e-3, warmup_steps=2, decay_steps=100)
    opt = opt_init(params, oc)
    step = make_train_step(CFG, oc)
    b = _batch(0)
    losses = []
    for _ in range(25):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0


def test_grad_accum_equivalent():
    """Micro-averaged grads equal full-batch grads (equal token counts).

    Compare raw gradients, not post-Adam params: one Adam step is
    ~ lr * sign(g), so numerically-tiny grad differences flip update signs.
    """
    params = _params()

    def grad_fn(p, b):
        return tree_leaves(make_grad_fn(CFG)(p, b)[1])

    b = _batch(1)
    g_full = grad_fn(params, b)
    half = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in b.items()}
    g_half = [(a + c) / 2 for a, c in zip(
        grad_fn(params, {k: v[0] for k, v in half.items()}),
        grad_fn(params, {k: v[1] for k, v in half.items()}))]
    for a, c in zip(g_full, g_half):
        # bf16 compute: accumulation order shifts grads by ~bf16 eps (0.4%)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=2e-3, rtol=2e-2)
    # and the train-step losses agree
    oc = OptConfig(lr=1e-3, warmup_steps=1, decay_steps=100)
    _, _, m1 = make_train_step(CFG, oc, grad_accum=1)(
        _params(), opt_init(params, oc), b)
    _, _, m2 = make_train_step(CFG, oc, grad_accum=2)(
        _params(), opt_init(params, oc), b)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)


def test_lr_schedule():
    oc = OptConfig(lr=1e-3, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    assert float(lr_at(torch.tensor(0, dtype=torch.int32), oc)) == 0.0
    assert abs(float(lr_at(torch.tensor(10, dtype=torch.int32), oc))
               - 1e-3) < 1e-9
    assert abs(float(lr_at(torch.tensor(100, dtype=torch.int32), oc))
               - 1e-4) < 1e-7


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.tensor([1, 2], dtype=torch.int32),
                  "d": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}}
    d = str(tmp_path)
    checkpoint.save(d, 7, tree, extra={"note": "x"})
    assert checkpoint.latest_step(d) == 7
    got = checkpoint.restore(d, 7, tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(got)):
        b = torch.as_tensor(b)
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomicity_ignores_tmp(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert checkpoint.latest_step(d) is None
    checkpoint.save(d, 3, {"x": torch.zeros(2)})
    assert checkpoint.latest_step(d) == 3


def test_elastic_resume_bit_exact(tmp_path):
    """As the reference's test; the step updates params in place (the
    reference's donation), so each trainer gets its own copy."""
    oc = OptConfig(lr=1e-3, warmup_steps=1, decay_steps=100)
    step = make_train_step(CFG, oc)

    def trainer(d, every):
        params = _params()
        return ElasticTrainer(step, params, opt_init(params, oc), _batch,
                              str(d), ckpt_every=every, async_save=False)

    tr = trainer(tmp_path / "run", 4)
    with pytest.raises(RuntimeError, match="injected failure at step 6"):
        tr.run(10, fail_at=6)
    tr2 = trainer(tmp_path / "run", 4)
    assert tr2.maybe_resume() and tr2.step == 4
    tr2.run(10)
    ref = trainer(tmp_path / "ref", 100)
    ref.run(10)
    for a, b in zip(tree_leaves(tr2.params), tree_leaves(ref.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(tr2.opt_state.m) + tree_leaves(tr2.opt_state.v),
                    tree_leaves(ref.opt_state.m) + tree_leaves(ref.opt_state.v)):
        assert torch.equal(a, b)
    assert int(tr2.opt_state.step) == int(ref.opt_state.step) == 10


def test_async_checkpoint(tmp_path):
    d = str(tmp_path)
    checkpoint.save_async(d, 1, {"x": torch.ones(8)})
    checkpoint.wait_pending()
    assert checkpoint.latest_step(d) == 1


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(factor=3.0)
    for _ in range(20):
        assert not wd.observe(1.0)
    assert wd.observe(10.0)


# --------------------------------- training checkpoints across packages
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_training_checkpoint_crosses_packages(tmp_path, state_dtype):
    """params + OptState after one port step: the port's file and the JAX
    package's file of the same values are byte-equal, and each restores
    in the other package to equal leaves (an ElasticTrainer resumes from
    the reference's file)."""
    oc = dict(lr=1e-3, warmup_steps=1, decay_steps=100,
              state_dtype=state_dtype)
    params = _params()
    step = make_train_step(CFG, OptConfig(**oc))
    params, opt, _ = step(params, opt_init(params, OptConfig(**oc)), _batch(0))
    tree = {"params": params, "opt": opt}
    checkpoint.save(str(tmp_path / "port"), 1, tree)

    def to_np(t):
        if t.dtype == torch.bfloat16:
            return np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))
        return t.numpy()

    jparams = jax.tree.map(np.asarray, _jax_params())
    jlike = {"params": jparams,
             "opt": jax_opt_init(jparams, JaxOptConfig(**oc))}
    leaves = [to_np(t) for t in checkpoint._flatten(tree)]
    it = iter(leaves)
    jtree = jax.tree.map(lambda _: next(it), jlike)
    jckpt.save(str(tmp_path / "jax"), 1, jtree)
    for name in ("arrays.msgpack", "MANIFEST.json"):
        assert ((tmp_path / "port" / "step_00000001" / name).read_bytes()
                == (tmp_path / "jax" / "step_00000001" / name).read_bytes())

    got = jckpt.restore(str(tmp_path / "port"), 1, jlike)
    for a, b in zip(jax.tree.leaves(got), leaves):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()

    fresh = _params()
    tr = ElasticTrainer(step, fresh, opt_init(fresh, OptConfig(**oc)),
                        _batch, str(tmp_path / "jax"))
    assert tr.maybe_resume() and tr.step == 1
    for a, b in zip(checkpoint._flatten({"params": tr.params,
                                         "opt": tr.opt_state}),
                    checkpoint._flatten(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
