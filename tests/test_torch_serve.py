"""The port's serving path (`repro_torch.launch.serve.generate`, the
whisper cross-cache prefill, the CLI and its device rule) against the
JAX package's serving loop on the CPU.

The reference's serving entry point (`repro/launch/serve.py::main`) is
not factored, so its loop is written out here as it is there: a jitted
`make_decode_step` stepped over the prompt, then greedy steps. Weights are
the reference's `init_params(..., PRNGKey(0))` carried over with
`params_from_numpy`; prompts and whisper's stub frames come from
`np.random.default_rng(0)`. At f32 compute the greedy tokens must be
equal and the last prompt logits within 2e-3 (the SSM scans' tolerance,
for every arch); at bf16 those teacher-forced logits are compared with
the tolerances of tests/test_torch_models.py (zamba2 by its accuracy
criterion).
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import transformer as JT
from repro.models import whisper as JW
from repro.models.common import init_params as jax_init_params
from repro.train.step import make_decode_step as jax_make_decode_step
from repro_torch.configs import reduced_config
from repro_torch.launch.serve import generate, prefill_cross_caches
from repro_torch.models import transformer as TT
from repro_torch.models import whisper as TW
from repro_torch.models.common import params_from_numpy
from repro_torch.train.step import make_prefill_step
from test_torch_models import BF16_ATOL, BF16_RTOL, _as_accurate

ROOT = Path(__file__).resolve().parents[1]
B, PROMPT, GEN = 2, 8, 8
SMAX = PROMPT + GEN
SERVE_ARCHS = ["qwen1_5_4b", "grok_1_314b", "falcon_mamba_7b", "zamba2_7b",
               "whisper_medium"]


def _setup(arch: str, cdt: str):
    """Both packages' configs, params and fresh caches, whisper's cross
    caches filled from the same stub frames, and the prompts."""
    jc = dataclasses.replace(jax_reduced_config(arch), compute_dtype=cdt)
    tc = dataclasses.replace(reduced_config(arch), compute_dtype=cdt)
    rng = np.random.default_rng(0)
    enc = jc.family == "encdec"
    jp = jax_init_params(JW.whisper_param_specs(jc) if enc else JT.param_specs(jc),
                         jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    if enc:
        frames = rng.normal(size=(B, jc.encoder_seq, jc.d_model))
        jcaches = JW.whisper_init_caches(jc, B, SMAX)
        # repro/launch/serve.py's cross-cache prefill, as written there
        encoded = JW.whisper_encode(jc, jp, jnp.asarray(frames, jnp.float32))
        ck, cv = [], []
        for l in range(jc.n_layers):
            p = jax.tree.map(lambda a: a[l], jp["dec"])
            hk = JW.layer_norm(encoded, p["x_ln_w"], p["x_ln_b"])
            ck.append((hk @ p["x_wk"].astype(hk.dtype)).reshape(B, -1, jc.n_heads, jc.hd))
            cv.append((hk @ p["x_wv"].astype(hk.dtype)
                       + p["x_bv"].astype(hk.dtype)).reshape(B, -1, jc.n_heads, jc.hd))
        jcaches = dict(jcaches,
                       cross_k=jnp.stack(ck).astype(jcaches["cross_k"].dtype),
                       cross_v=jnp.stack(cv).astype(jcaches["cross_v"].dtype))
        tcaches = TW.whisper_init_caches(tc, B, SMAX, "cpu")
        prefill_cross_caches(tc, tp, tcaches,
                             torch.as_tensor(frames, dtype=torch.float32))
    else:
        jcaches = JT.init_caches(jc, B, SMAX)
        tcaches = TT.init_caches(tc, B, SMAX, "cpu")
    prompts = rng.integers(1, jc.vocab, (B, PROMPT))
    return jc, tc, jp, tp, jcaches, tcaches, prompts


def _jax_generate(jc, params, caches, prompts, gen, jit=True):
    """The reference's serving loop; returns (tokens, last prompt logits)."""
    decode = jax_make_decode_step(jc)
    decode = jax.jit(decode) if jit else decode
    P = prompts.shape[1]
    tok = jnp.asarray(prompts[:, 0], jnp.int32)
    for t in range(P):
        pos = jnp.full((prompts.shape[0],), t, jnp.int32)
        logits, caches = decode(params, caches, tok, pos)
        tok = (jnp.asarray(prompts[:, t + 1], jnp.int32) if t + 1 < P
               else jnp.argmax(logits, -1).astype(jnp.int32))
    prompt_logits = np.asarray(logits)
    generated = [np.asarray(tok)]
    for t in range(P, P + gen - 1):
        pos = jnp.full((prompts.shape[0],), t, jnp.int32)
        logits, caches = decode(params, caches, tok, pos)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        generated.append(np.asarray(tok))
    return np.stack(generated, 1), prompt_logits


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_generate_matches_jax_serving_loop(arch, cdt):
    jc, tc, jp, tp, jcaches, tcaches, prompts = _setup(arch, cdt)
    out = generate(tc, tp, tcaches, prompts, GEN)
    assert out.tokens.shape == (B, GEN) and len(out.step_ms) == GEN - 1
    assert out.prefill_s > 0 and out.decode_s > 0
    logits = out.prompt_logits.numpy()
    assert np.isfinite(logits).all()
    if cdt == "float32":
        tokens, ref_logits = _jax_generate(jc, jp, jcaches, prompts, GEN)
        np.testing.assert_array_equal(out.tokens, tokens)
        np.testing.assert_allclose(logits, ref_logits, atol=2e-3, rtol=2e-3)
    elif jc.family == "hybrid":
        with jax.disable_jit():
            _, eager = _jax_generate(jc, jp, jcaches, prompts, GEN, jit=False)
        f32 = _setup(arch, "float32")
        _, truth = _jax_generate(f32[0], f32[2], f32[4], prompts, GEN)
        _as_accurate(logits, eager, truth, "prompt logits")
    else:
        _, ref_logits = _jax_generate(jc, jp, jcaches, prompts, GEN)
        np.testing.assert_allclose(logits, ref_logits, atol=BF16_ATOL,
                                   rtol=BF16_RTOL)


def test_prefill_step_last_position_matches_decode_loop():
    """The reference's own check, on the port: greedy decode over a prompt
    matches the teacher-forced prefill at the last position (bf16)."""
    _, tc, _, tp, _, tcaches, prompts = _setup("qwen1_5_4b", "bfloat16")
    out = generate(tc, tp, tcaches, prompts, 1)
    full = make_prefill_step(tc)(tp, {"tokens": torch.as_tensor(prompts)})
    np.testing.assert_allclose(out.prompt_logits.numpy(), full[:, -1].numpy(),
                               atol=BF16_ATOL, rtol=BF16_RTOL)
    assert (out.tokens[:, 0] == full[:, -1].argmax(-1).numpy()).all()


def _serve(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "whisper-medium", "--batch", "2", "--prompt-len", "4", "--gen", "3",
         *args], env=env, capture_output=True, text=True, timeout=300)


def test_cli_runs_on_the_named_cpu_and_raises_without_a_card():
    ok = _serve("--device", "cpu")
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "arch=whisper-medium" in ok.stdout and "tok/s batched" in ok.stdout
    assert "sample tokens: [" in ok.stdout
    bad = _serve()
    assert bad.returncode != 0
    assert "device='cpu'" in bad.stderr
    assert "sample tokens" not in bad.stdout
