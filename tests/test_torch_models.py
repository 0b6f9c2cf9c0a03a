"""The port's LM stack (`repro_torch.models`, `repro_torch.configs`,
`repro_torch.train.step`) held against the JAX package's on the CPU, at
the REDUCED widths.

Weights are the reference's `init_params(..., PRNGKey(0))` carried over
with `params_from_numpy`; inputs come from `np.random.default_rng(seed)`.

Tolerances:
  * f32 compute: atol = rtol = 1e-4 (F32_TOL). The state-space families
    (ssm, hybrid) use the reference's own chunked-against-stepwise scan
    tolerance, 2e-3 (`tests/test_models.py`), since their scans round in
    another order (hazard f).
  * bf16 compute: the reference's own atol=0.15, rtol=0.05
    (`tests/test_models.py::test_decode_matches_prefill_lastpos`). A bf16
    forward is held against the reference run op by op
    (`jax.disable_jit()`): each op then rounds to its declared dtype, as
    eager PyTorch does. Compiled, XLA keeps f32 between the fused bf16 ops
    of a scan body (excess precision), and at these inputs the reference
    then differs from itself beyond its own tolerance for qwen3-moe
    (expert routing flips) and zamba2. zamba2 at bf16 is beyond it even
    op by op, for the prefill and for one decode step, so it is held to
    the reference's accuracy instead: the mean and the max distance of
    each bf16 output (logits, cache leaves) from the reference's f32
    output at most 1.25 times those of the reference's own bf16 output,
    run op by op. Other bf16 decode steps are held against the reference
    as its tests run it (`tests/test_models.py`).
  * Layers (tests/test_torch_layers.py): see that file.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.shapes import all_cells as jax_all_cells
from repro.models import transformer as JT
from repro.models import whisper as JW
from repro.models.common import abstract_params as jax_abstract_params
from repro.models.common import init_params as jax_init_params
from repro.models.common import tree_size as jax_tree_size
from repro.train.step import make_loss_fn as jax_make_loss_fn
from repro.train.step import make_prefill_step as jax_make_prefill_step
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.shapes import SHAPES, all_cells, cells_for
from repro_torch.models import transformer as TT
from repro_torch.models import whisper as TW
from repro_torch.models.common import (abstract_params, caches_from_numpy,
                                       params_from_numpy, tree_leaves,
                                       tree_size, tree_to_numpy)
from repro_torch.train.step import (cross_entropy, make_decode_step,
                                    make_loss_fn, make_prefill_step)

ARCHS = list_archs()
F32_TOL = 1e-4
SSM_TOL = 2e-3
BF16_ATOL, BF16_RTOL = 0.15, 0.05
B, S, SMAX = 2, 64, 128
# held by tests/test_torch_models_moe_ssm.py, to keep each file's run short
MOE_SSM_ARCHS = ("zamba2_7b", "grok_1_314b", "qwen3_moe_235b",
                 "falcon_mamba_7b")


def _cfgs(arch: str, cdt: str):
    return (dataclasses.replace(jax_reduced_config(arch), compute_dtype=cdt),
            dataclasses.replace(reduced_config(arch), compute_dtype=cdt))


@functools.cache
def _jax_params(arch: str):
    cfg = jax_reduced_config(arch)
    specs = (JW.whisper_param_specs(cfg) if cfg.family == "encdec"
             else JT.param_specs(cfg))
    return jax_init_params(specs, jax.random.PRNGKey(0))


def _inputs(arch: str, seed: int = 0) -> dict:
    cfg = jax_reduced_config(arch)
    rng = np.random.default_rng(seed)
    batch = {}
    s = S
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
        s = S - cfg.prefix_len
    batch["tokens"] = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    return batch


@functools.cache
def _jax_prefill(arch: str, cdt: str, eager: bool) -> np.ndarray:
    """The reference's prefill logits, as its own tests run it (scan bodies
    compiled) or op by op (`eager`)."""
    jc, _ = _cfgs(arch, cdt)
    batch = {k: jnp.asarray(v) for k, v in _inputs(arch).items()}
    step = jax_make_prefill_step(jc)
    if eager:
        with jax.disable_jit():
            return np.asarray(step(_jax_params(arch), batch))
    return np.asarray(step(_jax_params(arch), batch))


def _port_prefill(arch: str, cdt: str) -> np.ndarray:
    _, tc = _cfgs(arch, cdt)
    params = params_from_numpy(jax.tree.map(np.asarray, _jax_params(arch)),
                               device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _inputs(arch).items()}
    batch["tokens"] = batch["tokens"].long()
    return make_prefill_step(tc)(params, batch).numpy()


def _decode_inputs(arch: str, cdt: str):
    """Fresh caches (whisper's cross caches filled from the seed) and a
    token at pos 3."""
    jc, _ = _cfgs(arch, cdt)
    rng = np.random.default_rng(1)
    if jc.family == "encdec":
        caches = JW.whisper_init_caches(jc, B, SMAX)
        caches = dict(caches, **{
            k: jnp.asarray(rng.normal(size=caches[k].shape), jc.cdt)
            for k in ("cross_k", "cross_v")})
    else:
        caches = JT.init_caches(jc, B, SMAX)
    tok = rng.integers(0, jc.vocab, (B,)).astype(np.int32)
    return caches, tok, np.full((B,), 3, np.int32)


def _close(port, ref, tol_a, tol_r, what):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32),
                               atol=tol_a, rtol=tol_r, err_msg=what)


def _jax_decode(arch: str, cdt: str):
    jc, _ = _cfgs(arch, cdt)
    caches, tok, pos = _decode_inputs(arch, cdt)
    step = (JW.whisper_decode_step if jc.family == "encdec"
            else JT.lm_decode_step)
    logits, caches = step(jc, _jax_params(arch), caches, jnp.asarray(tok),
                          jnp.asarray(pos))
    return [np.asarray(logits)] + [np.asarray(x, np.float32)
                                   for x in jax.tree.leaves(caches)]


def _port_decode(arch: str, cdt: str):
    _, tc = _cfgs(arch, cdt)
    caches, tok, pos = _decode_inputs(arch, cdt)
    caches = caches_from_numpy(jax.tree.map(np.asarray, caches), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, _jax_params(arch)),
                               device="cpu")
    logits, caches = make_decode_step(tc)(params, caches,
                                          torch.from_numpy(tok).long(),
                                          torch.from_numpy(pos).long())
    return [logits.numpy()] + tree_leaves(tree_to_numpy(caches))


def _as_accurate(port, ref, truth, what):
    """The port's bf16 result is no further from the reference's f32 result
    than the reference's own bf16 result, run op by op, is (mean and max,
    within 25%)."""
    err, ref_err = np.abs(port - truth), np.abs(ref - truth)
    assert err.mean() <= 1.25 * ref_err.mean(), (what, err.mean(), ref_err.mean())
    assert err.max() <= 1.25 * ref_err.max(), (what, err.max(), ref_err.max())


def check_arch(arch: str, cdt: str) -> None:
    """Prefill logits, and one decode step from fresh caches at pos 3
    (logits and every cache leaf), against the reference."""
    jc, tc = _cfgs(arch, cdt)
    port = _port_prefill(arch, cdt)
    assert port.shape == (B, S, jc.vocab) and np.isfinite(port).all()
    decoded = _port_decode(arch, cdt)
    ref_decoded = _jax_decode(arch, cdt)
    assert [x.shape for x in decoded] == [x.shape for x in ref_decoded]
    if cdt == "float32":
        tol = SSM_TOL if jc.family in ("ssm", "hybrid") else F32_TOL
        _close(port, _jax_prefill(arch, cdt, eager=False), tol, tol, "prefill")
        for i, (t, j) in enumerate(zip(decoded, ref_decoded)):
            _close(t, j, tol, tol, f"decode output {i}")
    elif jc.family == "hybrid":
        _as_accurate(port, _jax_prefill(arch, cdt, eager=True),
                     _jax_prefill(arch, "float32", eager=False), "prefill")
        with jax.disable_jit():
            eager_decoded = _jax_decode(arch, cdt)
        for i, (t, j, f) in enumerate(zip(decoded, eager_decoded,
                                          _jax_decode(arch, "float32"))):
            _as_accurate(t, j, f, f"decode output {i}")
    else:
        _close(port, _jax_prefill(arch, cdt, eager=True), BF16_ATOL,
               BF16_RTOL, "prefill")
        for i, (t, j) in enumerate(zip(decoded, ref_decoded)):
            _close(t, j, BF16_ATOL, BF16_RTOL, f"decode output {i}")


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in MOE_SSM_ARCHS])
def test_arch_prefill_and_decode_match_jax(arch, cdt):
    check_arch(arch, cdt)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_keeps_names_layout_and_bf16_bits(arch):
    """Every leaf of the reference's tree crosses name for name; a bf16
    tree (the giants' param dtype) keeps its bits."""
    cfg = dataclasses.replace(jax_reduced_config(arch), param_dtype="bfloat16")
    specs = (JW.whisper_param_specs(cfg) if cfg.family == "encdec"
             else JT.param_specs(cfg))
    jp = jax_init_params(specs, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jpaths = [jax.tree_util.keystr(k) for k, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    tcfg = dataclasses.replace(reduced_config(arch), param_dtype="bfloat16")
    tspecs = (TW.whisper_param_specs(tcfg) if cfg.family == "encdec"
              else TT.param_specs(tcfg))

    def paths(tree, pre=""):
        if isinstance(tree, dict):
            return [p for k in sorted(tree) for p in paths(tree[k], f"{pre}['{k}']")]
        return [pre]

    assert paths(tp) == jpaths == paths(tspecs)
    for j, t, s in zip(jax.tree.leaves(jp), tree_leaves(tp), tree_leaves(tspecs)):
        j = np.asarray(j)
        assert t.dtype == s.dtype and tuple(t.shape) == j.shape == s.shape
        if j.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            assert (t.view(torch.int16).numpy() == j.view(np.int16)).all()
        else:
            assert (t.numpy() == j).all()


def test_params_from_numpy_defaults_to_the_card(monkeypatch):
    """With no device the reference's tree goes to cuda, as every port
    entry point does: without a card the call raises, and `caches_from_numpy`
    (the same function) too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"w": np.ones((2, 3), np.float32)}
    for fn in (params_from_numpy, caches_from_numpy):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(tree)
        assert fn(tree, device="cpu")["w"].device.type == "cpu"


def test_full_config_sizes_equal_jax_without_allocation():
    """tree_size of every full config equals the reference's exactly, on
    the meta device (a 314B tree allocates nothing)."""
    sizes = {}
    for arch in ARCHS:
        jc, tc = jax_get_config(arch), get_config(arch)
        jspecs = (JW.whisper_param_specs(jc) if jc.family == "encdec"
                  else JT.param_specs(jc))
        tspecs = (TW.whisper_param_specs(tc) if tc.family == "encdec"
                  else TT.param_specs(tc))
        abstract = abstract_params(tspecs)
        assert all(t.device.type == "meta" for t in tree_leaves(abstract))
        sizes[arch] = tree_size(abstract)
        assert sizes[arch] == tree_size(tspecs) == jax_tree_size(
            jax_abstract_params(jspecs)), arch
        assert tc.active_params_per_token_layers() == \
            jc.active_params_per_token_layers()
        assert tc.layer_plan() == jc.layer_plan()
    assert sizes["qwen1_5_4b"] == 3_950_369_280


def test_configs_and_cells_equal_jax():
    for arch in ARCHS:
        jc, tc = jax_get_config(arch), get_config(arch)
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
        assert jd == td, arch
        assert dataclasses.asdict(jax_reduced_config(arch)) == \
            dataclasses.asdict(reduced_config(arch))
        assert tc.pdt == (torch.bfloat16 if jc.pdt == jnp.bfloat16
                          else torch.float32)
        assert tc.cdt == torch.bfloat16
    assert all_cells() == jax_all_cells()
    assert SHAPES["decode_32k"].seq == 32768
    assert cells_for("gemma3-27b")[-1] == "long_500k"
    # hazard h: the remainders
    assert reduced_config("gemma3_27b").layer_plan() == (
        ["local"] * 5 + ["global"], 1, ["local", "local"])
    assert reduced_config("zamba2_7b").layer_plan() == (
        ["mamba2"] * 3 + ["shared_attn"], 2, ["mamba2"])


def test_modules_register_the_reference_names():
    for arch, cls in (("stablelm_1_6b", TT.DecoderLM),
                      ("whisper_medium", TW.WhisperLM)):
        cfg = reduced_config(arch)
        gen = torch.Generator().manual_seed(0)
        model = cls(cfg, device="cpu", generator=gen)
        jpaths = sorted(
            ".".join(str(k.key) for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(_jax_params(arch))[0])
        assert sorted(model.state_dict()) == jpaths
        batch = {k: torch.from_numpy(v) for k, v in _inputs(arch).items()}
        tokens = batch["tokens"].long()
        if cls is TW.WhisperLM:
            got = model(batch["frames"], tokens)
            ref = make_prefill_step(cfg)(model.params(), batch)
        else:
            got = model(tokens)
            ref = TT.lm_forward(cfg, model.params(), tokens)
        assert torch.equal(got, ref)
        caches = model.init_caches(B, 16)
        lg, caches = model.decode_step(caches, tokens[:, 0],
                                       torch.zeros(B, dtype=torch.int64))
        assert lg.shape == (B, cfg.vocab) and torch.isfinite(lg).all()


def test_entry_points_need_the_card_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = reduced_config("qwen1_5_4b")
    for call in (lambda: TT.DecoderLM(cfg),
                 lambda: TW.WhisperLM(reduced_config("whisper_medium")),
                 lambda: TT.init_caches(cfg, 1, 8),
                 lambda: TW.whisper_init_caches(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_loss_matches_jax():
    arch = "internvl2_1b"
    jc, tc = _cfgs(arch, "float32")
    inp = _inputs(arch)
    rng = np.random.default_rng(5)
    s = inp["tokens"].shape[1]
    inp["labels"] = rng.integers(0, jc.vocab, (B, s)).astype(np.int32)
    inp["loss_mask"] = (rng.random((B, s)) < 0.7).astype(np.float32)
    jloss, _ = jax_make_loss_fn(jc)(_jax_params(arch),
                                    {k: jnp.asarray(v) for k, v in inp.items()})
    batch = {k: torch.from_numpy(v) for k, v in inp.items()}
    batch["tokens"] = batch["tokens"].long()
    params = params_from_numpy(jax.tree.map(np.asarray, _jax_params(arch)),
                               device="cpu")
    tloss, aux = make_loss_fn(tc)(params, batch)
    assert abs(float(tloss) - float(jloss)) <= F32_TOL * abs(float(jloss))
    assert aux["loss"] is tloss
    zero = cross_entropy(torch.zeros(1, 2, 4), torch.zeros(1, 2, dtype=torch.int64),
                         torch.zeros(1, 2))
    assert float(zero) == 0.0
