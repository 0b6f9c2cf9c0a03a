"""The port's dry run (`repro_torch.launch.dryrun`) and its cost mode
(`repro_torch.launch.hlocost`) on the CPU, over torch's fake process
group on the meta device.

The cost mode's loop test is the analog of
`tests/test_dist.py::test_hlocost_parser_loop_multiplication`: 10 Python
trips of an (8, 16) x (16, 16) product and an all-reduce of its result on
a fake 2-rank mesh count exactly 10 x 4,096 dot FLOPs, 10 x 512
all-reduce bytes and twice that on the wire.

One full cell, qwen1.5-4b train_4k on the fake (16, 16) mesh, runs once
(about 50 s on one CPU core): its per-device argument bytes are those of
the reference plan's blocks (params, both moments, the step counter, the
batch), and its per-device FLOPs lie between 6 N and 8 N tokens over 256
devices plus the attention's products. Its 20 heads do not tile 16 model
ranks, so each rank attends over all 20 heads of its 16 rows: the
products count 4 passes (forward, remat's recompute, two in the
backward) of QK^T and PV over the full S x S grid, as the chunked
attention computes every chunk. Seen: 5.47e14 FLOPs per device, against
bounds of 5.37e14 and 5.69e14."""
from __future__ import annotations

import json
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro.configs import get_config as jax_get_config
from repro.dist.sharding import make_plan as jax_make_plan
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.hlocost import CostMode
from repro_torch.models.common import tree_size


def test_cost_mode_multiplies_every_loop_trip():
    x = torch.randn(8, 16)
    w = torch.randn(16, 16)
    with dryrun.fake_world(2):
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
        with CostMode() as m:
            for _ in range(10):
                part = DTensor.from_local(x @ w, mesh, [Partial()])
                x = part.redistribute(mesh, [Replicate()]).to_local()
    assert not torch.distributed.is_initialized()
    assert m.cost.flops == 2 * 8 * 16 * 16 * 10 == 40_960
    assert dict(m.cost.collectives) == {"all-reduce": 8 * 16 * 4 * 10}
    assert m.cost.wire_bytes == 2 * 8 * 16 * 4 * 10 == 10_240


@pytest.fixture(scope="module")
def qwen_train_cell():
    return dryrun.lower_cell("qwen1.5-4b", "train_4k", multi_pod=False)


def _shard_bytes(shape, spec, sizes, itemsize) -> int:
    n = 1
    for dim, part in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if part is None else (
            part if isinstance(part, tuple) else (part,))
        n *= dim // math.prod(sizes[a] for a in axes)
    return n * itemsize


def test_qwen_train_cell_arguments_are_the_reference_plans_blocks(
        qwen_train_cell):
    rec = qwen_train_cell
    assert not torch.distributed.is_initialized()
    assert rec["measured"] and rec["mesh"] == "16x16"
    assert rec["devices"] == 256 and rec["grad_accum"] == 1
    cfg = jax_get_config("qwen1.5-4b")
    specs = JT.param_specs(cfg)
    ref = jax_make_plan(cfg, AbstractMesh((16, 16), ("data", "model")))
    sizes = {"data": 16, "model": 16}
    leaves = jax.tree.leaves(specs, is_leaf=lambda s: hasattr(s, "axes"))
    pspecs = jax.tree.leaves(ref.params(specs), is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    params = sum(_shard_bytes(s.shape, p, sizes, 4)
                 for s, p in zip(leaves, pspecs))
    sh = SHAPES["train_4k"]
    rows = sh.batch // 16                       # the batch over "data"
    batch = 3 * rows * sh.seq * 4               # tokens, labels, loss_mask
    # params + m + v (f32, the same plan at fsdp=True) + the step counter
    expect = 3 * params + 4 + batch
    assert rec["memory_analysis"]["argument_size"] == expect
    # outputs: params, moments, the counter and three f32 metrics
    assert rec["memory_analysis"]["output_size"] == 3 * params + 4 + 3 * 4
    assert rec["n_params"] == tree_size(specs)


def test_qwen_train_cell_flops_lie_between_6n_and_8n_plus_attention(
        qwen_train_cell):
    rec = qwen_train_cell
    cfg = get_config("qwen1.5-4b")
    sh = SHAPES["train_4k"]
    tokens = sh.batch * sh.seq
    n = rec["n_params"]
    rows, heads = sh.batch // 16, cfg.n_heads     # heads do not tile 16
    assert cfg.n_heads % 16 != 0
    attn_fwd = 4 * rows * heads * sh.seq * sh.seq * cfg.hd * cfg.n_layers
    attention = 4 * attn_fwd
    lo = 6 * n * tokens / 256 + attention
    hi = 8 * n * tokens / 256 + attention
    assert lo <= rec["flops_per_device"] <= hi, (lo, rec["flops_per_device"],
                                                 hi)
    coll = rec["collective_bytes_per_device"]
    assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
    assert rec["wire_bytes_per_device"] == pytest.approx(
        sum(v * (2 if k == "all-reduce" else 1) for k, v in coll.items()))
    assert rec["bytes_per_device"] > 0 and "upper bound" in rec["bytes_note"]


def test_unobserved_sizes_are_null_with_their_reasons(qwen_train_cell):
    rec = qwen_train_cell
    mem = rec["memory_analysis"]
    assert mem["temp_size"] is None and mem["generated_code_size"] is None
    assert rec["temp_size_null_reason"] == dryrun.TEMP_NULL
    assert rec["t_lower_s"] is None and rec["t_compile_s"] is None
    assert rec["times_null_reason"]
    assert rec["hbm_budget_device"] == "NVIDIA H100 80GB HBM3"
    json.dumps(rec)


def test_fold_dedup_is_not_measured_and_a_failing_cell_exits_1(tmp_path,
                                                               capsys):
    rec = dryrun.lower_cell("fold_dedup", "ingest_100k", multi_pod=False)
    assert rec["measured"] is False
    assert rec["not_measured_reason"] == dryrun.FOLD_NOT_MEASURED
    assert "flops_per_device" not in rec
    assert dryrun.main(["--arch", "fold_dedup", "--shape", "ingest_100k",
                        "--out", str(tmp_path)]) == 0
    with open(tmp_path / "pod16x16" / "fold_dedup__ingest_100k.json") as f:
        assert json.load(f)["measured"] is False
    assert "NOT MEASURED fold_dedup__ingest_100k" in capsys.readouterr().out
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                        "--out", str(tmp_path)]) == 1
    assert "FAIL no-such-arch__train_4k" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()


def test_input_specs_and_grad_accum():
    cfg = get_config("internvl2-1b")
    spec = dryrun.input_specs(cfg, "train_4k")
    assert set(spec) == {"patch_embeds", "tokens", "labels", "loss_mask"}
    assert spec["tokens"].shape == (256, 4096 - cfg.prefix_len)
    assert spec["tokens"].dtype == torch.int32
    assert all(t.device.type == "meta" for t in spec.values())
    dec = dryrun.input_specs(get_config("qwen1.5-4b"), "decode_32k")
    assert set(dec) == {"token", "pos"} and dec["token"].shape == (128,)
    with dryrun.fake_world(256):
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        for arch in ("qwen1.5-4b", "grok-1-314b", "gemma3-27b"):
            ga = dryrun.auto_grad_accum(get_config(arch), SHAPES["train_4k"],
                                        mesh)
            c = get_config(arch)
            est = 4.0 * (c.n_layers + c.encoder_layers) * 16 * 4096 \
                * c.d_model * 2
            assert ga >= 1 and (est / ga <= dryrun.HBM_BUDGET or ga == 16)
        assert dryrun.auto_grad_accum(get_config("qwen1.5-4b"),
                                      SHAPES["prefill_32k"], mesh) == 1
