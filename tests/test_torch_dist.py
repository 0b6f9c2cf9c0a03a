"""The port's distribution layer (`repro_torch.dist`, `param_pspecs`,
`launch/mesh.py`) held against the JAX package's, at the production mesh
shapes, on the CPU.

The reference's plans are built on `jax.sharding.AbstractMesh` in
process (no devices needed). The port's are built on `DeviceMesh`es over
torch's fake process group (`FakeStore`): one group of 512 ranks, this
process rank 0, holds every mesh of this file, (16, 16), (2, 16, 16),
(2, 2), (4, 2), (3, 2) and (1, 1), and is taken down at the end of the
module.
Specs must be equal leaf for leaf (one entry per dim: None, an axis, or
a tuple of axes, as `PartitionSpec` stores them); the local block of
every leaf distributed over the fake (16, 16) and (2, 16, 16) meshes
(meta tensors, nothing allocated) must have the shape and the offset the
reference's spec implies, a dim over ("pod", "data") pod-major."""
from __future__ import annotations

import math

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.dist.sharding import batch_pspecs as jax_batch_pspecs
from repro.dist.sharding import cache_pspecs as jax_cache_pspecs
from repro.dist.sharding import make_plan as jax_make_plan
from repro.models import transformer as JT
from repro.models import whisper as JW
from repro.models.common import param_pspecs as jax_param_pspecs
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.dist import act
from repro_torch.dist.sharding import (P, batch_pspecs, cache_pspecs,
                                       distribute, dp_axes, make_plan,
                                       to_placements)
from repro_torch.launch.mesh import make_production_mesh, mesh_axes
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.common import (abstract_params, param_pspecs,
                                       tree_leaves)

ARCHS = list_archs()
MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16), "2x2": (2, 2),
          "4x2": (4, 2), "3x2": (3, 2), "1x1": (1, 1)}
PRODUCTION = ("16x16", "2x16x16")


@pytest.fixture(scope="module")
def meshes():
    """Every mesh of the module over one fake 512-rank group."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield {k: DeviceMesh("cpu", torch.arange(math.prod(s)).reshape(s),
                             mesh_dim_names=mesh_axes(len(s)))
               for k, s in MESHES.items()}
    finally:
        act.clear()
        dist.destroy_process_group()


def _jax_mesh(key: str) -> AbstractMesh:
    shape = MESHES[key]
    return AbstractMesh(shape, mesh_axes(len(shape)))


def _specs(mod, arch: str, reduced: bool = False):
    get = {T: (get_config, reduced_config),
           JT: (jax_get_config, jax_reduced_config)}[mod][int(reduced)]
    cfg = get(arch)
    if cfg.family == "encdec":
        return cfg, (W if mod is T else JW).whisper_param_specs(cfg)
    return cfg, mod.param_specs(cfg)


def _jax_leaves(tree) -> list:
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


def _same(port_tree, jax_tree) -> None:
    mine = tree_leaves(port_tree)
    ref = _jax_leaves(jax_tree)
    assert len(mine) == len(ref) > 0
    for a, b in zip(mine, ref):
        assert isinstance(a, P) and tuple(a) == tuple(b), (a, b)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh_key", PRODUCTION)
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_equals_the_reference_at_production_shapes(meshes, arch,
                                                        mesh_key, fsdp):
    cfg, specs = _specs(T, arch)
    jcfg, jspecs = _specs(JT, arch)
    mesh = meshes[mesh_key]
    plan = make_plan(cfg, mesh, fsdp=fsdp)
    ref = jax_make_plan(jcfg, _jax_mesh(mesh_key), fsdp=fsdp)
    assert plan.rules == ref.rules
    _same(plan.params(specs), ref.params(jspecs))
    # param_pspecs: the same rules without the divisibility filter
    _same(param_pspecs(specs, plan.rules), jax_param_pspecs(jspecs, ref.rules))


@pytest.mark.parametrize("mesh_key", PRODUCTION + ("2x2",))
def test_batch_and_cache_pspecs_equal_the_reference(meshes, mesh_key):
    mesh, jmesh = meshes[mesh_key], _jax_mesh(mesh_key)
    assert dp_axes(mesh) == tuple(a for a in mesh_axes(mesh.ndim)
                                  if a != "model")
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for kind in ("train", "prefill"):
            for batch in (256, 32, 6):
                mine = batch_pspecs(cfg, mesh, kind, batch)
                ref = jax_batch_pspecs(jcfg, jmesh, kind, batch)
                assert list(mine) == list(ref)
                assert all(tuple(mine[k]) == tuple(ref[k]) for k in ref)
        for batch in (128, 3):
            if cfg.family == "encdec":
                caches = W.whisper_init_caches(cfg, batch, 64, "meta")
                jcaches = jax.eval_shape(
                    lambda: JW.whisper_init_caches(jcfg, batch, 64))
            else:
                caches = T.init_caches(cfg, batch, 64, "meta")
                jcaches = jax.eval_shape(
                    lambda: JT.init_caches(jcfg, batch, 64))
            assert [tuple(t.shape) for t in tree_leaves(caches)] == [
                tuple(t.shape) for t in jax.tree.leaves(jcaches)]
            _same(cache_pspecs(cfg, mesh, caches, batch),
                  jax_cache_pspecs(jcfg, jmesh, jcaches, batch))


def _expected_block(shape, spec, mesh_key, coord):
    """(shape, offset) of the block at mesh coordinate `coord` under the
    reference's spec: a dim over several axes is split major-first."""
    names = mesh_axes(len(MESHES[mesh_key]))
    sizes = dict(zip(names, MESHES[mesh_key]))
    where = dict(zip(names, coord))
    blk, off = [], []
    for dim, part in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if part is None else (
            part if isinstance(part, tuple) else (part,))
        n = math.prod(sizes[a] for a in axes)
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + where[a]
        blk.append(dim // n)
        off.append(idx * (dim // n))
    return tuple(blk), tuple(off)


@pytest.mark.parametrize("mesh_key", PRODUCTION)
@pytest.mark.parametrize("arch", ARCHS)
def test_local_blocks_match_the_reference_specs(meshes, arch, mesh_key):
    """Every leaf distributed over the fake mesh (meta, nothing
    allocated): this rank's block shape, and the block shape and offset
    at corner and middle coordinates, are those of the reference's
    spec."""
    cfg, specs = _specs(T, arch)
    jcfg, jspecs = _specs(JT, arch)
    mesh = meshes[mesh_key]
    ref = _jax_leaves(jax_make_plan(jcfg, _jax_mesh(mesh_key)).params(jspecs))
    pspecs = make_plan(cfg, mesh).params(specs)
    placed = distribute(abstract_params(specs), pspecs, mesh,
                        src_data_rank=None)
    shape = MESHES[mesh_key]
    coords = [tuple(0 for _ in shape), tuple(s - 1 for s in shape),
              tuple(s // 2 for s in shape), tuple(min(1, s - 1) for s in shape)]
    for t, spec, rs in zip(tree_leaves(placed), tree_leaves(pspecs), ref):
        assert isinstance(t, DTensor) and t.to_local().device.type == "meta"
        assert tuple(t.to_local().shape) == _expected_block(
            t.shape, rs, mesh_key, coords[0])[0]
        assert tuple(spec) == tuple(rs)
        for c in coords:
            got = _compute_local_shape_and_global_offset(
                t.shape, shape, list(c), t.placements)
            assert (tuple(got[0]), tuple(got[1])) == _expected_block(
                t.shape, rs, mesh_key, c), (arch, spec, c)


def _drops(plan_tree, unfiltered_tree) -> list:
    """(leaf index, filtered spec) wherever the divisibility filter
    changed the rules' spec."""
    return [(i, tuple(a)) for i, (a, b) in enumerate(zip(plan_tree,
                                                         unfiltered_tree))
            if tuple(a) != tuple(b)]


@pytest.mark.parametrize("mesh_key", ["2x2", "4x2", "3x2", "16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_divisibility_filter_falls_back_as_the_reference(meshes, arch,
                                                          mesh_key):
    """The plan equals the reference's for the REDUCED configs on small
    meshes, and the filter drops the same axes: every REDUCED leaf tiles
    (2, 2) and (4, 2) evenly (nothing drops, as in the reference), a
    "data" axis of 3 tiles none of their embed dims (every embed rule
    falls back to replication), and the full configs on (16, 16) drop
    where the reference drops (grok's 8 experts over 16 data ranks)."""
    reduced = mesh_key != "16x16"
    cfg, specs = _specs(T, arch, reduced=reduced)
    jcfg, jspecs = _specs(JT, arch, reduced=reduced)
    mesh = meshes[mesh_key]
    plan = make_plan(cfg, mesh)
    ref = jax_make_plan(jcfg, _jax_mesh(mesh_key))
    _same(plan.params(specs), ref.params(jspecs))
    mine = _drops(tree_leaves(plan.params(specs)),
                  tree_leaves(param_pspecs(specs, plan.rules)))
    theirs = _drops(_jax_leaves(ref.params(jspecs)),
                    _jax_leaves(jax_param_pspecs(jspecs, ref.rules)))
    assert mine == theirs
    sizes = dict(zip(mesh.mesh_dim_names, MESHES[mesh_key]))
    for spec, leaf in zip(tree_leaves(plan.params(specs)),
                          tree_leaves(specs)):
        for dim, part in zip(leaf.shape, spec):
            axes = () if part is None else (
                part if isinstance(part, tuple) else (part,))
            assert dim % math.prod(sizes[a] for a in axes) == 0
    if mesh_key in ("2x2", "4x2"):
        assert mine == []
    if mesh_key == "3x2":
        assert mine and all("data" not in str(spec) for _, spec in mine)
    if mesh_key == "16x16":
        assert bool(mine) == (arch == "grok_1_314b")


def test_placements_and_production_mesh(meshes):
    mesh = meshes["2x16x16"]
    assert to_placements(P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert to_placements(P(None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        to_placements(P(("data", "pod")), mesh)
    assert P(("data",), None) == P("data", None)
    assert P((), "model") == P(None, "model")
    assert mesh_axes(1) == ("data",)
    one = make_production_mesh(device_type="cpu")
    two = make_production_mesh(multi_pod=True, device_type="cpu")
    assert (one.shape, one.mesh_dim_names) == ((16, 16), ("data", "model"))
    assert (two.shape, two.mesh_dim_names) == ((2, 16, 16),
                                               ("pod", "data", "model"))


def test_anchors_are_identities_without_a_mesh_or_on_one_rank(meshes):
    x = torch.randn(4, 8, 16)
    logits = torch.randn(4, 8, 32)
    act.clear()
    assert act.current_mesh() is None
    assert act.btd(x) is x and act.bd(x[:, 0]).data_ptr() == x.data_ptr()
    assert act.logits_spec(logits) is logits
    one = meshes["1x1"]
    act.set_mesh(one)
    try:
        assert act.btd(x) is x and act.logits_spec(logits) is logits
        y = x[:, 0]
        assert act.bd(y) is y
        assert act.tile(x, -1, 3) is x
        assert act.replicated(torch.neg, x).equal(-x)
    finally:
        act.clear()


def test_anchors_place_activations_as_the_reference_constrains(meshes):
    mesh = meshes["2x2"]
    act.set_mesh(mesh)
    try:
        x = distribute({"x": torch.empty(4, 8, 16, device="meta")},
                       {"x": P(None, None, "model")}, mesh,
                       src_data_rank=None)["x"]
        assert act.btd(x).placements == (Shard(0), Replicate())
        odd = distribute({"x": torch.empty(3, 8, 16, device="meta")},
                         {"x": P()}, mesh, src_data_rank=None)["x"]
        assert act.btd(odd).placements == (Replicate(), Replicate())
        lg = distribute({"x": torch.empty(4, 8, 32, device="meta")},
                        {"x": P()}, mesh, src_data_rank=None)["x"]
        assert act.logits_spec(lg).placements == (Shard(0), Shard(2))
        assert act.bd(lg[:, 0]).placements == (Shard(0), Replicate())
        # a shard of 2 does not split 3 heads: the dim is gathered first
        h = distribute({"x": torch.empty(4, 8, 6, device="meta")},
                       {"x": P(None, None, "model")}, mesh,
                       src_data_rank=None)["x"]
        assert act.tile(h, -1, 3).placements == (Replicate(), Replicate())
        assert act.tile(h, -1, 2) is h
        with pytest.raises(TypeError, match="DTensors"):
            act.btd(torch.zeros(4, 8, 16))
    finally:
        act.clear()
