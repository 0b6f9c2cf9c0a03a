"""Sharding plans: logical parameter axes -> mesh partition specs (port of
`repro/dist/sharding.py`).

The ParamSpec substrate (models/common.py) annotates every parameter with
logical axis names; this module owns the rules table that maps them onto
the mesh. Two presets, selected by `make_plan(cfg, mesh, fsdp=...)`:

  baseline (fsdp=True)  — FSDP over the data axes ("embed" -> dp) + TP over
                          "model" for heads/kv_heads/mlp/ssm_inner/vocab;
                          experts spread over the dp axes (expert parallel).
  zero1   (fsdp=False)  — params TP-only (replicated over data); the caller
                          shards optimizer moments with a separate fsdp plan.

Every leaf spec is divisibility-filtered: a mesh axis is dropped from a dim
that it does not divide evenly (reduced CPU configs are small and
odd-sized; sharding degrades to replication, never fails).

A spec is a `PartitionSpec`: a tuple with one entry per tensor dim, each
None, a mesh axis name, or a tuple of axis names (major first), as the
reference's `jax.sharding.PartitionSpec`. `to_placements(spec, mesh)`
turns it into DTensor placements, one per mesh dim; `distribute` places a
whole tensor tree. A dim over two mesh axes, as ("pod", "data"), becomes
two `Shard(d)` in mesh order, which gives every rank the block of the
reference's pod-major order (the rules only ever name dp axes in mesh
order; another order is refused).

Also provided: `batch_pspecs` / `cache_pspecs` (input and KV-cache specs)
and `dp_axes` (every mesh axis except "model" — "data", plus "pod" on
multi-pod meshes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.models.common import ParamSpec, tree_map
from repro_torch.models.config import ModelConfig

__all__ = ["PartitionSpec", "ShardingPlan", "make_plan", "batch_pspecs",
           "cache_pspecs", "dp_axes", "to_placements", "distribute"]


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis, or a tuple of axes.
    A one-axis tuple is stored as the bare axis name, and an empty one as
    None, as jax's PartitionSpec stores them."""

    def __new__(cls, *parts):
        norm = tuple((p[0] if len(p) == 1 else p or None)
                     if isinstance(p, tuple) else p for p in parts)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_names(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(_axis_names(mesh).index(name))


def dp_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """Data-parallel mesh axes: everything that is not the tensor axis."""
    return tuple(a for a in _axis_names(mesh) if a != "model")


def _dp_size(mesh: DeviceMesh) -> int:
    return math.prod(_axis_size(mesh, a) for a in dp_axes(mesh))


def _leaf_pspec(spec: ParamSpec, rules: dict, mesh: DeviceMesh) -> P:
    """Rules -> PartitionSpec for one leaf, with divisibility filtering and
    no mesh axis repeated across dims of the same parameter."""
    names = _axis_names(mesh)
    used: set[str] = set()
    parts: list[Any] = []
    for dim, name in zip(spec.shape, spec.axes):
        rule = rules.get(name) if name is not None else None
        if rule is None:
            parts.append(None)
            continue
        axes = tuple(a for a in (rule if isinstance(rule, tuple) else (rule,))
                     if a in names and a not in used)
        # drop trailing axes until the dim tiles evenly
        while axes and dim % math.prod(_axis_size(mesh, a) for a in axes):
            axes = axes[:-1]
        if not axes:
            parts.append(None)
        else:
            parts.append(axes[0] if len(axes) == 1 else axes)
            used.update(axes)
    return P(*parts)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: DeviceMesh
    rules: dict

    def params(self, specs):
        """ParamSpec tree -> PartitionSpec tree."""
        return tree_map(lambda s: _leaf_pspec(s, self.rules, self.mesh),
                         specs)


def make_plan(cfg: ModelConfig, mesh: DeviceMesh,
              fsdp: bool = True) -> ShardingPlan:
    dp = dp_axes(mesh)
    rules = {
        "embed": dp if (fsdp and dp) else None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "ssm_inner": "model",
        "vocab": "model",
        "expert": dp if dp else None,
        "layers": None,
    }
    return ShardingPlan(mesh=mesh, rules=rules)


def _batch_rule(mesh: DeviceMesh, batch: int):
    dp = dp_axes(mesh)
    return dp if dp and batch % _dp_size(mesh) == 0 else None


def batch_pspecs(cfg: ModelConfig, mesh: DeviceMesh, kind: str,
                 batch: int) -> dict[str, P]:
    """PartitionSpecs for the model-input batch dict of a train/prefill
    cell; keys mirror launch/dryrun.py::input_specs."""
    b = _batch_rule(mesh, batch)
    specs: dict[str, P] = {}
    if cfg.family == "encdec":
        specs["frames"] = P(b, None, None)
    if cfg.family == "vlm":
        specs["patch_embeds"] = P(b, None, None)
    specs["tokens"] = P(b, None)
    if kind == "train":
        specs["labels"] = P(b, None)
        specs["loss_mask"] = P(b, None)
    return specs


def cache_pspecs(cfg: ModelConfig, mesh: DeviceMesh, caches, batch: int):
    """PartitionSpecs for a decode-cache tree.

    Every cache leaf is stacked with a leading group axis (see
    models/transformer.py::init_caches), so the batch dim is axis 1; it is
    sharded over the DP axes when divisible, everything else replicated."""
    b = _batch_rule(mesh, batch)

    def one(x):
        parts = [None] * x.ndim
        if x.ndim >= 2:
            parts[1] = b
        return P(*parts)

    return tree_map(one, caches)


def to_placements(spec: P, mesh: DeviceMesh) -> tuple:
    """One DTensor placement per mesh dim: Shard(d) where the spec puts
    that mesh axis on tensor dim d, else Replicate()."""
    names = _axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} of dim {d} are not in "
                             f"the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def distribute(tree, pspecs, mesh: DeviceMesh, *, src_data_rank: int | None = 0):
    """Each leaf of a tensor tree as a DTensor over `mesh` with its spec's
    placements (`distribute_tensor`: every rank keeps its own shard; with
    `src_data_rank=None` from its own copy, else scattered from that
    rank). Leaves are made contiguous first: a DTensor's spec carries the
    global strides, and ranks whose specs differ can choose different
    collectives for the same op."""
    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k]) for k in t}
        if t is None:
            return None
        return distribute_tensor(t.contiguous(), mesh, to_placements(s, mesh),
                                 src_data_rank=src_data_rank)
    return walk(tree, pspecs)
