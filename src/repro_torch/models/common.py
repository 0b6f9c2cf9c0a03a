"""Param-spec substrate (port of `repro/models/common.py`).

Every parameter is declared as a ParamSpec with *logical* axis names
(("layers", "embed", "mlp"), ("vocab", "embed"), ...). Consumers here:

  init_params(specs, generator, device) -> concrete tensor tree
  abstract_params(specs)                -> tensors on the meta device (no
                                           allocation: a 314B config is
                                           counted without memory)
  params_from_numpy(tree)               -> the reference's numpy tree as the
                                           port's, name for name
  param_pspecs(specs, rules)            -> PartitionSpec tree (placements
                                           through repro_torch.dist)

Trees are nested dicts whose leaves are tensors, exactly the reference's
layout (stacked `groups`/`rem` leaves, `shared_attn`). Leaves are visited
in sorted-key order, the order `jax.tree.flatten` gives a dict.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

__all__ = ["ParamSpec", "init_params", "abstract_params", "param_pspecs",
           "tree_size", "tree_map", "tree_leaves", "params_from_numpy",
           "caches_from_numpy", "tree_to_numpy", "tree_index",
           "register_params", "param_tree", "remat_call", "tree_unstack"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical names, len == ndim
    init: str = "normal"                  # normal | zeros | ones | embed
    scale: float | None = None            # stddev override
    fan_in_axes: tuple[int, ...] = ()     # dims counted as fan-in for scaling
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable, tree):
    """Apply `fn` to every leaf of a nested dict (None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in jax.tree.flatten order: dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def tree_index(tree, i: int):
    """Layer i of a stacked subtree (views, no copies), or of its
    `tree_unstack`: a tuple leaf's i-th tensor."""
    return tree_map(lambda a: a[i], tree)


def tree_unstack(tree):
    """Each stacked leaf as the tuple of its layers' views. A forward that
    reads its layers from this gets one gradient per stacked leaf from
    unbind's backward (one stack); reading `a[g]` of a leaf that requires
    grad would fill and add a zero tensor the size of the whole stack in
    every layer's select backward."""
    return tree_map(lambda a: a.unbind(0), tree)


def remat_call(fn: Callable, remat: bool, *args):
    """fn(*args); with `remat`, and when a backward can follow, under
    `torch.utils.checkpoint` (the reference's `jax.checkpoint`): the
    backward recomputes fn's activations instead of keeping them. No
    value of the forward or of a gradient changes."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def register_params(module: nn.Module, tree: dict) -> None:
    """Register a tensor tree as `module`'s parameters under the same
    nested names (`groups.p0.wq`); serving takes no gradients."""
    for name, val in tree.items():
        if isinstance(val, dict):
            child = nn.Module()
            register_params(child, val)
            module.add_module(name, child)
        else:
            module.register_parameter(
                name, nn.Parameter(val, requires_grad=False))


def param_tree(module: nn.Module) -> dict:
    """The nested dict of parameters `register_params` registered."""
    tree: dict[str, Any] = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        tree[name] = param_tree(child)
    return tree


def _leaf_init(spec: ParamSpec, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.scale is not None:
        std = spec.scale
    elif spec.fan_in_axes:
        fan_in = math.prod(spec.shape[a] for a in spec.fan_in_axes)
        std = 1.0 / math.sqrt(max(fan_in, 1))
    else:
        std = 0.02
    draw = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
    return (draw * std).to(device=device, dtype=spec.dtype)


def init_params(specs, generator: torch.Generator,
                device: str | torch.device | None = None) -> Any:
    """Materialize a ParamSpec tree: normal * std (std from `scale`, else
    1/sqrt(fan-in) over `fan_in_axes`, else 0.02), zeros and ones. Normals
    are drawn leaf by leaf in sorted-key order from `generator`, on the
    generator's device, and land on `device` (the generator's by default),
    so a CPU generator gives the same weights on any card."""
    device = torch.device(device) if device is not None else generator.device

    def walk(t):
        if isinstance(t, dict):
            drawn = {k: walk(t[k]) for k in sorted(t)}
            return {k: drawn[k] for k in t}
        return _leaf_init(t, generator, device)

    return walk(specs)


def abstract_params(specs) -> Any:
    """Shapes and dtypes only, as tensors on the meta device."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def param_pspecs(specs, rules: dict[str, str | tuple | None]) -> Any:
    """Logical axes -> PartitionSpec via the rules table.

    A rule value may be a mesh axis name, a tuple of mesh axes, or None.
    Unlisted logical axes are unsharded. Mesh axes already used by an
    earlier dim of the same param are dropped (a spec never repeats an
    axis). No divisibility filter, as in the reference: that is
    `repro_torch.dist.sharding.ShardingPlan`'s."""
    from repro_torch.dist.sharding import PartitionSpec as P

    def one(s: ParamSpec):
        used: set[str] = set()
        parts: list[Any] = []
        for name in s.axes:
            rule = rules.get(name) if name is not None else None
            if rule is None:
                parts.append(None)
                continue
            axes = rule if isinstance(rule, tuple) else (rule,)
            axes = tuple(a for a in axes if a not in used)
            if not axes:
                parts.append(None)
            elif len(axes) == 1:
                parts.append(axes[0])
                used.add(axes[0])
            else:
                parts.append(axes)
                used.update(axes)
        return P(*parts)

    return tree_map(one, specs)


def tree_size(tree) -> int:
    """Total element count (params) of a tensor, array or ParamSpec tree."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))


def _from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 has no torch counterpart in from_numpy: carry
        # the 16 bits across and reinterpret them, so every bit is kept
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device: str | torch.device | None = None) -> Any:
    """The reference's parameter tree, given as numpy arrays (for example
    `jax.tree.map(np.asarray, params)`), as the port's: the same nested
    names and stacked layout, each leaf copied (the port's decode updates
    caches in place, so no leaf may share the caller's buffer). `device`
    follows the port's rule: None means cuda and raises without a card."""
    device = resolve_device(device)
    return tree_map(lambda a: _from_numpy(a, device), tree)


# a cache tree of the reference crosses the same way
caches_from_numpy = params_from_numpy


def tree_to_numpy(tree) -> Any:
    """The port's tensors as numpy arrays; bf16 leaves as float32 (exact)."""
    return tree_map(lambda t: (t.float() if t.dtype == torch.bfloat16 else t)
                    .detach().cpu().numpy(), tree)
