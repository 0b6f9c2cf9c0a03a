"""Per-rank cost of one run of a step, counted op by op (the port's analog
of `repro/launch/hlocost.py`).

The reference re-derives its roofline inputs from optimized per-device
HLO text, multiplying `while` bodies by their trip counts. The port has
no HLO: a step is eager PyTorch, so `CostMode` (a `TorchDispatchMode`)
watches one run of it and adds up what each rank's local ops do. Every
loop trip runs, so there is no trip-count parser. On a mesh the DTensor
level is let through (`NotImplemented`), DTensor turns each op into local
ops on the rank's shards and collectives, and those come back here: the
figures are per rank, not the global ones a DTensor op would give. The
runs DTensor makes on fake tensors at the global shape (to learn an op's
output shape) are not counted.

The record keeps the reference's `HloCost` fields:

  flops             — `torch.utils.flop_counter`'s formulas (mm, bmm,
                      addmm, baddbmm, convolutions, attention kernels)
                      applied to the local ops; elementwise arithmetic is
                      not counted
  bytes             — each non-view op's input and output bytes: an
                      unfused upper bound (every intermediate goes through
                      memory), not XLA's post-fusion figure
  collectives       — per kind, the result bytes of each `_c10d_functional`
                      collective ("all-reduce", "all-gather",
                      "reduce-scatter" at its input's bytes as the
                      reference counts a ring's, "all-to-all",
                      "broadcast"); `wire_bytes` counts an all-reduce 2x
                      (ring reduce-scatter + all-gather), others 1x
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["HloCost", "CostMode"]

# _c10d_functional op name -> the reference's collective kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))

    @property
    def wire_bytes(self) -> float:
        return sum(v * (2.0 if k == "all-reduce" else 1.0)
                   for k, v in self.collectives.items())


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class CostMode(TorchDispatchMode):
    """`with CostMode() as m: step(...)`, then `m.cost` holds one rank's
    flops, bytes and collective bytes of the ops that ran."""

    def __init__(self):
        super().__init__()
        self.cost = HloCost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # let DTensor lower it to local ops
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in ins):
            # DTensor's sharding propagation running the op at its global
            # shape (once per op signature) to learn the output's shape
            return out
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:
                in_b, out_b = _nbytes(ins), _nbytes(_tensors(out))
                # a ring reduce-scatter moves its input's bytes
                self.cost.collectives[kind] += (max(in_b, out_b)
                                                if kind == "reduce-scatter"
                                                else out_b)
                self.cost.bytes += in_b + out_b
            return out
        if packet in flop_registry:
            self.cost.flops += flop_registry[packet](*args, **kwargs,
                                                     out_val=out)
        if not func.is_view:
            self.cost.bytes += _nbytes(ins) + _nbytes(_tensors(out))
        return out
