"""AdamW from scratch, with dtype policies for multi-hundred-B models (port
of `repro/train/optimizer.py`).

State dtype policy: `state_dtype="float32"` default; `"bfloat16"` moments
for the giants. Params stay in their declared dtype (no separate master
copy): the update math runs in f32 and casts back.

The update is in place, leaf by leaf, under `torch.no_grad()`, as the
reference's buffer donation lets XLA do: at qwen1.5-4b's full width a
functional copy of params and moments (47 GB) would not fit beside them.
Each leaf is worked through in flat chunks of at most `CHUNK` elements, so
the temporaries of the update stay at a few chunks whatever the leaf's
size. The f32 arithmetic follows the reference's expressions operation
for operation (each product and sum rounded on its own).

On a mesh the leaves are DTensors. AdamW is elementwise, so each gradient
is redistributed to its moments' placements (a reduce-scatter where it is
a partial sum) and the update runs unchanged on the local shards of p, g,
m and v. The global norm is each leaf's local sum of squares, summed over
the mesh dims that shard it: it matches one device's within rounding, not
bit for bit. Where the params are placed otherwise than the moments (the
dry run's zero1: params TP-only, moments FSDP-sharded) a param's block at
the moments' placements is updated and gathered back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.models.common import tree_leaves, tree_map

__all__ = ["OptConfig", "OptState", "opt_init", "opt_update", "lr_at",
           "global_norm"]

f32 = torch.float32
CHUNK = 1 << 24          # elements of one leaf updated at a time (64 MB f32)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"       # moments dtype

    @property
    def sdt(self) -> torch.dtype:
        return torch.bfloat16 if self.state_dtype == "bfloat16" else f32


class OptState(NamedTuple):
    m: object
    v: object
    step: torch.Tensor       # 0-d int32, as the reference's checkpoints hold it


def opt_init(params, cfg: OptConfig) -> OptState:
    """Zero moments in `cfg`'s state dtype, each placed as its param (a
    DTensor param gives DTensor moments)."""
    zeros = lambda p: torch.zeros_like(p, dtype=cfg.sdt)
    device = tree_leaves(params)[0].device
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def lr_at(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Warm-up then cosine decay to `min_lr_ratio`, in f32 (0-d)."""
    step = step.to(f32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    if isinstance(x, DTensor):
        # the local shard's sum, summed over the mesh dims that shard it
        if any(p.is_partial() for p in x.placements):
            raise ValueError("a partial-sum gradient has no norm; "
                             "redistribute it first")
        pl = [Partial() if p.is_shard() else Replicate()
              for p in x.placements]
        return DTensor.from_local(_sum_sq(x.to_local()), x.device_mesh, pl,
                                  run_check=False).full_tensor()
    flat = x.reshape(-1)
    parts = [torch.sum(flat[i:i + CHUNK].to(f32) ** 2)
             for i in range(0, max(flat.numel(), 1), CHUNK)]
    return torch.stack(parts).sum() if len(parts) > 1 else parts[0]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the per-leaf f32 sums of squares, in leaf order
    (a plain tensor for DTensor leaves too)."""
    return _norm(tree_leaves(tree))


def _norm(leaves: list) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack([_sum_sq(g) for g in leaves])))


def _adamw_(p, g, m, v, *, scale, lr, b1t, b2t, wd: float,
            cfg: OptConfig) -> None:
    """One leaf, in place, chunk by chunk:
    the reference's `upd` with each rounding in the same order."""
    pf, mf, vf = p.view(-1), m.view(-1), v.view(-1)
    gf = g.reshape(-1)
    for i in range(0, pf.numel(), CHUNK):
        pc, gc = pf[i:i + CHUNK], gf[i:i + CHUNK]
        mc, vc = mf[i:i + CHUNK], vf[i:i + CHUNK]
        g32 = gc.to(f32) * scale
        m32 = mc.to(f32) * cfg.b1
        m32 += g32 * (1 - cfg.b1)
        t = g32 * (1 - cfg.b2)
        t *= g32
        v32 = vc.to(f32) * cfg.b2
        v32 += t
        den = v32 / b2t
        den.sqrt_()
        den += cfg.eps
        upd = m32 / b1t
        upd /= den
        p32 = pc.to(f32)
        if wd:
            upd += p32 * wd
        upd *= lr
        pc.copy_(p32 - upd)
        mc.copy_(m32)
        vc.copy_(v32)


def opt_update(grads, state: OptState, params, cfg: OptConfig):
    """One AdamW step, in place on `params` and the moments of `state`.
    Returns (params, new_state, metrics); `new_state` holds the same
    moment tensors and a new step counter."""
    with torch.no_grad():
        g_leaves = [g.redistribute(m.device_mesh, m.placements)
                    if isinstance(m, DTensor) else g
                    for g, m in zip(tree_leaves(grads), tree_leaves(state.m))]
        step = state.step + 1
        lr = lr_at(step, cfg)
        gnorm = _norm(g_leaves)
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        b1t = 1 - torch.pow(cfg.b1, step.to(f32))
        b2t = 1 - torch.pow(cfg.b2, step.to(f32))
        for p, g, m, v in zip(tree_leaves(params), g_leaves,
                              tree_leaves(state.m), tree_leaves(state.v)):
            # decoupled weight decay on >=2D leaves only (norms/biases
            # exempt); a stacked leaf counts its layers axis, as there
            wd = cfg.weight_decay if p.ndim >= 2 else 0.0
            kw = dict(scale=scale, lr=lr, b1t=b1t, b2t=b2t, wd=wd, cfg=cfg)
            if not isinstance(p, DTensor):
                _adamw_(p, g, m, v, **kw)
            elif p.placements == m.placements:
                _adamw_(p.to_local(), g.to_local(), m.to_local(),
                        v.to_local(), **kw)
            else:
                mesh = m.device_mesh
                blk = p.redistribute(mesh, m.placements)
                _adamw_(blk.to_local(), g.to_local(), m.to_local(),
                        v.to_local(), **kw)
                p.to_local().copy_(blk.redistribute(mesh, p.placements)
                                   .to_local())
    return params, OptState(state.m, state.v, step), {"lr": lr,
                                                      "grad_norm": gnorm}
