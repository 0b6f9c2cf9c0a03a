"""Train / prefill / decode step builders for every architecture family
(port of `repro/train/step.py`).

`make_train_step(cfg, opt_cfg)` returns
    (params, opt_state, batch) -> (params, opt_state, metrics)
which updates params and moments in place (the reference's donation).
Batches are dicts, as in the reference:

  lm:     tokens (B,S) int, labels (B,S) int, loss_mask (B,S) f32
  vlm:    + patch_embeds (B,P,D) f32 (stub frontend output)
  encdec: frames (B,Te,D) f32, tokens/labels/loss_mask over decoder seq

Gradients come from `torch.autograd.grad` over the tree's leaves. The
forwards read the layers of a stacked leaf through `tree_unstack`, so the
backward stacks each leaf's layer gradients once, as the reference's scan
transpose writes one stacked buffer.

Gradient accumulation: `grad_accum > 1` splits the batch's leading dim
into micro-batches and sums their gradients (f32 for f32 params, the
param dtype otherwise), then divides by `grad_accum`.

The prefill and decode steps run under `torch.inference_mode()` (under
`torch.no_grad()` on a mesh).

On a mesh (`repro_torch.launch.train --mesh`, `launch/dryrun.py`) the
params and the batch are DTensors placed by `repro_torch.dist.sharding`'s
plan, and the same code runs on them: the forward and backward run under
DTensor's implicit replication, so a plain tensor the model makes (the
positions, the masks) counts as the same on every rank; the loss comes
back as a plain tensor, the gradients as DTensors.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import OptConfig, opt_update

__all__ = ["make_loss_fn", "make_grad_fn", "make_train_step",
           "make_prefill_step", "make_decode_step", "cross_entropy"]


def cross_entropy(logits, labels, mask):
    """Masked mean CE. logits (B,S,V) f32; labels (B,S) int; mask (B,S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())
    # the difference is taken before the trailing unit dim is dropped: on
    # a vocab-sharded DTensor the gather is a masked partial sum, which
    # DTensor can reduce only in the gather's own shape
    ce = (logz[..., None] - gold)[..., 0] * mask
    denom = mask.sum().clamp_min(1.0)
    return ce.sum() / denom


def make_loss_fn(cfg: ModelConfig, *, remat: bool = True):
    """(params, batch) -> (loss, {"loss": loss}). `remat` changes no value;
    with it a backward recomputes each layer's activations."""
    if cfg.family == "encdec":
        def loss_fn(params, batch):
            logits = W.whisper_forward(cfg, params, batch["frames"],
                                       batch["tokens"], remat=remat)
            loss = cross_entropy(logits, batch["labels"], batch["loss_mask"])
            return loss, {"loss": loss}
        return loss_fn

    def loss_fn(params, batch):
        prefix = batch.get("patch_embeds") if cfg.family == "vlm" else None
        logits = T.lm_forward(cfg, params, batch["tokens"],
                              prefix_embeds=prefix, remat=remat)
        if prefix is not None:
            logits = logits[:, cfg.prefix_len:]
        loss = cross_entropy(logits, batch["labels"], batch["loss_mask"])
        return loss, {"loss": loss}
    return loss_fn


def _mesh_scope(tree):
    """DTensor's implicit replication when `tree`'s leaves are DTensors
    (a meshed step), else nothing."""
    leaves = tree_leaves(tree)
    if leaves and isinstance(leaves[0], DTensor):
        return implicit_replication()
    return contextlib.nullcontext()


@contextlib.contextmanager
def _serve_scope(params):
    """`torch.inference_mode()`; on a mesh `torch.no_grad()` (DTensor's
    views cannot be made in inference mode) and implicit replication."""
    if not isinstance(tree_leaves(params)[0], DTensor):
        with torch.inference_mode():
            yield
        return
    with torch.no_grad(), implicit_replication():
        yield


def _micro_batches(v, grad_accum: int) -> list:
    """The batch leaf's leading dim split into `grad_accum` micro-batches
    (rows [a*B/ga, (a+1)*B/ga)), as the reference's reshape. A DTensor is
    gathered over its mesh first and each micro-batch placed as the
    batch was."""
    if not isinstance(v, DTensor):
        return list(v.reshape((grad_accum, v.shape[0] // grad_accum)
                              + v.shape[1:]))
    mesh, pl = v.device_mesh, v.placements
    full = v.redistribute(mesh, [Replicate()] * mesh.ndim)
    full = full.reshape((grad_accum, v.shape[0] // grad_accum) + v.shape[1:])
    return [full[a].redistribute(mesh, pl) for a in range(grad_accum)]


def make_grad_fn(cfg: ModelConfig, *, grad_accum: int = 1,
                 remat: bool = True):
    """(params, batch) -> (loss, grads): the mean loss and the gradient of
    every leaf of `params`, in its tree. With `grad_accum > 1` the batch's
    leading dim is split into that many micro-batches; their gradients are
    summed in the param dtype (f32 for f32 params, as the reference's
    `acc_dt`), then divided by `grad_accum`, as is the loss. On a mesh
    the loss is gathered to a plain tensor."""
    loss_fn = make_loss_fn(cfg, remat=remat)

    def one(inputs, batch):
        leaves = tree_leaves(inputs)
        loss, _ = loss_fn(inputs, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        of = {id(x): torch.zeros_like(x) if g is None else g
              for x, g in zip(leaves, grads)}
        loss = loss.detach()
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        return loss, tree_map(lambda x: of[id(x)], inputs)

    def grad_fn(params, batch):
        # autograd leaves sharing the params' storage
        inputs = tree_map(lambda p: p.detach().requires_grad_(), params)
        with _mesh_scope(params):
            if grad_accum == 1:
                return one(inputs, batch)
            split = {k: _micro_batches(v, grad_accum)
                     for k, v in batch.items()}
            grads = tree_map(torch.zeros_like, params)
            loss = 0.0
            for a in range(grad_accum):
                l, g = one(inputs, {k: v[a] for k, v in split.items()})
                for acc, x in zip(tree_leaves(grads), tree_leaves(g)):
                    acc += x.to(acc.dtype)
                loss = loss + l
            for acc in tree_leaves(grads):
                acc /= grad_accum
            return loss / grad_accum, grads

    return grad_fn


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, *,
                    grad_accum: int = 1, remat: bool = True):
    """(params, opt_state, batch) -> (params, opt_state, metrics) with the
    reference's metric keys (loss, lr, grad_norm); params and moments are
    updated in place."""
    grad_fn = make_grad_fn(cfg, grad_accum=grad_accum, remat=remat)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        params, opt_state, om = opt_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, *, remat: bool = False):
    """Inference forward (logits only): (params, batch) -> logits."""
    if cfg.family == "encdec":
        def prefill(params, batch):
            with _serve_scope(params):
                return W.whisper_forward(cfg, params, batch["frames"],
                                         batch["tokens"], remat=remat)
        return prefill

    def prefill(params, batch):
        prefix = batch.get("patch_embeds") if cfg.family == "vlm" else None
        with _serve_scope(params):
            return T.lm_forward(cfg, params, batch["tokens"],
                                prefix_embeds=prefix, remat=remat)
    return prefill


def make_decode_step(cfg: ModelConfig):
    """serve_step: one new token against a KV cache:
    (params, caches, token, pos) -> (logits, caches), caches in place."""
    step = W.whisper_decode_step if cfg.family == "encdec" else T.lm_decode_step

    def decode(params, caches, token, pos):
        with _serve_scope(params):
            return step(cfg, params, caches, token, pos)
    return decode
