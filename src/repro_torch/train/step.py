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

The prefill and decode steps run under `torch.inference_mode()`.
"""
from __future__ import annotations

import torch

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
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = (logz - gold) * mask
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


def make_grad_fn(cfg: ModelConfig, *, grad_accum: int = 1,
                 remat: bool = True):
    """(params, batch) -> (loss, grads): the mean loss and the gradient of
    every leaf of `params`, in its tree. With `grad_accum > 1` the batch's
    leading dim is split into that many micro-batches; their gradients are
    summed in the param dtype (f32 for f32 params, as the reference's
    `acc_dt`), then divided by `grad_accum`, as is the loss."""
    loss_fn = make_loss_fn(cfg, remat=remat)

    def one(inputs, batch):
        leaves = tree_leaves(inputs)
        loss, _ = loss_fn(inputs, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        of = {id(x): torch.zeros_like(x) if g is None else g
              for x, g in zip(leaves, grads)}
        return loss.detach(), tree_map(lambda x: of[id(x)], inputs)

    def grad_fn(params, batch):
        # autograd leaves sharing the params' storage
        inputs = tree_map(lambda p: p.detach().requires_grad_(), params)
        if grad_accum == 1:
            return one(inputs, batch)
        split = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                              + v.shape[1:]) for k, v in batch.items()}
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
            with torch.inference_mode():
                return W.whisper_forward(cfg, params, batch["frames"],
                                         batch["tokens"], remat=remat)
        return prefill

    def prefill(params, batch):
        prefix = batch.get("patch_embeds") if cfg.family == "vlm" else None
        with torch.inference_mode():
            return T.lm_forward(cfg, params, batch["tokens"],
                                prefix_embeds=prefix, remat=remat)
    return prefill


def make_decode_step(cfg: ModelConfig):
    """serve_step: one new token against a KV cache:
    (params, caches, token, pos) -> (logits, caches), caches in place."""
    step = W.whisper_decode_step if cfg.family == "encdec" else T.lm_decode_step

    def decode(params, caches, token, pos):
        with torch.inference_mode():
            return step(cfg, params, caches, token, pos)
    return decode
