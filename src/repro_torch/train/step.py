"""The loss, prefill and decode steps of every architecture family
(port of `repro/train/step.py`, the serving half).

Batches are dicts, as in the reference:

  lm:     tokens (B,S) int, labels (B,S) int, loss_mask (B,S) f32
  vlm:    + patch_embeds (B,P,D) f32 (stub frontend output)
  encdec: frames (B,Te,D) f32, tokens/labels/loss_mask over decoder seq

The prefill and decode steps run under `torch.inference_mode()`.
`make_train_step` (and the optimizer it needs) comes with the training
slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.config import ModelConfig

__all__ = ["make_loss_fn", "make_prefill_step", "make_decode_step",
           "cross_entropy"]


def cross_entropy(logits, labels, mask):
    """Masked mean CE. logits (B,S,V) f32; labels (B,S) int; mask (B,S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = (logz - gold) * mask
    denom = mask.sum().clamp_min(1.0)
    return ce.sum() / denom


def make_loss_fn(cfg: ModelConfig, *, remat: bool = True):
    """(params, batch) -> (loss, {"loss": loss}), the forward only. `remat`
    changes no value of a forward pass; it matters from the training slice
    on, where the backward recomputes activations."""
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
