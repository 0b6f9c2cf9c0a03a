"""Whisper-family encoder-decoder backbone, conv frontend stubbed (port of
`repro/models/whisper.py`).

The modality frontend is a stub: precomputed frame embeddings (B, T_enc,
d) go straight into the encoder. Encoder: bidirectional pre-LN
transformer (layernorm + GELU, sinusoidal positions). Decoder: causal
self-attention + cross-attention to the encoder output + GELU MLP, learned
positions. Decode caches self-attention K/V per step, written in place,
and cross-attention K/V once (`repro_torch.launch.serve.prefill_cross_caches`).
The reference's scans over layers are Python loops over the stacked axis.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.dist import act
from repro_torch.models.common import (ParamSpec, init_params, param_tree,
                                       register_params, remat_call,
                                       tree_index, tree_unstack)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (chunked_attention, decode_attention,
                                       gelu, layer_norm)

__all__ = ["whisper_param_specs", "whisper_forward", "whisper_init_caches",
           "whisper_decode_step", "whisper_encode", "WhisperLM"]

f32 = torch.float32


def _sinusoids(length: int, d: int, device) -> torch.Tensor:
    half = d // 2
    # f32 throughout, as jnp.log(10000.0) and the division round in f32
    step = torch.log(torch.tensor(10000.0, dtype=f32, device=device)) / (half - 1)
    freqs = torch.exp(-torch.arange(half, dtype=f32, device=device) * step)
    ang = torch.arange(length, dtype=f32, device=device)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def _attn_specs(cfg: ModelConfig, stack, cross: bool) -> dict:
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    L = ("layers",) * len(stack)
    pdt = cfg.pdt
    pre = "x" if cross else "s"
    return {
        f"{pre}_ln_w": ParamSpec(stack + (d,), L + ("embed",), init="ones", dtype=pdt),
        f"{pre}_ln_b": ParamSpec(stack + (d,), L + ("embed",), init="zeros", dtype=pdt),
        f"{pre}_wq": ParamSpec(stack + (d, H * hd), L + ("embed", "heads"),
                               fan_in_axes=(len(stack),), dtype=pdt),
        f"{pre}_wk": ParamSpec(stack + (d, H * hd), L + ("embed", "heads"),
                               fan_in_axes=(len(stack),), dtype=pdt),
        f"{pre}_wv": ParamSpec(stack + (d, H * hd), L + ("embed", "heads"),
                               fan_in_axes=(len(stack),), dtype=pdt),
        f"{pre}_bq": ParamSpec(stack + (H * hd,), L + ("heads",), init="zeros", dtype=pdt),
        f"{pre}_bv": ParamSpec(stack + (H * hd,), L + ("heads",), init="zeros", dtype=pdt),
        f"{pre}_wo": ParamSpec(stack + (H * hd, d), L + ("heads", "embed"),
                               fan_in_axes=(len(stack),), dtype=pdt),
        f"{pre}_bo": ParamSpec(stack + (d,), L + ("embed",), init="zeros", dtype=pdt),
    }


def _mlp_specs(cfg: ModelConfig, stack) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    L = ("layers",) * len(stack)
    pdt = cfg.pdt
    return {
        "m_ln_w": ParamSpec(stack + (d,), L + ("embed",), init="ones", dtype=pdt),
        "m_ln_b": ParamSpec(stack + (d,), L + ("embed",), init="zeros", dtype=pdt),
        "w_up": ParamSpec(stack + (d, ff), L + ("embed", "mlp"),
                          fan_in_axes=(len(stack),), dtype=pdt),
        "b_up": ParamSpec(stack + (ff,), L + ("mlp",), init="zeros", dtype=pdt),
        "w_down": ParamSpec(stack + (ff, d), L + ("mlp", "embed"),
                            fan_in_axes=(len(stack),), dtype=pdt),
        "b_down": ParamSpec(stack + (d,), L + ("embed",), init="zeros", dtype=pdt),
    }


def whisper_param_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    Le, Ld = cfg.encoder_layers, cfg.n_layers
    pdt = cfg.pdt
    return {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), dtype=pdt),
        # learned decoder positions; sized for the largest decode shape
        "pos_dec": ParamSpec((32768, d), (None, "embed"), scale=0.01, dtype=pdt),
        "enc": {**_attn_specs(cfg, (Le,), cross=False), **_mlp_specs(cfg, (Le,))},
        "enc_ln_w": ParamSpec((d,), ("embed",), init="ones", dtype=pdt),
        "enc_ln_b": ParamSpec((d,), ("embed",), init="zeros", dtype=pdt),
        "dec": {**_attn_specs(cfg, (Ld,), cross=False),
                **_attn_specs(cfg, (Ld,), cross=True),
                **_mlp_specs(cfg, (Ld,))},
        "dec_ln_w": ParamSpec((d,), ("embed",), init="ones", dtype=pdt),
        "dec_ln_b": ParamSpec((d,), ("embed",), init="zeros", dtype=pdt),
    }


def _mha(cfg, x, kv, p, pre, *, causal):
    """Pre-LN multi-head attention (full MHA, biases per Whisper)."""
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    h = layer_norm(x, p[f"{pre}_ln_w"], p[f"{pre}_ln_b"])
    hk = layer_norm(kv, p[f"{pre}_ln_w"], p[f"{pre}_ln_b"]) if kv is not x else h
    q = h @ p[f"{pre}_wq"].to(h.dtype) + p[f"{pre}_bq"].to(h.dtype)
    k = hk @ p[f"{pre}_wk"].to(h.dtype)
    v = hk @ p[f"{pre}_wv"].to(h.dtype) + p[f"{pre}_bv"].to(h.dtype)
    T = kv.shape[1]
    q, k, v = (act.tile(t, -1, H) for t in (q, k, v))
    o = chunked_attention(q.reshape(B, S, H, hd), k.reshape(B, T, H, hd),
                          v.reshape(B, T, H, hd), causal=causal,
                          q_chunk=min(cfg.q_chunk, S), kv_chunk=min(cfg.kv_chunk, T))
    o = act.shard_model(o.reshape(B, S, H * hd), -1)
    return x + (o @ p[f"{pre}_wo"].to(h.dtype) + p[f"{pre}_bo"].to(h.dtype))


def _mlp(cfg, x, p):
    h = layer_norm(x, p["m_ln_w"], p["m_ln_b"])
    h = gelu(h @ p["w_up"].to(h.dtype) + p["b_up"].to(h.dtype))
    return x + (h @ p["w_down"].to(h.dtype) + p["b_down"].to(h.dtype))


def whisper_encode(cfg: ModelConfig, params, frames):
    """frames (B, T_enc, d) precomputed frame embeddings (conv stub). As in
    the reference, every encoder layer is rematerialized in a backward."""
    x = act.btd(frames.to(cfg.cdt) + _sinusoids(frames.shape[1], cfg.d_model,
                                                frames.device).to(cfg.cdt))

    def body(x, p):
        return act.btd(_mlp(cfg, _mha(cfg, x, x, p, "s", causal=False), p))

    layers = tree_unstack(params["enc"])
    for l in range(cfg.encoder_layers):
        x = remat_call(body, True, x, tree_index(layers, l))
    return layer_norm(x, params["enc_ln_w"], params["enc_ln_b"])


def whisper_forward(cfg: ModelConfig, params, frames, tokens,
                    *, remat: bool = True):
    """Teacher-forced forward. Returns logits (B, S_dec, vocab) f32. With
    `remat` each decoder layer runs under `remat_call`."""
    enc = whisper_encode(cfg, params, frames)
    B, S = tokens.shape
    # hazard b: gather, then cast
    x = act.btd(act.embed(params["embed"], tokens).to(cfg.cdt)
                + params["pos_dec"][:S].to(cfg.cdt))

    def body(x, p):
        x = _mha(cfg, x, x, p, "s", causal=True)
        x = _mha(cfg, x, enc, p, "x", causal=False)
        return act.btd(_mlp(cfg, x, p))

    layers = tree_unstack(params["dec"])
    for l in range(cfg.n_layers):
        x = remat_call(body, remat, x, tree_index(layers, l))
    x = layer_norm(x, params["dec_ln_w"], params["dec_ln_b"])
    return act.logits_spec((x @ params["embed"].T.to(x.dtype)).to(f32))


def whisper_init_caches(cfg: ModelConfig, batch: int, smax: int,
                        device: str | torch.device | None = None) -> dict:
    device = resolve_device(device)
    Ld, H, hd = cfg.n_layers, cfg.n_heads, cfg.hd
    Te = cfg.encoder_seq

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.cdt, device=device)

    return {"self_k": zeros(Ld, batch, smax, H, hd),
            "self_v": zeros(Ld, batch, smax, H, hd),
            "cross_k": zeros(Ld, batch, Te, H, hd),
            "cross_v": zeros(Ld, batch, Te, H, hd)}


def whisper_decode_step(cfg: ModelConfig, params, caches, token, pos):
    """token (B,), pos (B,). Cross K/V must be pre-filled (from
    whisper_encode via prefill); self K/V are written in place at pos.
    Returns (logits (B, vocab) f32, caches)."""
    B = token.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    x = (act.embed(params["embed"], token).to(cfg.cdt)
         + act.embed(params["pos_dec"], pos).to(cfg.cdt))
    cross_pos = torch.full((B,), cfg.encoder_seq - 1, dtype=torch.int64,
                           device=token.device)
    for l in range(cfg.n_layers):
        p = tree_index(params["dec"], l)
        sk, sv = caches["self_k"][l], caches["self_v"][l]
        ck, cv = caches["cross_k"][l], caches["cross_v"][l]
        h = layer_norm(x[:, None, :], p["s_ln_w"], p["s_ln_b"])[:, 0]
        q = (h @ p["s_wq"].to(h.dtype) + p["s_bq"].to(h.dtype)).reshape(B, H, hd)
        k = (h @ p["s_wk"].to(h.dtype)).reshape(B, H, hd)
        v = (h @ p["s_wv"].to(h.dtype) + p["s_bv"].to(h.dtype)).reshape(B, H, hd)
        act.put_rows_(sk, pos, k.to(sk.dtype))
        act.put_rows_(sv, pos, v.to(sv.dtype))
        o = decode_attention(q, sk, sv, pos)
        x = x + (o.reshape(B, H * hd) @ p["s_wo"].to(h.dtype)
                 + p["s_bo"].to(h.dtype))
        # cross attention over the (static) encoder cache
        h = layer_norm(x[:, None, :], p["x_ln_w"], p["x_ln_b"])[:, 0]
        q = (h @ p["x_wq"].to(h.dtype) + p["x_bq"].to(h.dtype)).reshape(B, H, hd)
        o = decode_attention(q, ck, cv, cross_pos)
        x = x + (o.reshape(B, H * hd) @ p["x_wo"].to(h.dtype)
                 + p["x_bo"].to(h.dtype))
        h = layer_norm(x[:, None, :], p["m_ln_w"], p["m_ln_b"])[:, 0]
        h = gelu(h @ p["w_up"].to(h.dtype) + p["b_up"].to(h.dtype))
        x = x + (h @ p["w_down"].to(h.dtype) + p["b_down"].to(h.dtype))
    x = layer_norm(x[:, None, :], params["dec_ln_w"], params["dec_ln_b"])[:, 0]
    return (x @ params["embed"].T.to(x.dtype)).to(f32), caches


class WhisperLM(nn.Module):
    """Whisper as an `nn.Module` over the tree of `whisper_param_specs`,
    under the reference's names, drawn from `generator` (seeded 0 on
    `device` by default). `device=None` means the card."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        self.cfg = cfg
        register_params(self, init_params(whisper_param_specs(cfg), generator, device))

    def params(self) -> dict:
        return param_tree(self)

    def forward(self, frames, tokens):
        return whisper_forward(self.cfg, self.params(), frames, tokens)

    def init_caches(self, batch: int, smax: int) -> dict:
        return whisper_init_caches(self.cfg, batch, smax, self.embed.device)

    def decode_step(self, caches, token, pos):
        return whisper_decode_step(self.cfg, self.params(), caches, token, pos)
