"""Decoder-LM forward/decode for all non-encdec families (port of
`repro/models/transformer.py`).

Params are a nested dict of tensors in the reference's layout: per group
position `groups/p{i}` leaves stacked along a leading "layers" axis,
remainder layers under `rem/p{i}` with a unit leading axis (hazard h), and
the hybrid's single `shared_attn` set applied after every group. The
reference's `lax.scan` over groups becomes a Python loop over that stacked
axis: a loop over layers, never over tokens.

Activations are anchored with `act.btd`, `act.bd` and `act.logits_spec`
(`repro_torch/dist/act.py`) where the reference anchors them. With no
mesh, or a one-rank mesh, each returns the tensor it was given.

Decode updates the caches in place and returns the same tree (what the
reference gets from buffer donation): a full-width cache is tens of GB,
and a copy per step would double it.

Public API:
  param_specs(cfg)                          -> ParamSpec tree
  lm_forward(cfg, params, tokens, ...)      -> logits (B, S, vocab) f32
  init_caches(cfg, batch, smax, device)     -> cache tree
  lm_decode_step(cfg, params, caches, token, pos) -> (logits, caches)
  DecoderLM(cfg, device, generator)         -> nn.Module over that tree
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.dist import act
from repro_torch.models.common import (ParamSpec, init_params, param_tree,
                                       register_params, remat_call,
                                       tree_index, tree_unstack)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (chunked_attention, decode_attention,
                                       layer_norm, mamba1_scan, mamba1_step,
                                       mamba2_ssd, mamba2_step, mlp_gelu,
                                       mlp_swiglu, moe_ffn, rms_norm, rope,
                                       softplus)

__all__ = ["param_specs", "lm_forward", "lm_decode_step", "init_caches",
           "DecoderLM"]

f32 = torch.float32


# ===================================================================== specs
def _attn_specs(cfg: ModelConfig, stack: tuple[int, ...], moe: bool) -> dict:
    d, hd = cfg.d_model, cfg.hd
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    L = ("layers",) * len(stack)
    pdt = cfg.pdt
    s: dict[str, ParamSpec] = {
        "ln1": ParamSpec(stack + (d,), L + ("embed",), init="zeros", dtype=pdt),
        "wq": ParamSpec(stack + (d, H * hd), L + ("embed", "heads"),
                        fan_in_axes=(len(stack),), dtype=pdt),
        "wk": ParamSpec(stack + (d, Hkv * hd), L + ("embed", "kv_heads"),
                        fan_in_axes=(len(stack),), dtype=pdt),
        "wv": ParamSpec(stack + (d, Hkv * hd), L + ("embed", "kv_heads"),
                        fan_in_axes=(len(stack),), dtype=pdt),
        "wo": ParamSpec(stack + (H * hd, d), L + ("heads", "embed"),
                        fan_in_axes=(len(stack),), dtype=pdt),
        "ln2": ParamSpec(stack + (d,), L + ("embed",), init="zeros", dtype=pdt),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec(stack + (H * hd,), L + ("heads",), init="zeros", dtype=pdt)
        s["bk"] = ParamSpec(stack + (Hkv * hd,), L + ("kv_heads",), init="zeros", dtype=pdt)
        s["bv"] = ParamSpec(stack + (Hkv * hd,), L + ("kv_heads",), init="zeros", dtype=pdt)
    if moe:
        E, f = cfg.n_experts, (cfg.moe_d_ff or cfg.d_ff)
        s["router"] = ParamSpec(stack + (d, E), L + ("embed", None),
                                fan_in_axes=(len(stack),), dtype=f32)
        s["we_gate"] = ParamSpec(stack + (E, d, f), L + ("expert", "embed", "mlp"),
                                 fan_in_axes=(len(stack) + 1,), dtype=pdt)
        s["we_up"] = ParamSpec(stack + (E, d, f), L + ("expert", "embed", "mlp"),
                               fan_in_axes=(len(stack) + 1,), dtype=pdt)
        s["we_down"] = ParamSpec(stack + (E, f, d), L + ("expert", "mlp", "embed"),
                                 fan_in_axes=(len(stack) + 1,), dtype=pdt)
    elif cfg.act == "swiglu":
        ff = cfg.d_ff
        s["w_gate"] = ParamSpec(stack + (d, ff), L + ("embed", "mlp"),
                                fan_in_axes=(len(stack),), dtype=pdt)
        s["w_up"] = ParamSpec(stack + (d, ff), L + ("embed", "mlp"),
                              fan_in_axes=(len(stack),), dtype=pdt)
        s["w_down"] = ParamSpec(stack + (ff, d), L + ("mlp", "embed"),
                                fan_in_axes=(len(stack),), dtype=pdt)
    else:
        ff = cfg.d_ff
        s["w_up"] = ParamSpec(stack + (d, ff), L + ("embed", "mlp"),
                              fan_in_axes=(len(stack),), dtype=pdt)
        s["b_up"] = ParamSpec(stack + (ff,), L + ("mlp",), init="zeros", dtype=pdt)
        s["w_down"] = ParamSpec(stack + (ff, d), L + ("mlp", "embed"),
                                fan_in_axes=(len(stack),), dtype=pdt)
        s["b_down"] = ParamSpec(stack + (d,), L + ("embed",), init="zeros", dtype=pdt)
    return s


def _mamba1_specs(cfg: ModelConfig, stack: tuple[int, ...]) -> dict:
    d, di, N, R = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    L = ("layers",) * len(stack)
    pdt = cfg.pdt
    return {
        "ln": ParamSpec(stack + (d,), L + ("embed",), init="zeros", dtype=pdt),
        "in_proj": ParamSpec(stack + (d, 2 * di), L + ("embed", "ssm_inner"),
                             fan_in_axes=(len(stack),), dtype=pdt),
        "conv_w": ParamSpec(stack + (cfg.ssm_conv, di), L + (None, "ssm_inner"),
                            scale=0.3, dtype=pdt),
        "conv_b": ParamSpec(stack + (di,), L + ("ssm_inner",), init="zeros", dtype=pdt),
        "x_proj": ParamSpec(stack + (di, R + 2 * N), L + ("ssm_inner", None),
                            fan_in_axes=(len(stack),), dtype=pdt),
        "dt_proj": ParamSpec(stack + (R, di), L + (None, "ssm_inner"),
                             fan_in_axes=(len(stack),), dtype=pdt),
        "dt_bias": ParamSpec(stack + (di,), L + ("ssm_inner",), init="zeros", dtype=pdt),
        "A_log": ParamSpec(stack + (di, N), L + ("ssm_inner", None),
                           init="zeros", dtype=f32),
        "Dp": ParamSpec(stack + (di,), L + ("ssm_inner",), init="ones", dtype=f32),
        "out_proj": ParamSpec(stack + (di, d), L + ("ssm_inner", "embed"),
                              fan_in_axes=(len(stack),), dtype=pdt),
    }


def _mamba2_specs(cfg: ModelConfig, stack: tuple[int, ...]) -> dict:
    d, di, N, Hm = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.mamba_heads
    L = ("layers",) * len(stack)
    pdt = cfg.pdt
    return {
        "ln": ParamSpec(stack + (d,), L + ("embed",), init="zeros", dtype=pdt),
        "wz": ParamSpec(stack + (d, di), L + ("embed", "ssm_inner"),
                        fan_in_axes=(len(stack),), dtype=pdt),
        "wx": ParamSpec(stack + (d, di), L + ("embed", "ssm_inner"),
                        fan_in_axes=(len(stack),), dtype=pdt),
        "wB": ParamSpec(stack + (d, N), L + ("embed", None),
                        fan_in_axes=(len(stack),), dtype=pdt),
        "wC": ParamSpec(stack + (d, N), L + ("embed", None),
                        fan_in_axes=(len(stack),), dtype=pdt),
        "wdt": ParamSpec(stack + (d, Hm), L + ("embed", None),
                         fan_in_axes=(len(stack),), dtype=pdt),
        "dt_bias": ParamSpec(stack + (Hm,), L + (None,), init="zeros", dtype=f32),
        "conv_w": ParamSpec(stack + (cfg.ssm_conv, di), L + (None, "ssm_inner"),
                            scale=0.3, dtype=pdt),
        "conv_b": ParamSpec(stack + (di,), L + ("ssm_inner",), init="zeros", dtype=pdt),
        "A_log": ParamSpec(stack + (Hm,), L + (None,), init="zeros", dtype=f32),
        "Dp": ParamSpec(stack + (Hm,), L + (None,), init="ones", dtype=f32),
        "gn": ParamSpec(stack + (di,), L + ("ssm_inner",), init="zeros", dtype=pdt),
        "out_proj": ParamSpec(stack + (di, d), L + ("ssm_inner", "embed"),
                              fan_in_axes=(len(stack),), dtype=pdt),
    }


def _block_specs(cfg: ModelConfig, kind: str, stack: tuple[int, ...]) -> dict:
    if kind in ("global", "local"):
        return _attn_specs(cfg, stack, moe=False)
    if kind == "moe":
        return _attn_specs(cfg, stack, moe=True)
    if kind == "mamba1":
        return _mamba1_specs(cfg, stack)
    if kind == "mamba2":
        return _mamba2_specs(cfg, stack)
    raise ValueError(kind)


def param_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    pattern, n_groups, rem = cfg.layer_plan()
    specs: dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), dtype=cfg.pdt),
        "final_norm": ParamSpec((d,), ("embed",), init="zeros", dtype=cfg.pdt),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"),
                                     fan_in_axes=(0,), dtype=cfg.pdt)
    body_pattern = [k for k in pattern if k != "shared_attn"]
    if n_groups:
        specs["groups"] = {f"p{i}": _block_specs(cfg, k, (n_groups,))
                           for i, k in enumerate(body_pattern)}
    if rem:
        # hazard h: remainder layers keep a unit leading axis
        specs["rem"] = {f"p{i}": _block_specs(cfg, k, (1,))
                        for i, k in enumerate(rem)}
    if cfg.family == "hybrid":
        specs["shared_attn"] = _attn_specs(cfg, (), moe=False)
    return specs


# ===================================================================== blocks
def _norm(cfg, x, w, b=None):
    # hazard h: the layernorm family stores its scale as an offset from 1
    if cfg.norm == "layernorm":
        return layer_norm(x, w + 1.0, b if b is not None else torch.zeros_like(w))
    return rms_norm(x, w)


def _causal_conv(x, conv_w, conv_b):
    """Depthwise causal conv over sequence. x (B,S,di); conv_w (K, di)."""
    K = conv_w.shape[0]
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=f32, device=x.device)
    for k in range(K):
        shift = K - 1 - k
        xs = torch.nn.functional.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xs.to(f32) * conv_w[k].to(f32)
    return (out + conv_b.to(f32)).to(x.dtype)


def _embed(cfg: ModelConfig, params, tokens):
    """Hazard b: the reference casts the whole table and then gathers
    (`embed.astype(cdt)[tokens]`); gathering first gives the same bits
    without casting a 1.56 GB table on every decode step."""
    return act.embed(params["embed"], tokens).to(cfg.cdt)


def _logits(cfg: ModelConfig, params, x):
    """Logits in f32. The tied head needs the whole matrix cast, as in the
    reference (`embed.T.astype(x.dtype)`)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head.to(x.dtype)).to(f32)


def _attn_block(cfg: ModelConfig, p, x, positions, *, window, moe: bool):
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = _norm(cfg, x, p["ln1"])
    q = h @ p["wq"].to(h.dtype)
    k = h @ p["wk"].to(h.dtype)
    v = h @ p["wv"].to(h.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(h.dtype)
        k = k + p["bk"].to(h.dtype)
        v = v + p["bv"].to(h.dtype)
    q = rope(act.tile(q, -1, H).reshape(B, S, H, hd), positions,
             cfg.rope_theta)
    k = rope(act.tile(k, -1, Hkv).reshape(B, S, Hkv, hd), positions,
             cfg.rope_theta)
    v = act.tile(v, -1, Hkv).reshape(B, S, Hkv, hd)
    o = chunked_attention(q, k, v, causal=True, window=window,
                          q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    # mid-block anchor (no counterpart in the reference, where GSPMD
    # propagates the block-boundary ones): without it DTensor's op-by-op
    # choice can leave the residual sharded over "model" and the MLP
    # gathers its weights
    o = act.shard_model(o.reshape(B, S, H * hd), -1)
    x = act.btd(x + (o @ p["wo"].to(h.dtype)).to(x.dtype))

    h2 = _norm(cfg, x, p["ln2"])
    if moe:
        f = moe_ffn(h2, p["router"], p["we_gate"], p["we_up"], p["we_down"],
                    topk=cfg.topk, capacity_factor=cfg.capacity_factor)
    elif cfg.act == "swiglu":
        f = mlp_swiglu(h2, p["w_gate"].to(h2.dtype),
                       p["w_up"].to(h2.dtype), p["w_down"].to(h2.dtype))
    else:
        f = mlp_gelu(h2, p["w_up"].to(h2.dtype), p["b_up"].to(h2.dtype),
                     p["w_down"].to(h2.dtype), p["b_down"].to(h2.dtype))
    return x + f.to(x.dtype)


def _mamba1_block(cfg: ModelConfig, p, x):
    R, N = cfg.dt_rank, cfg.ssm_state
    h = _norm(cfg, x, p["ln"])
    xz = h @ p["in_proj"].to(h.dtype)
    xp, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(_causal_conv(xp, p["conv_w"], p["conv_b"]))
    proj = xc @ p["x_proj"].to(h.dtype)
    dt_raw, Bm, Cm = torch.split(proj, [R, N, N], dim=-1)
    dt = softplus(dt_raw @ p["dt_proj"].to(h.dtype) + p["dt_bias"].to(h.dtype))
    A = -torch.exp(p["A_log"])
    y, _ = mamba1_scan(xc, dt, A, Bm, Cm, p["Dp"], chunk=cfg.q_chunk)
    y = y * F.silu(z)
    return x + y @ p["out_proj"].to(h.dtype)


def _mamba2_block(cfg: ModelConfig, p, x):
    B, S, d = x.shape
    di, Hm, Pd = cfg.d_inner, cfg.mamba_heads, cfg.mamba_headdim
    h = _norm(cfg, x, p["ln"])
    z = h @ p["wz"].to(h.dtype)
    xp = F.silu(_causal_conv(h @ p["wx"].to(h.dtype), p["conv_w"], p["conv_b"]))
    Bm = h @ p["wB"].to(h.dtype)
    Cm = h @ p["wC"].to(h.dtype)
    dt = softplus((h @ p["wdt"].to(h.dtype)).to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, _ = mamba2_ssd(act.tile(xp, -1, Hm).reshape(B, S, Hm, Pd), dt, A, Bm,
                      Cm, p["Dp"], chunk=cfg.q_chunk)
    y = act.shard_model(y.reshape(B, S, di), -1)
    y = rms_norm(y * F.silu(z), p["gn"])
    return x + y @ p["out_proj"].to(h.dtype)


def _apply_block(cfg, kind, p, x, positions):
    if kind == "global":
        return _attn_block(cfg, p, x, positions, window=None, moe=False)
    if kind == "local":
        return _attn_block(cfg, p, x, positions, window=cfg.window_size, moe=False)
    if kind == "moe":
        return _attn_block(cfg, p, x, positions, window=None, moe=True)
    if kind == "mamba1":
        return _mamba1_block(cfg, p, x)
    if kind == "mamba2":
        return _mamba2_block(cfg, p, x)
    raise ValueError(kind)


# ===================================================================== forward
def lm_forward(cfg: ModelConfig, params, tokens, *, prefix_embeds=None,
               remat: bool = True):
    """tokens (B, S_text) integer; prefix_embeds optional (B, P, d) for VLM.
    Returns logits (B, S, vocab) in f32. With `remat` (the reference's
    activation checkpointing) each group body and each remainder block
    runs under `remat_call`, so a backward recomputes its activations."""
    x = act.btd(_embed(cfg, params, tokens))
    if prefix_embeds is not None:
        x = act.btd(torch.cat([prefix_embeds.to(cfg.cdt), x], dim=1))
    B, S, d = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)

    pattern, n_groups, rem = cfg.layer_plan()
    body_pattern = [k for k in pattern if k != "shared_attn"]

    def group_body(x, gp):
        for i, kind in enumerate(body_pattern):
            x = act.btd(_apply_block(cfg, kind, gp[f"p{i}"], x, positions))
        if cfg.family == "hybrid":
            # hazard h: the one shared attention set, after every group
            x = act.btd(_attn_block(cfg, params["shared_attn"], x, positions,
                                    window=None, moe=False))
        return x

    groups = tree_unstack(params["groups"])
    for g in range(n_groups):
        x = remat_call(group_body, remat, x, tree_index(groups, g))
    for i, kind in enumerate(rem):
        x = remat_call(lambda x, p, kind=kind: _apply_block(cfg, kind, p, x,
                                                            positions),
                       remat, x, tree_index(params["rem"][f"p{i}"], 0))

    x = _norm(cfg, x, params["final_norm"])
    return act.logits_spec(_logits(cfg, params, x))


# ===================================================================== decode
def _cache_spec(cfg: ModelConfig, kind: str, stack, batch: int, smax: int,
                device) -> dict:
    hd, Hkv = cfg.hd, cfg.n_kv_heads

    def zeros(shape, dtype):
        return torch.zeros(stack + shape, dtype=dtype, device=device)

    if kind in ("global", "local", "moe", "shared_attn"):
        return {"k": zeros((batch, smax, Hkv, hd), cfg.cdt),
                "v": zeros((batch, smax, Hkv, hd), cfg.cdt)}
    if kind == "mamba1":
        return {"ssm": zeros((batch, cfg.d_inner, cfg.ssm_state), f32),
                "conv": zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), cfg.cdt)}
    if kind == "mamba2":
        return {"ssm": zeros((batch, cfg.mamba_heads, cfg.ssm_state,
                              cfg.mamba_headdim), f32),
                "conv": zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), cfg.cdt)}
    raise ValueError(kind)


def init_caches(cfg: ModelConfig, batch: int, smax: int,
                device: str | torch.device | None = None) -> dict:
    """Zero caches in the reference's layout; hazard h: every group of the
    hybrid has its own `shared` attention cache."""
    device = resolve_device(device)
    pattern, n_groups, rem = cfg.layer_plan()
    body_pattern = [k for k in pattern if k != "shared_attn"]
    caches: dict[str, Any] = {}
    if n_groups:
        caches["groups"] = {
            f"p{i}": _cache_spec(cfg, k, (n_groups,), batch, smax, device)
            for i, k in enumerate(body_pattern)}
        if cfg.family == "hybrid":
            caches["groups"]["shared"] = _cache_spec(
                cfg, "shared_attn", (n_groups,), batch, smax, device)
    if rem:
        caches["rem"] = {f"p{i}": _cache_spec(cfg, k, (1,), batch, smax, device)
                         for i, k in enumerate(rem)}
    return caches


def _attn_decode(cfg, p, x, cache, pos, *, window, moe: bool):
    """x (B, d) single token; cache {k,v} (B, smax, Hkv, hd), written in
    place at pos; pos (B,)."""
    B, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = _norm(cfg, x[:, None, :], p["ln1"])[:, 0]
    q = h @ p["wq"].to(h.dtype)
    k = h @ p["wk"].to(h.dtype)
    v = h @ p["wv"].to(h.dtype)
    if cfg.qkv_bias:
        q, k, v = (q + p["bq"].to(h.dtype), k + p["bk"].to(h.dtype),
                   v + p["bv"].to(h.dtype))
    pos1 = pos[:, None]
    q = rope(act.tile(q, -1, H).reshape(B, 1, H, hd), pos1,
             cfg.rope_theta)[:, 0]
    k = rope(act.tile(k, -1, Hkv).reshape(B, 1, Hkv, hd), pos1,
             cfg.rope_theta)[:, 0]
    v = act.tile(v, -1, Hkv).reshape(B, Hkv, hd)
    kc, vc = cache["k"], cache["v"]
    act.put_rows_(kc, pos, k.to(kc.dtype))
    act.put_rows_(vc, pos, v.to(vc.dtype))
    o = decode_attention(q, kc, vc, pos, window=window)
    x = x + o.reshape(B, H * hd) @ p["wo"].to(h.dtype)

    h2 = _norm(cfg, x[:, None, :], p["ln2"])[:, 0]
    if moe:
        # decode: route across the whole batch as one row (see moe_ffn)
        f = moe_ffn(h2[None, :, :], p["router"], p["we_gate"], p["we_up"],
                    p["we_down"], topk=cfg.topk,
                    capacity_factor=cfg.capacity_factor)[0]
    elif cfg.act == "swiglu":
        f = mlp_swiglu(h2, p["w_gate"].to(h2.dtype),
                       p["w_up"].to(h2.dtype), p["w_down"].to(h2.dtype))
    else:
        f = mlp_gelu(h2, p["w_up"].to(h2.dtype), p["b_up"].to(h2.dtype),
                     p["w_down"].to(h2.dtype), p["b_down"].to(h2.dtype))
    return x + f


def _conv_step(cache, xp_raw, conv_w, conv_b):
    """One step of the depthwise causal conv from its (B, K-1, di) cache of
    previous inputs; the cache moves on by one, in place."""
    full = torch.cat([cache["conv"], xp_raw[:, None, :]], dim=1)   # (B,K,di)
    xc = torch.einsum("bkd,kd->bd", full.to(f32), conv_w.to(f32)) \
        + conv_b.to(f32)
    cache["conv"].copy_(full[:, 1:])
    return xc


def _mamba1_decode(cfg, p, x, cache):
    R, N = cfg.dt_rank, cfg.ssm_state
    h = _norm(cfg, x[:, None, :], p["ln"])[:, 0]
    xz = h @ p["in_proj"].to(h.dtype)
    xp, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(_conv_step(cache, xp, p["conv_w"], p["conv_b"])).to(h.dtype)
    proj = xc @ p["x_proj"].to(h.dtype)
    dt_raw, Bm, Cm = torch.split(proj, [R, N, N], dim=-1)
    dt = softplus(dt_raw @ p["dt_proj"].to(h.dtype) + p["dt_bias"].to(h.dtype))
    A = -torch.exp(p["A_log"])
    ssm, y = mamba1_step(cache["ssm"], xc, dt, A, Bm, Cm, p["Dp"])
    cache["ssm"].copy_(ssm)
    y = y * F.silu(z)
    return x + y @ p["out_proj"].to(h.dtype)


def _mamba2_decode(cfg, p, x, cache):
    B, d = x.shape
    Hm, Pd = cfg.mamba_heads, cfg.mamba_headdim
    h = _norm(cfg, x[:, None, :], p["ln"])[:, 0]
    z = h @ p["wz"].to(h.dtype)
    xc = _conv_step(cache, h @ p["wx"].to(h.dtype), p["conv_w"], p["conv_b"])
    xp = F.silu(xc).to(h.dtype)
    Bm = h @ p["wB"].to(h.dtype)
    Cm = h @ p["wC"].to(h.dtype)
    dt = softplus((h @ p["wdt"].to(h.dtype)).to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    ssm, y = mamba2_step(cache["ssm"], act.tile(xp, -1, Hm).reshape(B, Hm, Pd),
                         dt, A, Bm, Cm, p["Dp"])
    cache["ssm"].copy_(ssm)
    y = y.reshape(B, cfg.d_inner)
    y = rms_norm((y * F.silu(z))[:, None, :], p["gn"])[:, 0]
    return x + y @ p["out_proj"].to(h.dtype)


def _decode_block(cfg, kind, p, x, cache, pos):
    if kind == "global":
        return _attn_decode(cfg, p, x, cache, pos, window=None, moe=False)
    if kind == "local":
        return _attn_decode(cfg, p, x, cache, pos, window=cfg.window_size, moe=False)
    if kind == "moe":
        return _attn_decode(cfg, p, x, cache, pos, window=None, moe=True)
    if kind == "mamba1":
        return _mamba1_decode(cfg, p, x, cache)
    if kind == "mamba2":
        return _mamba2_decode(cfg, p, x, cache)
    raise ValueError(kind)


def lm_decode_step(cfg: ModelConfig, params, caches, token, pos):
    """One decode step. token (B,) integer; pos (B,) integer (current
    index). Returns (logits (B, vocab) f32, caches), the caches updated in
    place."""
    x = act.bd(_embed(cfg, params, token))
    pattern, n_groups, rem = cfg.layer_plan()
    body_pattern = [k for k in pattern if k != "shared_attn"]
    for g in range(n_groups):
        gp, gc = tree_index(params["groups"], g), tree_index(caches["groups"], g)
        for i, kind in enumerate(body_pattern):
            x = act.bd(_decode_block(cfg, kind, gp[f"p{i}"], x, gc[f"p{i}"],
                                     pos))
        if cfg.family == "hybrid":
            x = _attn_decode(cfg, params["shared_attn"], x, gc["shared"], pos,
                             window=None, moe=False)
    for i, kind in enumerate(rem):
        x = _decode_block(cfg, kind, tree_index(params["rem"][f"p{i}"], 0), x,
                          tree_index(caches["rem"][f"p{i}"], 0), pos)

    x = _norm(cfg, x[:, None, :], params["final_norm"])[:, 0]
    return _logits(cfg, params, x), caches


# ===================================================================== module
class DecoderLM(nn.Module):
    """The decoder LM as an `nn.Module`: its parameters are the tree of
    `param_specs(cfg)` under the reference's names (`groups.p0.wq`, ...),
    drawn by `init_params` from `generator` (seeded 0 on `device` by
    default). `device=None` means the card and raises without one."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        self.cfg = cfg
        register_params(self, init_params(param_specs(cfg), generator, device))

    def params(self) -> dict:
        """The parameter tree the module functions take."""
        return param_tree(self)

    def forward(self, tokens, prefix_embeds=None):
        return lm_forward(self.cfg, self.params(), tokens,
                          prefix_embeds=prefix_embeds)

    def init_caches(self, batch: int, smax: int) -> dict:
        return init_caches(self.cfg, batch, smax, self.embed.device)

    def decode_step(self, caches, token, pos):
        return lm_decode_step(self.cfg, self.params(), caches, token, pos)
