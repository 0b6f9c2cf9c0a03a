"""Model building blocks (port of `repro/models/layers.py`): plain
functions on tensors.

Conventions:
  activations (B, S, D); attention heads (B, S, H, dh); KV caches
  (B, Smax, Hkv, dh). Matmuls run in the compute dtype; softmax and
  normalizers accumulate in f32.

Attention is *chunked* (flash-style online softmax over KV chunks, outer
loop over Q chunks) as in the reference, so the same inputs take the same
path and round the same way; the reference's `lax.scan`s become Python
loops over chunks (never over tokens). Decode attends over the whole
cache with a mask, as the reference does.

Hazard a: the reference's einsums with `preferred_element_type=f32` take
bf16 operands and return an f32 sum of exact products. `torch.einsum` on
bf16 returns bf16, so the operands are upcast to f32 first (a bf16 product
is exact in f32) and the result cast back only where the reference casts.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.dist import act

__all__ = [
    "rms_norm", "layer_norm", "rope", "chunked_attention", "decode_attention",
    "mlp_swiglu", "mlp_gelu", "moe_ffn", "mamba1_scan", "mamba1_step",
    "mamba2_ssd", "mamba2_step", "softplus", "gelu",
]

# hazard g: the mask value is -1e30, not -inf, so a fully masked row
# gives a uniform softmax instead of NaN, as in the reference
_NEG_INF = -1e30
f32 = torch.float32


def softplus(x):
    """Hazard d: `jax.nn.softplus` is `logaddexp(x, 0)`; `F.softplus`
    returns x itself above its threshold of 20, which rounds differently."""
    return torch.logaddexp(x, torch.zeros_like(x))


def gelu(x):
    """Hazard e: `jax.nn.gelu(approximate=True)` is the tanh form."""
    return F.gelu(x, approximate="tanh")


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(f32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.to(f32))).to(dt)


def layer_norm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(f32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.to(f32) + b.to(f32)).to(dt)


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding, half-split convention. x: (..., S, H, dh),
    positions: (..., S) integer."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=f32, device=x.device) / half)
    ang = positions.to(f32)[..., None] * freqs        # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                 # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(f32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _f32_einsum(eq: str, a, b):
    """Hazard a: an einsum whose bf16 operands the reference multiplies
    with `preferred_element_type=jnp.float32`."""
    return torch.einsum(eq, a.to(f32), b.to(f32))


# ------------------------------------------------------------------ attention
def chunked_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                      q_chunk: int = 512, kv_chunk: int = 512):
    """Flash-style attention. q (B,S,H,dh); k,v (B,T,Hkv,dh); GQA via
    head-group reshape. Returns (B, S, H, dh) in q's dtype."""
    if isinstance(q, DTensor):
        # batch- and head-parallel: each rank attends over its own block
        fn = functools.partial(chunked_attention, causal=causal,
                               window=window, q_chunk=q_chunk,
                               kv_chunk=kv_chunk)
        return act.blockwise(fn, (q, k, v), ((0, 2),) * 3, (0, 2),
                             heads=(q.shape[2], k.shape[2]))
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    S_real, T_real = S, T
    # pad ragged lengths up to the chunk grid (whisper's 1500 frames):
    # padded KV positions are masked out, padded Q rows sliced off
    if S % q_chunk or T % kv_chunk:
        pS = (-S) % q_chunk
        pT = (-T) % kv_chunk
        q = F.pad(q, (0, 0, 0, 0, 0, pS))
        k = F.pad(k, (0, 0, 0, 0, 0, pT))
        v = F.pad(v, (0, 0, 0, 0, 0, pT))
        S, T = S + pS, T + pT
    nq, nk = S // q_chunk, T // kv_chunk
    scale = dh ** -0.5
    dev = q.device

    qc = q.reshape(B, nq, q_chunk, Hkv, rep, dh)
    blocks = []

    # ---- windowed fast path (local attention, e.g. gemma3 5:1 layers) ----
    # A q-chunk with window w only sees keys in [qpos0 - w + 1, qpos0 + cq):
    # a fixed span of n_blk KV chunks from a clipped start. Hazard g: the
    # same condition `n_blk < nk` and the same clipped start as the
    # reference, so the same inputs take the same path.
    span = q_chunk + (window or 0) - 1
    n_blk = (span + kv_chunk - 1) // kv_chunk + 1
    if window is not None and causal and n_blk < nk:
        kv_span = n_blk * kv_chunk
        for i in range(nq):
            qi = qc[:, i]
            q0 = i * q_chunk
            qpos = torch.arange(q0, q0 + q_chunk, device=dev)
            start = min(max((q0 - window + 1) // kv_chunk, 0),
                        nk - n_blk) * kv_chunk
            kj = k[:, start:start + kv_span]
            vj = v[:, start:start + kv_span]
            kpos = start + torch.arange(kv_span, device=dev)
            logits = _f32_einsum("bqhrd,bkhd->bhrqk", qi, kj) * scale
            allow = ((kpos[None, :] < T_real)
                     & (kpos[None, :] <= qpos[:, None])
                     & ((qpos[:, None] - kpos[None, :]) < window))
            logits = torch.where(allow, logits, _NEG_INF)
            m = logits.amax(-1)
            p = torch.exp(logits - m[..., None])
            l = p.sum(-1).clamp_min(1e-30)
            out = _f32_einsum("bhrqk,bkhd->bhrqd",
                              (p / l[..., None]).to(vj.dtype), vj)
            blocks.append(out.to(qi.dtype).permute(0, 3, 1, 2, 4))
        out = torch.stack(blocks, 1).reshape(B, S, H, dh)
        return out[:, :S_real]

    kc = k.reshape(B, nk, kv_chunk, Hkv, dh)
    vc = v.reshape(B, nk, kv_chunk, Hkv, dh)
    for i in range(nq):
        qi = qc[:, i]                                  # (B, cq, Hkv, rep, dh)
        qpos = torch.arange(i * q_chunk, (i + 1) * q_chunk, device=dev)
        m = torch.full((B, Hkv, rep, q_chunk), _NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((B, Hkv, rep, q_chunk), dtype=f32, device=dev)
        acc = torch.zeros((B, Hkv, rep, q_chunk, dh), dtype=f32, device=dev)
        for j in range(nk):
            kj, vj = kc[:, j], vc[:, j]
            kpos = torch.arange(j * kv_chunk, (j + 1) * kv_chunk, device=dev)
            logits = _f32_einsum("bqhrd,bkhd->bhrqk", qi, kj) * scale
            allow = (kpos[None, :] < T_real).expand(q_chunk, kv_chunk)
            if causal:
                allow = allow & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                allow = allow & ((qpos[:, None] - kpos[None, :]) < window)
            logits = torch.where(allow, logits, _NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = _f32_einsum("bhrqk,bkhd->bhrqd", p.to(vj.dtype), vj)
            acc = acc * corr[..., None] + pv
            m = m_new
        # hazard g: l = max(sum, 1e-30); back to the compute dtype here, as
        # the reference does (`out.astype(qi.dtype)`)
        out = (acc / l[..., None].clamp_min(1e-30)).to(qi.dtype)
        blocks.append(out.permute(0, 3, 1, 2, 4))     # (B,cq,Hkv,rep,dh)
    out = torch.stack(blocks, 1).reshape(B, S, H, dh)
    return out[:, :S_real]


def decode_attention(q, k_cache, v_cache, pos, *, window: int | None = None):
    """Single-token attention over a KV cache.

    q (B, H, dh); caches (B, Smax, Hkv, dh); pos (B,) = index of the
    current token (cache already updated at pos)."""
    B, Smax, Hkv, dh = k_cache.shape
    H = q.shape[1]
    rep = H // Hkv
    scale = dh ** -0.5
    qr = act.tile(q, 1, Hkv).reshape(B, Hkv, rep, dh)
    logits = _f32_einsum("bhrd,bshd->bhrs", qr, k_cache) * scale
    idx = torch.arange(Smax, device=q.device)
    allow = idx[None, :] <= pos[:, None]
    if window is not None:
        allow = allow & ((pos[:, None] - idx[None, :]) < window)
    logits = torch.where(allow[:, None, None, :], logits, _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = _f32_einsum("bhrs,bshd->bhrd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, H, dh).to(q.dtype)


# ------------------------------------------------------------------ MLPs
def mlp_swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def mlp_gelu(x, w_up, b_up, w_down, b_down):
    h = gelu(x @ w_up + b_up)
    return h @ w_down + b_down


# ------------------------------------------------------------------ MoE
def _experts(h, w_gate, w_up, w_down):
    """The experts' SwiGLU FFN over their dispatched slots h (B,E,C,D)."""
    g = F.silu(torch.einsum("becd,edf->becf", h, w_gate))
    u = torch.einsum("becd,edf->becf", h, w_up)
    return torch.einsum("becf,efd->becd", g * u, w_down)


def moe_ffn(x, w_router, w_gate, w_up, w_down, *, topk: int,
            capacity_factor: float = 1.25):
    """Top-k MoE with *per-row* sort-based dispatch (GShard-style capacity).

    x (B,S,D); w_router (D,E); w_gate/w_up (E,D,F); w_down (E,F,D).
    Routing, sorting and capacity assignment happen independently per batch
    row (batched over B here, vmapped in the reference). Per-row capacity
    C = ceil(S*k/E * cf / 8) * 8 clipped to [8, S*k]; overflow tokens are
    dropped (the residual passes them through). For decode, callers pass x
    as (1, B, D) so routing happens across the whole decode batch.

    Hazard c, routing: `lax.top_k` takes the lower index on ties, so the
    top k come from a stable descending sort, never `torch.topk`; the
    expert sort is stable and the group start a left `searchsorted`;
    dropped slots go to the dump row E*C, which is sliced away.
    Hazard c, combine: the reference adds each token's k weighted expert
    outputs into a zero row in the compute dtype, in the order of its
    scatter's updates, which are sorted by expert. The port sums them in
    that order, ascending expert id, as a fixed sequence of adds (no
    atomics), so the card and the CPU round alike from run to run.
    """
    B, S, D = x.shape
    E = w_router.shape[1]
    C = int(np.ceil(S * topk / E * capacity_factor / 8.0) * 8)
    C = min(max(C, 8), S * topk)
    dev = x.device
    n = S * topk

    logits = (x @ w_router.to(x.dtype)).to(f32)                  # (B,S,E)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :topk], idx[..., :topk]      # (B,S,k)
    probs = torch.softmax(gate_vals, dim=-1)
    flat_e = gate_idx.reshape(B, n)
    flat_w = probs.reshape(B, n)
    flat_t = torch.arange(S, device=dev).repeat_interleave(topk)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    st = flat_t[order]                                           # (B,n)
    sw = flat_w.gather(1, order)
    # position within expert group = index - first occurrence of expert
    # DTensor has no sharding rule for searchsorted: on a mesh it runs on
    # the gathered (B, n) expert ids
    first = act.replicated(torch.searchsorted, se, se, side="left")
    pos_in_e = torch.arange(n, device=dev) - first
    keep = pos_in_e < C
    dest = torch.where(keep, se * C + pos_in_e, E * C)
    # out of place, so on a mesh the zero buffer (a plain tensor, taken as
    # replicated) yields a DTensor
    buf = torch.zeros((B, E * C + 1, D), dtype=x.dtype, device=dev).scatter(
        1, dest[..., None].expand(B, n, D),
        x.gather(1, st[..., None].expand(B, n, D)))
    h = buf[:, :-1].reshape(B, E, C, D)

    # on a mesh each rank runs its batch rows through every expert's
    # block of the mlp dim: DTensor's own einsum can leave a permuted
    # local block it cannot view (grad_accum's micro-batches)
    y = act.blockwise(_experts, (h, w_gate.to(x.dtype), w_up.to(x.dtype),
                                 w_down.to(x.dtype)),
                      ((0, None), (None, 2), (None, 2), (None, 1)), (0, None),
                      heads=(w_gate.shape[-1],), sum_heads=True)

    rows = y.reshape(B, E * C, D)
    gathered = torch.where(
        keep[..., None],
        rows.gather(1, dest.clamp_max(E * C - 1)[..., None].expand(B, n, D)),
        0.0)
    contrib = gathered * sw[..., None].to(x.dtype)               # sorted order
    # back to (token, slot) order, then each token's slots by expert id
    inv = torch.argsort(order, dim=-1)
    contrib = contrib.gather(1, inv[..., None].expand(B, n, D))
    by_expert = torch.argsort(gate_idx, dim=-1, stable=True)     # (B,S,k)
    contrib = contrib.reshape(B, S, topk, D).gather(
        2, by_expert[..., None].expand(B, S, topk, D))
    out = torch.zeros((B, S, D), dtype=x.dtype, device=dev)
    for j in range(topk):
        out = out + contrib[:, :, j]
    return out


# ------------------------------------------------------------------ Mamba 1
def _affine_scan(a, b):
    """Inclusive scan over dim 1 of h_t = a_t * h_{t-1} + b_t from h = 0:
    (a1, b1) then (a2, b2) composes to (a2*a1, a2*b1 + b2). Hazard f:
    torch has no associative_scan; this is a log-depth (Hillis-Steele)
    scan in f32, whose rounding differs from JAX's tree, so it is held to
    the reference's own chunked-versus-stepwise tolerance."""
    n = a.shape[1]
    d = 1
    while d < n:
        a_new = a[:, d:] * a[:, :-d]
        b_new = a[:, d:] * b[:, :-d] + b[:, d:]
        a = torch.cat([a[:, :d], a_new], dim=1)
        b = torch.cat([b[:, :d], b_new], dim=1)
        d *= 2
    return a, b


def mamba1_scan(x, dt, A, Bm, Cm, D, *, chunk: int = 256, h0=None):
    """Selective scan (Mamba 1), chunked.

    x (B, S, d_in); dt (B, S, d_in) softplus'd step sizes; A (d_in, N)
    negative; Bm, Cm (B, S, N); D (d_in,); h0 optional (B, d_in, N).
    Returns (y (B, S, d_in), h_last (B, d_in, N))."""
    if isinstance(x, DTensor):
        fn = functools.partial(mamba1_scan, chunk=chunk, h0=h0)
        return act.blockwise(
            fn, (x, dt, A, Bm, Cm, D),
            ((0, 2), (0, 2), (None, 0), (0, None), (0, None), (None, 0)),
            ((0, 2), (0, 1)), heads=(x.shape[2],))
    B, S, d_in = x.shape
    N = A.shape[1]
    chunk = min(chunk, S)
    assert S % chunk == 0
    nc = S // chunk
    h = (torch.zeros((B, d_in, N), dtype=f32, device=x.device)
         if h0 is None else h0)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc, Bc, Cc = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        dA = torch.exp(dtc.to(f32)[..., None] * A)                  # (B,c,d,N)
        dBx = (dtc.to(f32) * xc.to(f32))[..., None] \
            * Bc.to(f32)[:, :, None, :]
        aa, bb = _affine_scan(dA, dBx)
        hs = aa * h[:, None] + bb
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, Cc.to(f32)))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)
    y = y + x.to(f32) * D
    return y.to(x.dtype), h


def mamba1_step(h, x, dt, A, Bm, Cm, D):
    """Single-token recurrence. h (B,d,N); x,dt (B,d); Bm,Cm (B,N)."""
    dA = torch.exp(dt.to(f32)[..., None] * A)
    dBx = (dt * x).to(f32)[..., None] * Bm.to(f32)[:, None, :]
    h = dA * h + dBx
    y = torch.einsum("bdn,bn->bd", h, Cm.to(f32)) + x.to(f32) * D
    return h, y.to(x.dtype)


# ------------------------------------------------------------------ Mamba 2
def _segsum(dA):
    """(..., c) -> (..., c, c) lower-triangular cumulative sums:
    out[i, j] = sum_{j < t <= i} dA[t]; hazard g: -inf above the diagonal
    (its exp is 0)."""
    c = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(c, device=dA.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, -torch.inf)


def mamba2_ssd(x, dt, A, Bm, Cm, D, *, chunk: int = 256, h0=None):
    """Mamba-2 SSD (state-space dual), chunked matmul form.

    x (B, S, H, P); dt (B, S, H) positive; A (H,) negative; Bm, Cm
    (B, S, N) (one group, broadcast over heads); D (H,).
    Returns (y (B, S, H, P), state (B, H, N, P))."""
    if isinstance(x, DTensor):
        fn = functools.partial(mamba2_ssd, chunk=chunk, h0=h0)
        return act.blockwise(
            fn, (x, dt, A, Bm, Cm, D),
            ((0, 2), (0, 2), (None, 0), (0, None), (0, None), (None, 0)),
            ((0, 2), (0, 1)), heads=(x.shape[2],))
    B, S, H, Pd = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    assert S % chunk == 0
    nc = S // chunk
    state = (torch.zeros((B, H, N, Pd), dtype=f32, device=x.device)
             if h0 is None else h0)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc = x[:, sl].to(f32), dt[:, sl].to(f32)
        Bc, Cc = Bm[:, sl].to(f32), Cm[:, sl].to(f32)
        dA = dtc * A                                         # (B,c,H)
        L = torch.exp(_segsum(dA.transpose(1, 2)))           # (B,H,c,c)
        G = torch.einsum("bin,bjn->bij", Cc, Bc)             # (B,c,c)
        M = G[:, None] * L
        y_diag = torch.einsum("bhij,bjh,bjhp->bihp", M, dtc, xc)
        cs = torch.cumsum(dA, dim=1)                         # (B,c,H)
        y_off = torch.einsum("bin,bih,bhnp->bihp", Cc, torch.exp(cs), state)
        total = cs[:, -1, :]                                 # (B,H)
        decay_out = torch.exp(total[:, None, :] - cs)
        s_new = torch.einsum("bjn,bjh,bjhp->bhnp", Bc, decay_out * dtc, xc)
        state = torch.exp(total)[..., None, None] * state + s_new
        ys.append(y_diag + y_off)
    y = torch.cat(ys, dim=1)
    y = y + x.to(f32) * D[:, None]
    return y.to(x.dtype), state


def mamba2_step(state, x, dt, A, Bm, Cm, D):
    """Single-token SSD recurrence. state (B,H,N,P); x (B,H,P); dt (B,H);
    Bm, Cm (B,N)."""
    dA = torch.exp(dt.to(f32) * A)                            # (B,H)
    dBx = torch.einsum("bn,bh,bhp->bhnp", Bm.to(f32), dt.to(f32), x.to(f32))
    state = dA[..., None, None] * state + dBx
    y = torch.einsum("bn,bhnp->bhp", Cm.to(f32), state)
    y = y + x.to(f32) * D[:, None]
    return state, y.to(x.dtype)
