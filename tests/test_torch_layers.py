"""The port's model layers (`repro_torch.models.layers`) held against the
JAX package's (`repro/models/layers.py`) on the CPU, on inputs from
`np.random.default_rng(seed)`.

Tolerances, set from the dtypes: at f32 2e-5 (a few ulps of an f32 sum;
attention, MoE, norms, rope), the SSM scans at the reference's own
chunked-against-stepwise 2e-3 (hazard f: the port's log-depth scan rounds
in another order); at bf16 1.6e-2, one bf16 ulp of values below 4.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

SSM_TOL = 2e-3


def _close(port, ref, tol_a, tol_r, what):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32),
                               atol=tol_a, rtol=tol_r, err_msg=what)


def _np(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    j = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    t = torch.from_numpy(a).to(torch.bfloat16 if dtype == "bfloat16"
                               else torch.float32)
    return j, t


# (S, T, q_chunk, kv_chunk, window, causal): ragged S and T off the chunk
# grid; the windowed fast path engages where n_blk < nk
ATTN_CASES = [
    (64, 64, 16, 16, None, True), (50, 50, 16, 16, None, True),
    (30, 45, 16, 16, None, False), (37, 37, 8, 8, 9, True),
    (128, 128, 16, 16, 20, True), (100, 100, 16, 16, 20, True),
    (48, 48, 16, 16, 64, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_chunked_attention_matches_jax(case, dtype):
    S_, T_, cq, ck, window, causal = case
    rng = np.random.default_rng(S_ * 7 + T_)
    Bq, H, Hkv, dh = 2, 4, 2, 8
    q, k, v = (_pair(_np(rng, (Bq, n, h, dh)), dtype)
               for n, h in ((S_, H), (T_, Hkv), (T_, Hkv)))
    span = cq + (window or 0) - 1
    fast = (window is not None and causal
            and (span + ck - 1) // ck + 1 < -(-T_ // ck))
    assert fast == (case in ATTN_CASES[3:6])
    jo = JL.chunked_attention(q[0], k[0], v[0], causal=causal, window=window,
                              q_chunk=cq, kv_chunk=ck)
    to = TL.chunked_attention(q[1], k[1], v[1], causal=causal, window=window,
                              q_chunk=cq, kv_chunk=ck)
    assert to.dtype == q[1].dtype and to.shape == (Bq, S_, H, dh)
    # f32: a few ulps of an f32 sum; bf16: one bf16 ulp of values below 4
    tol = 2e-5 if dtype == "float32" else 1.6e-2
    _close(to.float().numpy(), np.asarray(jo.astype(jnp.float32)), tol, tol,
           "attention")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_jax(window, dtype):
    rng = np.random.default_rng(11)
    Bq, Smax, H, Hkv, dh = 3, 24, 4, 2, 8
    q = _pair(_np(rng, (Bq, H, dh)), dtype)
    kc = _pair(_np(rng, (Bq, Smax, Hkv, dh)), dtype)
    vc = _pair(_np(rng, (Bq, Smax, Hkv, dh)), dtype)
    pos = np.array([0, 7, 23], np.int32)
    jo = JL.decode_attention(q[0], kc[0], vc[0], jnp.asarray(pos), window=window)
    to = TL.decode_attention(q[1], kc[1], vc[1], torch.from_numpy(pos).long(),
                             window=window)
    tol = 2e-5 if dtype == "float32" else 1.6e-2
    _close(to.float().numpy(), np.asarray(jo.astype(jnp.float32)), tol, tol,
           "decode attention")


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_moe_ffn_ties_and_overflow_match_jax(cf):
    """Experts 1 and 3 have the same router column, so every token's
    logits tie between them (lax.top_k takes the lower index); at
    capacity_factor 0.5 experts overflow and tokens are dropped."""
    rng = np.random.default_rng(21)
    Bq, S_, D, E, F, k = 2, 24, 8, 4, 12, 2
    x = _np(rng, (Bq, S_, D))
    wr = _np(rng, (D, E))
    wr[:, 3] = wr[:, 1]
    wr[:, 2] = wr[:, 1] * 0.25
    wg, wu = _np(rng, (E, D, F), 0.1), _np(rng, (E, D, F), 0.1)
    wd = _np(rng, (E, F, D), 0.1)
    jo = JL.moe_ffn(*map(jnp.asarray, (x, wr, wg, wu, wd)), topk=k,
                    capacity_factor=cf)
    to = TL.moe_ffn(*map(torch.from_numpy, (x, wr, wg, wu, wd)), topk=k,
                    capacity_factor=cf)
    _close(to.numpy(), jo, 2e-5, 2e-5, "moe")
    dropped = (np.abs(np.asarray(jo)).sum(-1) == 0).sum()
    assert (dropped > 0) == (cf == 0.5)


def test_moe_ffn_bf16_combine_matches_jax():
    """bf16 compute: each token's k slots are added in ascending expert id,
    the order of the reference's scatter; the port's sum equals JAX's
    run op by op."""
    rng = np.random.default_rng(22)
    Bq, S_, D, E, F, k = 1, 32, 16, 8, 24, 4
    x = _pair(_np(rng, (Bq, S_, D)), "bfloat16")
    wr = _np(rng, (D, E))
    ws = [_np(rng, s, 0.1) for s in ((E, D, F), (E, D, F), (E, F, D))]
    with jax.disable_jit():
        jo = JL.moe_ffn(x[0], jnp.asarray(wr), *map(jnp.asarray, ws), topk=k)
    to = TL.moe_ffn(x[1], torch.from_numpy(wr), *map(torch.from_numpy, ws),
                    topk=k)
    _close(to.float().numpy(), np.asarray(jo.astype(jnp.float32)), 1.6e-2,
           1.6e-2, "moe bf16")


def test_mamba1_scan_and_step_match_jax():
    rng = np.random.default_rng(31)
    Bq, S_, d, N = 2, 64, 16, 4
    x, Bm, Cm = _np(rng, (Bq, S_, d)), _np(rng, (Bq, S_, N)), _np(rng, (Bq, S_, N))
    dt = rng.uniform(0.01, 0.3, (Bq, S_, d)).astype(np.float32)
    A = -rng.uniform(0.2, 2.0, (d, N)).astype(np.float32)
    D = _np(rng, (d,))
    h0 = _np(rng, (Bq, d, N))
    args = (x, dt, A, Bm, Cm, D)
    jy, jh = JL.mamba1_scan(*map(jnp.asarray, args), chunk=16,
                            h0=jnp.asarray(h0))
    ty, th = TL.mamba1_scan(*map(torch.from_numpy, args), chunk=16,
                            h0=torch.from_numpy(h0))
    _close(ty.numpy(), jy, SSM_TOL, SSM_TOL, "mamba1 y")
    _close(th.numpy(), jh, SSM_TOL, SSM_TOL, "mamba1 h")
    jh, jy = JL.mamba1_step(jnp.asarray(h0), *map(jnp.asarray, (
        x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D)))
    th, ty = TL.mamba1_step(torch.from_numpy(h0), *map(torch.from_numpy, (
        x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D)))
    _close(ty.numpy(), jy, 2e-5, 2e-5, "mamba1 step y")
    _close(th.numpy(), jh, 2e-5, 2e-5, "mamba1 step h")


def test_mamba2_ssd_and_step_match_jax():
    rng = np.random.default_rng(41)
    Bq, S_, H, P, N = 2, 64, 4, 8, 4
    x = _np(rng, (Bq, S_, H, P))
    dt = rng.uniform(0.01, 0.3, (Bq, S_, H)).astype(np.float32)
    A = -rng.uniform(0.2, 2.0, (H,)).astype(np.float32)
    Bm, Cm, D = _np(rng, (Bq, S_, N)), _np(rng, (Bq, S_, N)), _np(rng, (H,))
    h0 = _np(rng, (Bq, H, N, P))
    args = (x, dt, A, Bm, Cm, D)
    jy, js = JL.mamba2_ssd(*map(jnp.asarray, args), chunk=16, h0=jnp.asarray(h0))
    ty, ts = TL.mamba2_ssd(*map(torch.from_numpy, args), chunk=16,
                           h0=torch.from_numpy(h0))
    _close(ty.numpy(), jy, SSM_TOL, SSM_TOL, "ssd y")
    _close(ts.numpy(), js, SSM_TOL, SSM_TOL, "ssd state")
    js, jy = JL.mamba2_step(jnp.asarray(h0), *map(jnp.asarray, (
        x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D)))
    ts, ty = TL.mamba2_step(torch.from_numpy(h0), *map(torch.from_numpy, (
        x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D)))
    _close(ty.numpy(), jy, 2e-5, 2e-5, "ssd step y")
    _close(ts.numpy(), js, 2e-5, 2e-5, "ssd step state")
    seg = TL._segsum(torch.from_numpy(dt[0, :5, 0]))
    assert torch.isinf(seg[0, 1]) and seg[0, 1] < 0
    _close(seg.numpy(), JL._segsum(jnp.asarray(dt[0, :5, 0])), 1e-6, 1e-6, "segsum")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_norms_and_activations_match_jax(dtype):
    rng = np.random.default_rng(51)
    x = _pair(_np(rng, (2, 9, 3, 16), 3.0), dtype)
    w = _pair(_np(rng, (16,), 0.1), dtype)
    b = _pair(_np(rng, (16,), 0.1), dtype)
    pos = rng.integers(0, 40000, (2, 9)).astype(np.int32)
    tol = 2e-5 if dtype == "float32" else 1.6e-2
    for name, jo, to in (
            ("rope", JL.rope(x[0], jnp.asarray(pos), 1e6),
             TL.rope(x[1], torch.from_numpy(pos).long(), 1e6)),
            ("rms", JL.rms_norm(x[0], w[0]), TL.rms_norm(x[1], w[1])),
            ("ln", JL.layer_norm(x[0], w[0], b[0]), TL.layer_norm(x[1], w[1], b[1]))):
        assert to.dtype == x[1].dtype, name
        _close(to.float().numpy(), np.asarray(jo.astype(jnp.float32)),
               tol * 4, tol, name)
    # hazard d: softplus around and above F.softplus's threshold of 20
    v = np.array([-30, -1, 0, 1, 19.5, 20, 20.5, 25, 40, 90], np.float32)
    jv, tv = _pair(v + _np(rng, v.shape, 0.01), dtype)
    _close(TL.softplus(tv).float().numpy(),
           np.asarray(jax.nn.softplus(jv).astype(jnp.float32)), 0, 0, "softplus")
    _close(TL.gelu(x[1]).float().numpy(),
           np.asarray(jax.nn.gelu(x[0], approximate=True).astype(jnp.float32)),
           tol, tol, "gelu")
