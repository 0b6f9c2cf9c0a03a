"""Serving entry point: batched greedy decoding with a KV cache (port of
`repro/launch/serve.py`).

Prefill steps the decoder over the prompt (the cache-filling path), then
generation goes on step by step for the whole batch. Weights are drawn
from a seeded generator; nothing is downloaded.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
      --batch 4 --prompt-len 32 --gen 64 [--device cpu]

With no `--device` it runs on the card and raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.common import (init_params, tree_index, tree_leaves,
                                       tree_size)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import layer_norm
from repro_torch.train.step import make_decode_step

__all__ = ["Generation", "generate", "init_model", "prefill_cross_caches",
           "main"]


@dataclasses.dataclass
class Generation:
    tokens: np.ndarray           # (B, gen) greedy tokens
    prompt_logits: torch.Tensor  # (B, vocab) f32 after the last prompt token
    prefill_s: float             # stepping the decoder over the prompt
    decode_s: float              # the gen - 1 steps after it
    step_ms: list[float]         # wall time of each of those steps

    @property
    def tokens_per_s(self) -> float:
        steps = self.tokens.shape[1] - 1
        return self.tokens.shape[0] * steps / max(self.decode_s, 1e-9)

    @property
    def median_step_ms(self) -> float:
        return statistics.median(self.step_ms) if self.step_ms else 0.0


def prefill_cross_caches(cfg: ModelConfig, params, caches, frames):
    """Whisper: fill every decoder layer's cross-attention K/V from the
    (stub) encoder output of `frames` (B, T_enc, d), in place."""
    with torch.inference_mode():
        enc = W.whisper_encode(cfg, params, frames)
        B = frames.shape[0]
        H, hd = cfg.n_heads, cfg.hd
        for l in range(cfg.n_layers):
            p = tree_index(params["dec"], l)
            hk = layer_norm(enc, p["x_ln_w"], p["x_ln_b"])
            ck = (hk @ p["x_wk"].to(hk.dtype)).reshape(B, -1, H, hd)
            cv = (hk @ p["x_wv"].to(hk.dtype)
                  + p["x_bv"].to(hk.dtype)).reshape(B, -1, H, hd)
            caches["cross_k"][l] = ck.to(caches["cross_k"].dtype)
            caches["cross_v"][l] = cv.to(caches["cross_v"].dtype)
    return caches


def init_model(cfg: ModelConfig, batch: int, smax: int, device,
               rng: np.random.Generator, generator: torch.Generator | None = None):
    """Weights from `generator` (seeded 0 on `device` by default, as the
    reference uses PRNGKey(0)), zero caches of `smax` positions, and for
    whisper the cross caches from stub frames drawn from `rng` (the draw
    the reference makes before its prompts)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    if cfg.family == "encdec":
        params = init_params(W.whisper_param_specs(cfg), generator, device)
        caches = W.whisper_init_caches(cfg, batch, smax, device)
        frames = torch.as_tensor(
            rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)),
            dtype=torch.float32, device=device)
        prefill_cross_caches(cfg, params, caches, frames)
    else:
        params = init_params(T.param_specs(cfg), generator, device)
        caches = T.init_caches(cfg, batch, smax, device)
    return params, caches


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg: ModelConfig, params, caches, prompts, gen: int) -> Generation:
    """Greedy decoding as the reference's `main` does it: step the decoder
    over the prompt (B, P) at positions 0..P-1, then `gen - 1` more steps,
    each fed the argmax of the last logits (the first generated token
    comes from the last prompt step). Runs on the device of `params`; the
    caches must hold P + gen - 1 positions and are updated in place."""
    device = tree_leaves(params)[0].device
    decode = make_decode_step(cfg)
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                              device=device)
    B, P = prompts.shape

    def pos(t: int) -> torch.Tensor:
        return torch.full((B,), t, dtype=torch.int64, device=device)

    _sync(device)
    t0 = time.perf_counter()
    tok = prompts[:, 0]
    for t in range(P):
        logits, caches = decode(params, caches, tok, pos(t))
        tok = prompts[:, t + 1] if t + 1 < P else torch.argmax(logits, -1)
    prompt_logits = logits
    _sync(device)
    prefill_s = time.perf_counter() - t0

    generated = [tok.cpu().numpy()]
    step_ms = []
    t0 = time.perf_counter()
    for t in range(P, P + gen - 1):
        ts = time.perf_counter()
        logits, caches = decode(params, caches, tok, pos(t))
        tok = torch.argmax(logits, -1)
        generated.append(tok.cpu().numpy())       # waits for the step
        step_ms.append((time.perf_counter() - ts) * 1e3)
    decode_s = time.perf_counter() - t0
    return Generation(np.stack(generated, 1), prompt_logits, prefill_s,
                      decode_s, step_ms)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--cache-len", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    smax = args.cache_len or (args.prompt_len + args.gen)
    B = args.batch
    rng = np.random.default_rng(0)
    params, caches = init_model(cfg, B, smax, device, rng)
    print(f"arch={cfg.name} params={tree_size(params)/1e6:.1f}M "
          f"cache_len={smax} device={device}")

    prompts = rng.integers(1, cfg.vocab, (B, args.prompt_len))
    out = generate(cfg, params, caches, prompts, args.gen)
    steps = args.gen - 1
    print(f"prefill {args.prompt_len} steps: {out.prefill_s:.2f}s | "
          f"decode {steps} steps: {out.decode_s:.2f}s "
          f"({out.tokens_per_s:.1f} tok/s batched)")
    if not bool(torch.isfinite(out.prompt_logits).all()):
        raise RuntimeError("non-finite logits")
    print("sample tokens:", out.tokens[0, :12].tolist())


if __name__ == "__main__":
    main()
