"""Unified model configuration covering all 10 assigned architectures
(port of `repro/models/config.py`, field for field).

A model is a token embedding + a sequence of *groups*, each group a static
pattern of block kinds applied `n_groups` times over parameters stacked on
a leading axis. Patterns per family:

  dense      ["global"]                          x L
  gemma3     ["local"]*5 + ["global"]            x L//6  (+ remainder)
  moe        ["moe"]                             x L     (attn + MoE FFN)
  ssm        ["mamba1"]                          x L
  hybrid     ["mamba2"]*attn_every + ["shared_attn"]     (zamba2: shared
              attention weights applied after every group of mamba blocks)
  vlm        dense backbone + precomputed patch-prefix embeddings (stub)
  encdec     whisper: encoder ["enc"] x Le + decoder ["dec"] x L

`pdt` and `cdt` are torch dtypes here (`torch.float32` or
`torch.bfloat16`) where the reference gives jnp ones.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu
    rope_theta: float = 10_000.0
    # sliding-window mix (gemma3)
    window_pattern: int = 0          # period p: (p-1) local + 1 global
    window_size: int = 1024
    # MoE
    n_experts: int = 0
    topk: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_headdim: int = 64          # mamba2 head dim
    attn_every: int = 0              # hybrid: shared attn after every N ssm
    # modality stubs
    prefix_len: int = 0              # vlm: patch-embedding prefix length
    encoder_layers: int = 0          # encdec
    encoder_seq: int = 0             # encdec: e.g. 1500 whisper frames
    # numerics
    param_dtype: str = "float32"     # float32 | bfloat16 (giants)
    compute_dtype: str = "bfloat16"
    # attention chunking (memory knobs; shapes must divide)
    q_chunk: int = 512
    kv_chunk: int = 1024

    # ------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pdt(self) -> torch.dtype:
        return torch.bfloat16 if self.param_dtype == "bfloat16" else torch.float32

    @property
    def cdt(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def d_inner(self) -> int:        # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:        # mamba1 dt projection rank
        return max(self.d_model // 16, 1)

    @property
    def mamba_heads(self) -> int:    # mamba2 heads
        return self.d_inner // self.mamba_headdim

    def group_pattern(self) -> list[str]:
        if self.family in ("dense", "vlm"):
            if self.window_pattern > 1:
                return ["local"] * (self.window_pattern - 1) + ["global"]
            return ["global"]
        if self.family == "moe":
            return ["moe"]
        if self.family == "ssm":
            return ["mamba1"]
        if self.family == "hybrid":
            return ["mamba2"] * self.attn_every + ["shared_attn"]
        if self.family == "encdec":
            return ["dec"]
        raise ValueError(self.family)

    def layer_plan(self) -> tuple[list[str], int, list[str]]:
        """(pattern, n_groups, remainder_pattern) for the decoder stack.

        Hazard h: the remainders. gemma3's REDUCED 8 layers are 1 group of
        6 plus 2 local; zamba2's REDUCED 7 are 2 groups of 3 mamba2 plus 1
        (the shared attention block is not counted against n_layers)."""
        pattern = self.group_pattern()
        if self.family == "hybrid":
            per = self.attn_every
            n_groups = self.n_layers // per
            rem = self.n_layers % per
            return pattern, n_groups, ["mamba2"] * rem
        per = len(pattern)
        n_groups = self.n_layers // per
        rem = self.n_layers % per
        return pattern, n_groups, pattern[:rem]

    def active_params_per_token_layers(self) -> int:
        """Approximate non-embedding params touched per token (for 6ND)."""
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family == "moe":
            ff = self.moe_d_ff or self.d_ff
            mlp = 3 * d * ff * self.topk
        elif self.family in ("ssm",):
            di, N = self.d_inner, self.ssm_state
            mlp = 2 * d * di + di * (self.dt_rank + 2 * N) + self.dt_rank * di + di * d
            attn = 0
        elif self.family == "hybrid":
            di, N = self.d_inner, self.ssm_state
            mlp = 2 * d * di + di * 2 * N + di * d
            # shared attn applied once per attn_every layers
            attn = attn // max(self.attn_every, 1)
        else:
            mlp = 3 * d * self.d_ff if self.act == "swiglu" else 2 * d * self.d_ff
        return self.n_layers * (attn + mlp)
