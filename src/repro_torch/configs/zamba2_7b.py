"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block applied
after every 6 SSM layers (arXiv:2411.15242). One shared attn+MLP param set
(real zamba2 alternates two and adds per-use LoRA — noted in DESIGN.md)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, head_dim=112, d_ff=14336, vocab=32000,
    ssm_state=64, ssm_expand=2, mamba_headdim=64, attn_every=6,
    q_chunk=256,  # bounds the SSD intra-chunk (B,Hm,c,c) decay matrices
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, ssm_state=8, attn_every=3, mamba_headdim=16,
    q_chunk=32, kv_chunk=32)
