"""internvl2-1b [vlm] — InternViT frontend (STUB: precomputed patch
embeddings) + Qwen2-0.5B-style backbone (arXiv:2404.16821)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, head_dim=64, d_ff=4864, vocab=151664,  # 151655 padded to /16 for TP (Megatron-style)
    qkv_bias=True, tie_embeddings=True, prefix_len=256,
    rope_theta=1_000_000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, prefix_len=16, q_chunk=32, kv_chunk=32)
