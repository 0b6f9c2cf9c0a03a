"""qwen1.5-4b [dense] — hf:Qwen/Qwen1.5-4B (QKV bias, MHA kv=20)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
    n_heads=20, n_kv_heads=20, head_dim=128, d_ff=6912, vocab=151936,
    qkv_bias=True, rope_theta=1_000_000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, q_chunk=32, kv_chunk=32)
