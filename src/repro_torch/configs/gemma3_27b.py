"""gemma3-27b [dense] — 5:1 local:global sliding-window mix, 128k context.

window_pattern=6 -> 5 local (1024-token window) + 1 global per group;
62 = 10 groups + 2 remainder local layers. Single rope_theta used for both
local and global layers (real gemma3 uses 10k local / 1M global — noted in
DESIGN.md as a simplification that does not change shapes/FLOPs).
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
    n_heads=32, n_kv_heads=16, head_dim=128, d_ff=21504, vocab=262144,
    window_pattern=6, window_size=1024, tie_embeddings=True,
    rope_theta=1_000_000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, window_size=16, q_chunk=32, kv_chunk=32)
