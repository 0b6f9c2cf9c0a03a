"""stablelm-1.6b [dense] — hf:stabilityai/stablelm-2-1_6b (MHA)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=5632, vocab=100352,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, q_chunk=32, kv_chunk=32)
