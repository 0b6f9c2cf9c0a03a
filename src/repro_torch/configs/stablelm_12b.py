"""stablelm-12b [dense] — hf:stabilityai/stablelm-2-12b (GQA kv=8)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, head_dim=160, d_ff=13824, vocab=100352,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, q_chunk=32, kv_chunk=32)
