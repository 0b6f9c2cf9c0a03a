"""grok-1-314b [moe] — 8 experts top-2 (hf:xai-org/grok-1)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=32768, vocab=131072,
    n_experts=8, topk=2, moe_d_ff=32768, param_dtype="bfloat16",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, n_experts=4, topk=2, moe_d_ff=128,
    param_dtype="float32", q_chunk=32, kv_chunk=32)
