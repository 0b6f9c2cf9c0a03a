"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 (hf:Qwen/Qwen3-235B-A22B).
moe_d_ff=1536 is the per-expert FFN width from the assignment table."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, head_dim=128, d_ff=1536, vocab=151936,
    n_experts=128, topk=8, moe_d_ff=1536, param_dtype="bfloat16",
    rope_theta=1_000_000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, n_experts=8, topk=2, moe_d_ff=64,
    param_dtype="float32", q_chunk=32, kv_chunk=32)
