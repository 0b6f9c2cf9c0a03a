"""whisper-medium [audio] — enc-dec, conv frontend STUB (precomputed frame
embeddings, 1500 frames), layernorm + GELU (arXiv:2212.04356)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096, vocab=51872,  # 51865 padded to /16 for TP (Megatron-style)
    norm="layernorm", act="gelu", encoder_layers=24, encoder_seq=1500,
    tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, encoder_layers=2, encoder_seq=30,
    q_chunk=32, kv_chunk=32)
