"""falcon-mamba-7b [ssm] — attention-free Mamba1 (arXiv:2410.05355)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=1, n_kv_heads=1, head_dim=64, d_ff=0, vocab=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2, tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, vocab=512, ssm_state=4,
    q_chunk=32, kv_chunk=32)
