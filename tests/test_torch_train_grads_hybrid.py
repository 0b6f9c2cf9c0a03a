"""The port's gradients at bf16 compute for the hybrid arch (zamba2),
held to the reference's accuracy against its f32 gradients, as stated in
tests/test_torch_train_grads.py (the per-arch check is shared; the archs
are split over files to keep each file's run short)."""
from __future__ import annotations

from test_torch_train_grads import check_grads


def test_grads_match_jax_at_bf16_zamba2():
    check_grads("zamba2_7b", "bfloat16")
