"""The port's gradients at bf16 compute for the MoE and state-space archs
(grok-1, qwen3-moe, falcon-mamba) against the reference run op by op,
with the bounds stated in tests/test_torch_train_grads.py (the per-arch
check is shared; the archs are split over files to keep each file's run
short)."""
from __future__ import annotations

import pytest

from test_torch_train_grads import BF16_MOE_SSM, check_grads


@pytest.mark.parametrize("arch", BF16_MOE_SSM)
def test_grads_match_jax_at_bf16(arch):
    check_grads(arch, "bfloat16")
