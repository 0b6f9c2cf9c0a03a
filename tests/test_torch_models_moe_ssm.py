"""The port's MoE and state-space archs (grok-1, qwen3-moe, falcon-mamba,
zamba2) at their REDUCED widths against the JAX package's, prefill and one
decode step, with the tolerances stated in tests/test_torch_models.py
(the per-arch check is shared; the archs are split over two files to keep
each file's run short).
"""
from __future__ import annotations

import pytest

from test_torch_models import MOE_SSM_ARCHS, check_arch


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_SSM_ARCHS)
def test_arch_prefill_and_decode_match_jax(arch, cdt):
    check_arch(arch, cdt)
