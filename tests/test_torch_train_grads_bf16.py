"""The port's gradients at bf16 compute for the dense, VLM and encdec
archs against `jax.grad` of the reference run op by op, and the
embedding's gradient with repeated tokens, with the bounds stated in
tests/test_torch_train_grads.py (the per-arch check is shared; the archs
are split over files to keep each file's run short)."""
from __future__ import annotations

import pytest

from test_torch_train_grads import (BF16_DENSE, BF16_SHARE, _share,
                                    check_grads, jax_grads, port_grads)


@pytest.mark.parametrize("arch", BF16_DENSE)
def test_grads_match_jax_at_bf16(arch):
    check_grads(arch, "bfloat16")


def test_embed_grad_with_repeated_tokens_at_bf16():
    _, want = jax_grads("qwen1_5_4b", "bfloat16", ids=16)
    _, got = port_grads("qwen1_5_4b", "bfloat16", ids=16)
    # leaf 0 is `embed` (sorted keys); its rows 0..15 hold every token
    assert got[0].shape == want[0].shape
    assert _share(got[0], want[0]) <= BF16_SHARE
