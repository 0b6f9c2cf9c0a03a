"""Architecture registry: one module per assigned architecture (port of
`repro/configs/`, shapes only: nothing loads or downloads weights).

`get_config(arch_id)` returns the exact ModelConfig from the assignment
table; `reduced_config(arch_id)` returns the same-family shrunken config
used by CPU smoke tests (few layers, narrow, tiny vocab/experts).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "qwen1_5_4b", "stablelm_1_6b", "stablelm_12b", "gemma3_27b",
    "zamba2_7b", "grok_1_314b", "qwen3_moe_235b", "falcon_mamba_7b",
    "internvl2_1b", "whisper_medium",
]

# assignment ids -> module names
ALIASES = {
    "qwen1.5-4b": "qwen1_5_4b",
    "stablelm-1.6b": "stablelm_1_6b",
    "stablelm-12b": "stablelm_12b",
    "gemma3-27b": "gemma3_27b",
    "zamba2-7b": "zamba2_7b",
    "grok-1-314b": "grok_1_314b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-1b": "internvl2_1b",
    "whisper-medium": "whisper_medium",
}

# long_500k applicability (DESIGN.md §5): sub-quadratic attention state only
LONG_CONTEXT_ARCHS = {"gemma3_27b", "zamba2_7b", "falcon_mamba_7b"}


def _module(arch: str):
    name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def reduced_config(arch: str) -> ModelConfig:
    return _module(arch).REDUCED


def list_archs() -> list[str]:
    return list(ARCHS)
