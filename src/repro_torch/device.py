"""The port's device rule: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means `cuda`. A CUDA request with no card raises; the port
    never carries on on the CPU unless `device="cpu"` was passed."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and found no GPU; pass "
            "device='cpu' to run the plain PyTorch path explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
