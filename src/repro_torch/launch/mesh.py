"""Production mesh construction (port of `repro/launch/mesh.py`).

`make_production_mesh` is a FUNCTION: importing this module touches no
device and no process group. It needs a default process group of the
mesh's size already up: `torchrun` ranks on real cards, or the fake group
`launch/dryrun.py` starts, on which 256 or 512 ranks run in one process
over the meta device.

The reference's `PERF_XLA_FLAGS` (latency-hiding scheduler, async
collective fusion) are TPU compiler flags; PyTorch has no counterpart to
set, so this module defines none.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "mesh_axes"]


def mesh_axes(ndim: int) -> tuple[str, ...]:
    """Axis names of a mesh of `ndim` dims: ("data",), ("data", "model")
    or ("pod", "data", "model")."""
    if not 1 <= ndim <= 3:
        raise ValueError(f"a mesh has 1 to 3 dims, not {ndim}")
    return (("data",), ("data", "model"), ("pod", "data", "model"))[ndim - 1]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the `pod` axis is
    an extra DP/FSDP dimension."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=mesh_axes(len(shape)))
