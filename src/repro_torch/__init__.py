"""repro_torch — FOLD's online fuzzy-dedup main path in PyTorch and CUDA.

The package mirrors the JAX package `repro` module for module (`core/`,
`kernels/`, `index/`, `index/backends/`, `data/`); each module here names
the reference module it ports. It imports torch and numpy only.

Representation of uint32 data. torch on the CPU has no uint32 `>>`, `+`,
`min` or `%`, so every uint32 array of the reference (token ids, shingle
hashes, MinHash lanes, packed bitmaps, visited bitsets) is held here as a
`torch.int32` tensor carrying the SAME 32 bits. Arithmetic that needs
unsigned semantics widens to int64 and masks with `& 0xFFFFFFFF`
(`core.hashing.u32` / `core.hashing.bits32`); the CUDA kernels
reinterpret the int32 buffers as `uint32_t`. At the boundary,
`t.cpu().numpy().view(np.uint32)` equals the reference's array.

Devices. Entry points (`FoldPipeline`, `hnsw_*`, `ops.*` through their
tensors) run on `cuda` unless the caller passes `device="cpu"`; with no
card and no explicit CPU request they raise. A CPU tensor reaching a
kernel wrapper takes the kernel's plain PyTorch version; a CUDA tensor
launches the kernel or raises — there is no fallback between the two.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
