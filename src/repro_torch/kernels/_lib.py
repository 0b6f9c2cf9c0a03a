"""Build, load and count the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by its own `nvcc` process (all started
together) into a shared library with a plain C interface under
`build/kernels/` at the repository root, and loaded with ctypes. A library
is rebuilt only when its source or the flags change (the file name carries
their hash). Nothing is built at import: the first kernel launch builds
everything. A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "BUILD_LOG", "reset_launches", "library", "check",
           "check_words", "stream_of", "build_all"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points per source: name -> number of pointer args, int args
_ENTRY_POINTS = {
    "minhash.cu": {"fold_minhash": (3, 3)},
    "bitmap_jaccard.cu": {"fold_bitmap_jaccard_cached": (5, 3),
                          "fold_bitmap_jaccard_nocache": (3, 3),
                          "fold_hamming": (3, 3)},
    "hnsw_commit.cu": {"fold_link_back": (7, 7)},
}

# Launch counts per kernel: each wrapper adds one where it launches its
# kernel and nowhere else, so a run can show the path went through it.
LAUNCHES = {"minhash": 0, "jaccard_cached": 0, "jaccard_nocache": 0,
            "hamming": 0, "link_back": 0}
# nvcc output (ptxas register / shared-memory report) per source
BUILD_LOG: dict[str, str] = {}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_all() -> dict[str, Path]:
    """Compile every kernel source (one nvcc each, in parallel); returns
    {source: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths: dict[str, Path] = {}
    jobs = []
    for src in _ENTRY_POINTS:
        text = (CSRC / src).read_bytes()
        key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
        out = BUILD_DIR / f"{Path(src).stem}-{key.hexdigest()[:16]}.so"
        paths[src] = out
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        BUILD_LOG[src] = log
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def library(src: str) -> ctypes.CDLL:
    """The loaded library of one source, building all of them first."""
    if src not in _LIBS:
        for name, path in build_all().items():
            if name in _LIBS:
                continue
            lib = ctypes.CDLL(str(path))
            for fn, (n_ptr, n_int) in _ENTRY_POINTS[name].items():
                f = getattr(lib, fn)
                f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                              + [ctypes.c_void_p])
                f.restype = ctypes.c_int
            _LIBS[name] = lib
    return _LIBS[src]


def check_words(name: str, t: torch.Tensor, ndim: int) -> None:
    """Raise unless `t` is a contiguous int32 (word) tensor of rank ndim."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 (uint32 bits), got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of `t`'s device, as the pointer ctypes
    passes; the launch must happen on that device."""
    if t.device.index is not None and t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device} but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, kernel: str) -> None:
    """Raise when a launch was refused; count it otherwise."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {kernel!r} failed to launch: "
                           f"cudaError {rc}")
    LAUNCHES[kernel] += 1
