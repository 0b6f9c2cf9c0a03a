"""Atomic checkpoints in the reference's on-disk layout (port of
`repro/train/checkpoint.py`).

Layout:  <dir>/step_<N>/arrays.msgpack  +  <dir>/step_<N>/MANIFEST.json
written to `step_<N>.tmp` and renamed (atomic on POSIX), so a killed run
never leaves a half checkpoint; `latest_step` trusts committed dirs only.

`arrays.msgpack` is the msgpack encoding of a list of maps
`{"dtype": str, "shape": [int, ...], "data": bin}`, one per leaf, in the
reference's `jax.tree.flatten` order: dict keys sorted, tuple and
NamedTuple fields in order. This module writes and reads that subset of
msgpack by hand, byte for byte as `msgpack.packb` writes it (the smallest
int and str forms, bin 8/16/32), so a checkpoint written by either
package restores into the other and the files are identical.

Leaves are numpy arrays (or numpy scalars) with the reference's dtypes:
callers convert the port's int32-bit tensors back to uint32 first
(`core.hnsw.state_to_numpy`). `restore` returns numpy leaves in the
structure of a template tree.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
from typing import Any

import numpy as np

__all__ = ["save", "save_async", "restore", "latest_step", "list_steps",
           "manifest", "wait_pending", "packb", "unpackb"]

_pending: list[threading.Thread] = []


# ----------------------------------------------------------- tree leaves
def _flatten(tree) -> list:
    """Leaves in jax.tree.flatten order (None is an empty subtree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _flatten(x)]
    return [tree]


def _unflatten(like, leaves: list):
    """Rebuild `like`'s structure from leaves in flatten order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(x) for x in t])
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def _host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):           # a torch tensor: its own dtype
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


# --------------------------------------------------- the msgpack subset
def _uint(n: int, small: int, forms) -> bytes:
    """Smallest header for length/value n: a fix form below `small`, else
    the first (tag, struct code, limit) that holds it."""
    if n < small:
        return b""
    for tag, code, limit in forms:
        if n < limit:
            return bytes([tag]) + struct.pack(">" + code, n)
    raise ValueError(f"{n} does not fit a msgpack length")


def _pack(obj, out: list) -> None:
    if isinstance(obj, dict):
        n = len(obj)
        out.append(bytes([0x80 | n]) if n < 16 else
                   _uint(n, 0, ((0xDE, "H", 1 << 16), (0xDF, "I", 1 << 32))))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out.append(bytes([0x90 | n]) if n < 16 else
                   _uint(n, 0, ((0xDC, "H", 1 << 16), (0xDD, "I", 1 << 32))))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        out.append(bytes([0xA0 | n]) if n < 32 else
                   _uint(n, 0, ((0xD9, "B", 1 << 8), (0xDA, "H", 1 << 16),
                                (0xDB, "I", 1 << 32))))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        out.append(_uint(n, 0, ((0xC4, "B", 1 << 8), (0xC5, "H", 1 << 16),
                                (0xC6, "I", 1 << 32))))
        out.append(obj)
    elif isinstance(obj, (int, np.integer)) and not isinstance(obj, bool):
        n = int(obj)
        if 0 <= n < 128:
            out.append(bytes([n]))
        elif n >= 0:
            out.append(_uint(n, 0, ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16),
                                    (0xCE, "I", 1 << 32),
                                    (0xCF, "Q", 1 << 64))))
        elif n >= -32:
            out.append(struct.pack(">b", n))
        else:
            for tag, code, lo in ((0xD0, "b", -(1 << 7)), (0xD1, "h", -(1 << 15)),
                                  (0xD2, "i", -(1 << 31)), (0xD3, "q", -(1 << 63))):
                if n >= lo:
                    out.append(bytes([tag]) + struct.pack(">" + code, n))
                    break
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of maps, lists, str, bytes and ints, as
    `msgpack.packb` (use_bin_type=True) writes them."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def unpackb(buf: bytes):
    """Decode what `packb` (or the reference's msgpack) wrote: maps,
    arrays, str, bin, ints, nil and bools. bin payloads come back as
    memoryviews into `buf`."""
    view = memoryview(buf)
    pos = 0

    def take(n: int) -> memoryview:
        nonlocal pos
        if pos + n > len(view):
            raise ValueError("truncated msgpack data")
        s = view[pos:pos + n]
        pos += n
        return s

    def num(code: str) -> int:
        return struct.unpack(">" + code, take(struct.calcsize(code)))[0]

    def item():
        t = take(1)[0]
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return {item(): item() for _ in range(t & 0x0F)}
        if 0x90 <= t <= 0x9F:
            return [item() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return str(take(t & 0x1F), "utf-8")
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        lengths = {0xC4: "B", 0xC5: "H", 0xC6: "I"}
        if t in lengths:
            return take(num(lengths[t]))
        ints = {0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if t in ints:
            return num(ints[t])
        strs = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if t in strs:
            return str(take(num(strs[t])), "utf-8")
        if t in (0xDC, 0xDD):
            return [item() for _ in range(num("H" if t == 0xDC else "I"))]
        if t in (0xDE, 0xDF):
            n = num("H" if t == 0xDE else "I")
            return {item(): item() for _ in range(n)}
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    obj = item()
    if pos != len(view):
        raise ValueError("trailing bytes after msgpack object")
    return obj


def _pack_array(a: np.ndarray) -> dict:
    # tobytes() writes C order whatever the layout; np.ascontiguousarray
    # would turn a 0-d leaf into shape (1,)
    a = np.asarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": a.tobytes()}


def _unpack_array(d: dict) -> np.ndarray:
    return np.frombuffer(d["data"], dtype=d["dtype"]).reshape(d["shape"])


# ------------------------------------------------------------ the layout
def save(ckpt_dir: str, step: int, tree, *, extra: dict | None = None):
    """Synchronous atomic checkpoint of a tree of array leaves."""
    host = [_host(x) for x in _flatten(tree)]
    _write(ckpt_dir, step, host, extra or {})


def save_async(ckpt_dir: str, step: int, tree, *,
               extra: dict | None = None) -> threading.Thread:
    """Snapshot to host now (copies), write in a background thread."""
    host = [np.array(_host(x)) for x in _flatten(tree)]
    t = threading.Thread(target=_write, args=(ckpt_dir, step, host,
                                              extra or {}), daemon=True)
    t.start()
    _pending.append(t)
    return t


def wait_pending() -> None:
    for t in _pending:
        t.join()
    _pending.clear()


def _write(ckpt_dir: str, step: int, host_leaves, extra: dict) -> None:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "arrays.msgpack"), "wb") as f:
        f.write(packb([_pack_array(a) for a in host_leaves]))
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump({"step": step, "n_arrays": len(host_leaves), **extra}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def list_steps(ckpt_dir: str) -> list[int]:
    """All committed checkpoint steps, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "MANIFEST.json")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def manifest(ckpt_dir: str, step: int) -> dict:
    """The MANIFEST.json of a committed step (includes save-time extras)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "MANIFEST.json")
    with open(path) as f:
        return json.load(f)


def restore(ckpt_dir: str, step: int, like_tree) -> Any:
    """Restore into the structure of `like_tree`: writable host numpy
    leaves with their saved dtypes."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.msgpack")
    with open(path, "rb") as f:
        packed = unpackb(f.read())
    arrays = [np.array(_unpack_array(d)) for d in packed]
    n_like = len(_flatten(like_tree))
    if len(arrays) != n_like:
        raise ValueError(f"checkpoint/model structure mismatch: "
                         f"{len(arrays)} arrays, template has {n_like}")
    return _unflatten(like_tree, arrays)
