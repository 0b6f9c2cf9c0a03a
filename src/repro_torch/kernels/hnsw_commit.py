"""K5: the insert's back-links on the card.

Source: `csrc/hnsw_commit.cu`. It replaces no Pallas kernel: the reference
commits a batch's back-links inside its jitted `hnsw_insert_batch`
(`repro/core/hnsw.py::_commit_batch`), and the port's commit used to issue
them from a Python loop, one `_link_back` of some ninety small launches per
(row, level). Here a batch's back-links are a `LinkSchedule`: one group
per (level, target), each group's new ids in the batch's row order, since
two back-links to one row change it in turn. `link_back_kernel` applies
the schedule to `state.neighbors` in place, in one launch, and takes CUDA
tensors only.

The plain version lives beside the rule it applies, in
`core/hnsw.py` (`_link_back_plain`), and `core/hnsw.py::link_back` picks
between the two by the state's device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _lib

__all__ = ["LinkSchedule", "check_schedule", "link_back_kernel"]

_METRICS = {"bitmap_jaccard": 0, "minhash_jaccard": 1, "hamming": 2}
# the kernel keeps a row's M0 + 1 candidates two to a lane
_MAX_M0 = 63


class LinkSchedule(NamedTuple):
    """A batch's back-links, grouped; int64 tensors on the state's device.

    level, target (G,): each group's level and the node whose row it
    rewrites, no (level, target) twice; start (G + 1,): offsets of each
    group's new ids in new_ids (N,), which hold them in row order."""
    level: torch.Tensor
    target: torch.Tensor
    start: torch.Tensor
    new_ids: torch.Tensor

    @property
    def groups(self) -> int:
        return self.level.shape[0]

    @property
    def links(self) -> int:
        return self.new_ids.shape[0]


def check_schedule(cfg, state, sched: LinkSchedule) -> None:
    """Raise unless the schedule fits the state and the config."""
    if cfg.metric not in _METRICS:
        raise ValueError(f"unknown metric {cfg.metric}")
    _, cap, M0 = state.neighbors.shape
    if (M0, cap) != (cfg.M0, cfg.capacity) or \
            tuple(state.vectors.shape) != (cfg.capacity, cfg.words):
        raise ValueError(f"neighbors {tuple(state.neighbors.shape)} and "
                         f"vectors {tuple(state.vectors.shape)} do not match "
                         f"M0={cfg.M0}, capacity={cfg.capacity}, "
                         f"words={cfg.words}")
    G = sched.groups
    for name, t, n in (("level", sched.level, G), ("target", sched.target, G),
                       ("start", sched.start, G + 1),
                       ("new_ids", sched.new_ids, sched.links)):
        if t.dtype != torch.int64 or t.ndim != 1 or t.shape[0] != n:
            raise ValueError(f"schedule {name}: expected int64 ({n},), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != state.neighbors.device:
            raise ValueError(f"schedule {name} on {t.device}, state on "
                             f"{state.neighbors.device}")


def link_back_kernel(cfg, state, sched: LinkSchedule) -> None:
    """Apply a batch's back-links to `state.neighbors`, in place (hnswlib's
    mutuallyConnectNewElement, see `core/hnsw.py::_link_back`) with K5.
    CUDA tensors only; the caller has checked the schedule."""
    if state.neighbors.device.type != "cuda":
        raise ValueError(f"K5 takes CUDA tensors, got "
                         f"{state.neighbors.device}")
    if sched.groups == 0:
        return
    if cfg.M0 > _MAX_M0:
        raise ValueError(f"K5 takes M0 <= {_MAX_M0}, got {cfg.M0}")
    _lib.check_words("neighbors", state.neighbors, 3)
    _lib.check_words("vectors", state.vectors, 2)
    _lib.check_words("pb", state.pb, 1)
    if not all(t.is_contiguous() for t in sched):
        raise ValueError("the schedule's tensors must be contiguous")
    nb = state.neighbors
    rc = _lib.library("hnsw_commit.cu").fold_link_back(
        nb.data_ptr(), state.vectors.data_ptr(), state.pb.data_ptr(),
        sched.level.data_ptr(), sched.target.data_ptr(),
        sched.start.data_ptr(), sched.new_ids.data_ptr(), sched.groups,
        cfg.capacity, cfg.M0, cfg.M, cfg.words, _METRICS[cfg.metric],
        int(cfg.select_heuristic), _lib.stream_of(nb))
    _lib.check(rc, "link_back")

