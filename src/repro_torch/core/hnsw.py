"""Array-based HNSW — the FOLD index (port of `repro/core/hnsw.py`: batched
search, the two-phase batched insert and the per-doc insert, each with or
without the hnswlib selection heuristic, and delete / compact, under the
three metrics: FOLD's bitmap-Jaccard and the FAISS baselines' raw
MinHash-Jaccard and Hamming over (H,) signature lanes).

State layout is the reference's, as tensors on one device:

  vectors    (cap, W)         int32 bits of the packed bitmaps
  pb         (cap,)           int32 cached popcounts
  neighbors  (L+1, cap, M0)   int32 padded adjacency, -1 = empty
  node_level (cap,)           int32, -1 = unused slot
  dead       (cap,)           bool tombstones
  entry / top_level / count   0-dim int32 tensors

How the reference's vmapped `lax.while_loop`s become PyTorch: all queries
of a chunk step in lockstep, and a per-query `run` mask freezes every
query whose own loop condition is false — exactly what a batched
while_loop does — so a query stopped by its step budget never moves
again. There is no Python loop over queries. Selection reproduces JAX's
tie order: `lax.top_k` (lower index first on ties) and the stable
`jnp.argsort` both become `torch.sort(..., stable=True)`, and `argmin`
becomes "first index of the minimum". Out-of-bounds `mode="drop"`
scatters become writes restricted to the valid rows.

The selection heuristic (`_select_diverse`) is a sequential loop over a
row's E distance-sorted candidates; it runs vectorised over every row the
caller holds (a batch's rows at one level, the back-link targets, a chunk
of nodes under repair) and loops over E, never over rows.

Unlike the reference's functional updates, `hnsw_insert_batch`,
`hnsw_delete` and `hnsw_compact` update the state's tensors IN PLACE (the
reference donates the state, so no caller may keep using the old state
either way).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.bitset import (bitset_add, bitset_nbytes, bitset_test,
                                     bitset_zeros)
from repro_torch.core.hashing import popc
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import hamming_from_px

__all__ = ["HNSWConfig", "HNSWState", "hnsw_init", "hnsw_grow",
           "hnsw_insert_batch", "hnsw_search", "hnsw_delete", "hnsw_compact",
           "needs_repair", "sample_levels", "auto_query_chunk", "visited_nbytes",
           "state_from_numpy", "state_to_numpy", "abstract_state",
           "program_cache_sizes"]

_INF = float("inf")

# target for the per-chunk visited state of a batched search
_VISITED_BUDGET_BYTES = 16 << 20

# words per XOR temporary of the candidate-candidate and repair-pool
# distances (each word also takes an int64 popcount temporary)
_PAIR_WORDS = 1 << 25


class HNSWConfig(NamedTuple):
    capacity: int
    words: int                      # W: packed words per vector
    M: int = 16                     # max degree, upper layers
    M0: int = 32                    # max degree, level 0
    ef_construction: int = 64
    ef_search: int = 64
    max_level: int = 4              # levels 0..max_level
    metric: str = "bitmap_jaccard"
    select_heuristic: bool = False
    frontier: int = 4               # beam nodes expanded per step
    packed_visited: bool = True     # bitset vs (capacity,) bool visited
    query_chunk: int | None = None  # None = derive, 0 = never chunk
    batched_insert: bool = True

    @property
    def ml(self) -> float:
        return 1.0 / np.log(max(self.M, 2))


class HNSWState(NamedTuple):
    """Dense index state (see the module docstring). `count` is a
    high-water slot mark."""
    vectors: torch.Tensor
    pb: torch.Tensor
    neighbors: torch.Tensor
    node_level: torch.Tensor
    dead: torch.Tensor
    entry: torch.Tensor
    top_level: torch.Tensor
    count: torch.Tensor


def visited_nbytes(cfg: HNSWConfig) -> int:
    """Per-query visited-set bytes under the configured representation."""
    return bitset_nbytes(cfg.capacity) if cfg.packed_visited else cfg.capacity


def auto_query_chunk(cfg: HNSWConfig) -> int:
    """query_chunk keeping chunk * visited_nbytes under ~16 MiB, clamped
    to [64, 4096] and rounded down to a power of two."""
    per_q = max(visited_nbytes(cfg), 1)
    chunk = max(_VISITED_BUDGET_BYTES // per_q, 1)
    return int(min(4096, max(64, 1 << (chunk.bit_length() - 1))))


def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def hnsw_init(cfg: HNSWConfig, device: str | torch.device | None = None
              ) -> HNSWState:
    return _empty_state(cfg, resolve_device(device))


def abstract_state(cfg: HNSWConfig) -> HNSWState:
    """HNSWState on the `meta` device: shapes and dtypes, no allocation.

    The one place the state's geometry is derived (the reference's
    `jax.eval_shape(hnsw_init)`); repro_torch.analysis reads its interface
    from it, so a field added to HNSWState is covered there too."""
    return _empty_state(cfg, torch.device("meta"))


def _empty_state(cfg: HNSWConfig, dev: torch.device) -> HNSWState:
    cap, W = cfg.capacity, cfg.words
    i32 = torch.int32
    return HNSWState(
        vectors=torch.zeros((cap, W), dtype=i32, device=dev),
        pb=torch.zeros((cap,), dtype=i32, device=dev),
        neighbors=torch.full((cfg.max_level + 1, cap, cfg.M0), -1, dtype=i32,
                             device=dev),
        node_level=torch.full((cap,), -1, dtype=i32, device=dev),
        dead=torch.zeros((cap,), dtype=torch.bool, device=dev),
        entry=_scalar(-1, dev),
        top_level=_scalar(-1, dev),
        count=_scalar(0, dev),
    )


# ------------------------------------------------------- program signatures
# JAX compiles one program per distinct call signature of a jitted entry
# point and keeps it in a process-wide cache; `program_cache_sizes` reports
# those caches' sizes. Eager PyTorch compiles nothing, so each entry point
# below records the signatures it has been called with instead: the shape,
# dtype and device of every tensor argument and the value of every static
# one (cfg, k, ef, query_chunk, None-ness of an optional tensor), keyed as
# passed, positional or keyword. Like JAX's caches, the sets are per
# process; `clear_cache()` on an entry point empties its set, as on a
# jitted function. Recording reads no tensor data, so it costs no sync.
def _signature(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.shape, x.dtype.str)
    if isinstance(x, (tuple, list)):          # HNSWState, HNSWConfig, ...
        return (type(x).__name__,) + tuple(_signature(v) for v in x)
    return x


def _program(fn):
    """Record each call's signature before running `fn`; the wrapper has
    `_cache_size()` and `clear_cache()`, as a jitted function does, and
    `__wrapped__` runs `fn` unrecorded (the calls inside the sharded step,
    which the reference traces into its own program)."""
    seen: set = set()

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        seen.add((_signature(args),
                  tuple(sorted((k, _signature(v)) for k, v in kwargs.items()))))
        return fn(*args, **kwargs)

    entry._cache_size = seen.__len__
    entry.clear_cache = seen.clear
    return entry


def program_cache_sizes() -> dict[str, int]:
    """Distinct call signatures seen by each hot-path entry point in this
    process: what the reference's jit caches count. The service reports it
    in stats(); each entry should grow by exactly |batch buckets| per index
    geometry, ever."""
    return {
        "search": hnsw_search._cache_size(),
        "insert": hnsw_insert_batch._cache_size(),
        "delete": hnsw_delete._cache_size(),
        "compact": hnsw_compact._cache_size(),
    }


def hnsw_grow(cfg: HNSWConfig, state: HNSWState,
              new_capacity: int) -> tuple[HNSWConfig, HNSWState]:
    """Re-pad the dense arrays to a larger capacity; the graph is kept
    exactly and the new slots are empty and unreachable."""
    if new_capacity < cfg.capacity:
        raise ValueError(f"cannot shrink: {new_capacity} < {cfg.capacity}")
    if new_capacity == cfg.capacity:
        return cfg, state
    pad = new_capacity - cfg.capacity
    dev = state.vectors.device

    def grow(x, fill, dim=0):
        shape = list(x.shape)
        shape[dim] = pad
        return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                        device=dev)], dim=dim)

    new_state = state._replace(
        vectors=grow(state.vectors, 0), pb=grow(state.pb, 0),
        neighbors=grow(state.neighbors, -1, dim=1),
        node_level=grow(state.node_level, -1), dead=grow(state.dead, False))
    return cfg._replace(capacity=new_capacity), new_state


def sample_levels(n: int, cfg: HNSWConfig, seed: int = 0) -> np.ndarray:
    """Geometric level assignment, counter-based (deterministic, resumable)."""
    idx = np.arange(n, dtype=np.uint64) + np.uint64(seed) * np.uint64(0x9E3779B9)
    x = idx * np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(29)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(32)
    u = (x.astype(np.float64) + 1.0) / 2.0**64
    lv = np.floor(-np.log(u) * cfg.ml).astype(np.int32)
    return np.minimum(lv, cfg.max_level)


# ------------------------------------------------- carrying state across
def state_from_numpy(d: dict, device: str | torch.device | None = None
                     ) -> HNSWState:
    """HNSWState from a dict of numpy arrays named like the reference's
    fields (uint32 vectors are reinterpreted as int32 bits)."""
    dev = resolve_device(device)

    def t(name, dtype):
        a = np.array(d[name])          # contiguous, keeps 0-d shapes
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.tensor(a, dtype=dtype, device=dev)   # a copy

    i32 = torch.int32
    return HNSWState(vectors=t("vectors", i32), pb=t("pb", i32),
                     neighbors=t("neighbors", i32),
                     node_level=t("node_level", i32),
                     dead=t("dead", torch.bool), entry=t("entry", i32),
                     top_level=t("top_level", i32), count=t("count", i32))


def state_to_numpy(state: HNSWState) -> dict:
    """The reverse of state_from_numpy: numpy arrays with the reference's
    dtypes (vectors as uint32)."""
    # copies: the port updates its state in place
    out = {k: v.detach().cpu().numpy().copy()
           for k, v in state._asdict().items()}
    out["vectors"] = out["vectors"].view(np.uint32)
    return out


# ------------------------------------------------------------- visited set
def _visited_new(cfg: HNSWConfig, n: int, device) -> torch.Tensor:
    if cfg.packed_visited:
        return bitset_zeros(n, cfg.capacity, device)
    return torch.zeros((n, cfg.capacity), dtype=torch.bool, device=device)


def _visited_test(cfg: HNSWConfig, vs, ids) -> torch.Tensor:
    if cfg.packed_visited:
        return bitset_test(vs, ids)
    return torch.gather(vs, 1, torch.clamp(ids, min=0).to(torch.int64)) & (ids >= 0)


def _visited_add(cfg: HNSWConfig, vs, ids, mask) -> None:
    """Mark masked ids visited, in place. Masked ids must be unique per row
    and unvisited (the bitset_add contract)."""
    if cfg.packed_visited:
        bitset_add(vs, ids, mask)
        return
    r, c = torch.nonzero(mask, as_tuple=True)
    vs[r, ids[r, c].to(torch.int64)] = True


# ----------------------------------------------------------------- distance
def _sort_take(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest along the last dim, ties in index order: the
    reference's `lax.top_k(-d, k)` (and stable argsort prefix)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _bitmap_dist(px, pa, pb) -> torch.Tensor:
    """D = 2 px / (pa + pb + px) in f32, 0 where the denominator is 0."""
    denom = pa.to(torch.int64) + pb.to(torch.int64) + px
    d = 2.0 * px.to(torch.float32) / torch.clamp(denom, min=1).to(torch.float32)
    return torch.where(denom > 0, d, torch.zeros_like(d))


def _times_recip(px: torch.Tensor, n: int) -> torch.Tensor:
    """px * f32(1 / n) rounded once to f32, computed exactly: with
    f32(1 / n) = m * 2**-k for a 24-bit integer m, px * m is an exact
    int64, converted to f32 once, and the scale by 2**-k is exact. That is
    how the reference's jitted `px / f32(n)` rounds (XLA multiplies by the
    reciprocal); IEEE division would not."""
    frac, exp = np.frexp(np.float32(1) / np.float32(n))
    m = int(frac * (1 << 24))
    return (px.to(torch.int64) * m).to(torch.float32) * (2.0 ** (int(exp) - 24))


def _pair_dist(cfg: HNSWConfig, a, b, pa, pb) -> torch.Tensor:
    """Distance under cfg.metric between rows a and b (last dim = words,
    the other dims broadcast), rounded as the reference's jitted
    `_dist_rows`:
      bitmap_jaccard   2 px / (pa + pb + px), 0 where that denominator is 0
      minhash_jaccard  1 - mean(lane equality), rounded once as
                       fma(-count, f32(1 / H), 1)
      hamming          px / (32 W), as px * f32(1 / (32 W))
    pa/pb are the cached popcounts, read by bitmap_jaccard only."""
    if cfg.metric == "minhash_jaccard":
        # hamming_from_px(c, H) is 1 - c * f32(1 / H), rounded once
        return hamming_from_px((a == b).sum(-1), cfg.words)
    px = popc(a ^ b).sum(-1)
    if cfg.metric == "hamming":
        return _times_recip(px, cfg.words * 32)
    if cfg.metric == "bitmap_jaccard":
        return _bitmap_dist(px, pa, pb)
    raise ValueError(f"unknown metric {cfg.metric}")


def _dist_rows(cfg: HNSWConfig, q, qpc, vecs, pcs) -> torch.Tensor:
    """Distance from each query q (n, W) to its rows vecs (n or 1, K, W);
    (n, K) f32."""
    return _pair_dist(cfg, q[:, None, :], vecs, qpc[:, None], pcs)


def _dist_ids(cfg: HNSWConfig, state: HNSWState, q, qpc, ids) -> torch.Tensor:
    """Distance from q (n, W) to node ids (n, K); id < 0 -> +inf."""
    safe = torch.clamp(ids, min=0).to(torch.int64)
    d = _dist_rows(cfg, q, qpc, state.vectors[safe], state.pb[safe])
    return torch.where(ids >= 0, d, torch.full_like(d, _INF))


def _mask_dead_sorted(state: HNSWState, ids, d):
    """Mask tombstoned ids out of distance-sorted lists (n, E) and
    re-sort stably (a no-op permutation when nothing is dead)."""
    is_dead = state.dead[torch.clamp(ids, min=0).to(torch.int64)] & (ids >= 0)
    ids = torch.where(is_dead, torch.full_like(ids, -1), ids)
    d = torch.where(is_dead, torch.full_like(d, _INF), d)
    d, order = torch.sort(d, dim=-1, stable=True)
    return torch.gather(ids, -1, order), d


# ------------------------------------------------------------ greedy descent
def _greedy_step(cfg, state, q, qpc, level: int, cur, curd, active,
                 max_steps: int = 64):
    """ef=1 greedy walk at `level` for the rows where `active`: move to
    the closest neighbor while it improves, at most max_steps moves.
    Only still-improving rows are stepped (a batched while_loop freezes
    the others); each step syncs once to test for any such row."""
    cur, curd = cur.clone(), curd.clone()
    run = active.clone()
    arange = torch.arange(cfg.M0, device=q.device)
    for _ in range(max_steps):
        rows = torch.nonzero(run).squeeze(1)
        if rows.numel() == 0:
            break
        nbrs = state.neighbors[level, cur[rows].to(torch.int64)]   # (r, M0)
        d = _dist_ids(cfg, state, q[rows], qpc[rows], nbrs)
        dmin = d.min(-1).values
        # argmin as the FIRST index of the minimum (the reference's order)
        j = torch.where(d == dmin[:, None], arange, cfg.M0).min(-1).values
        better = dmin < curd[rows]
        nxt = torch.gather(nbrs, 1, j[:, None]).squeeze(1)
        cur[rows] = torch.where(better, nxt, cur[rows])
        curd[rows] = torch.minimum(curd[rows], dmin)
        run[rows] = better
    return cur, curd


# ------------------------------------------------------------- beam search
def _search_layer(cfg, state, q, qpc, level: int, ef: int,
                  init_ids, init_dists, visited):
    """Bounded beam search at one level for n queries in lockstep.

    init_ids/init_dists: (n, E) seeds (-1 = empty; distinct per row).
    visited: (n, ...) fresh visited sets, updated in place. Returns
    (ids, dists) of shape (n, ef) sorted ascending. `ef` is the expansion
    budget; each step pops the F = min(frontier, ef) closest unexpanded
    beam nodes and scores their F*M0 fresh neighbors in one call."""
    n, E = init_ids.shape
    pad = ef - E
    if pad < 0:
        raise ValueError("ef must be >= number of seeds")
    F = max(1, min(cfg.frontier, ef))
    M0 = cfg.M0
    dev = q.device
    beam_ids = torch.cat([init_ids, torch.full((n, pad), -1, dtype=torch.int32,
                                               device=dev)], dim=1)
    beam_d = torch.cat([init_dists, torch.full((n, pad), _INF, device=dev)],
                       dim=1)
    expanded = beam_ids < 0
    _visited_add(cfg, visited, init_ids, init_ids >= 0)
    n_exp = torch.zeros(n, dtype=torch.int32, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    f_slot = torch.arange(F, device=dev)
    nbr_level = state.neighbors[level]
    while True:
        # each query's own while_loop condition; finished queries freeze
        run = (~expanded).any(-1) & (n_exp < ef) & (steps < ef)
        if not bool(run.any()):
            break
        masked = torch.where(expanded, torch.full_like(beam_d, _INF), beam_d)
        _, sel = _sort_take(masked, F)                          # (n, F)
        exp_sel = torch.gather(expanded, 1, sel)
        can = (~exp_sel & (f_slot[None, :] < (ef - n_exp)[:, None])
               & run[:, None])
        expanded = expanded.scatter(1, sel, exp_sel | can)
        fids = torch.where(can, torch.gather(beam_ids, 1, sel),
                           torch.full_like(sel, -1, dtype=torch.int32))
        nbrs = nbr_level[torch.clamp(fids, min=0).to(torch.int64)]  # (n,F,M0)
        nbrs = torch.where((fids >= 0)[:, :, None], nbrs,
                           torch.full_like(nbrs, -1)).reshape(n, F * M0)
        # dedup shared neighbors: sort + first occurrence
        snb = torch.sort(nbrs, dim=1).values
        first = torch.cat([torch.ones((n, 1), dtype=torch.bool, device=dev),
                           snb[:, 1:] != snb[:, :-1]], dim=1)
        fresh = (first & (snb >= 0) & ~_visited_test(cfg, visited, snb)
                 & run[:, None])
        _visited_add(cfg, visited, snb, fresh)
        d = torch.where(fresh, _dist_ids(cfg, state, q, qpc, snb),
                        torch.full(snb.shape, _INF, device=dev))
        cat_ids = torch.cat([beam_ids, torch.where(fresh, snb,
                                                   torch.full_like(snb, -1))], 1)
        cat_d = torch.cat([beam_d, d], dim=1)
        cat_exp = torch.cat([expanded, torch.zeros_like(fresh)], dim=1)
        new_d, idx = _sort_take(cat_d, ef)
        new_ids = torch.gather(cat_ids, 1, idx)
        new_exp = torch.gather(cat_exp, 1, idx) | (new_ids < 0)
        r = run[:, None]
        beam_ids = torch.where(r, new_ids, beam_ids)
        beam_d = torch.where(r, new_d, beam_d)
        expanded = torch.where(r, new_exp, expanded)
        n_exp = n_exp + torch.where(run, can.sum(1, dtype=torch.int32), 0)
        steps = steps + run.to(torch.int32)
    beam_d, order = torch.sort(beam_d, dim=1, stable=True)
    return torch.gather(beam_ids, 1, order), beam_d


def _descend(cfg, state, q, qpc, stop_level):
    """Greedy-descend from the global entry down to stop_level+1 (per row)."""
    n = q.shape[0]
    entry = state.entry.reshape(1, 1).expand(n, 1)
    cur = torch.clamp(entry[:, 0], min=0).clone()
    curd = _dist_ids(cfg, state, q, qpc, entry)[:, 0]
    for lev in range(cfg.max_level, 0, -1):
        active = (lev <= state.top_level) & (lev > stop_level)
        cur, curd = _greedy_step(cfg, state, q, qpc, lev, cur, curd, active)
    return cur, curd


def _chunked_map(fn, operands, chunk: int):
    """Run `fn` over leading-axis slices of `operands` of at most `chunk`
    rows and concatenate each output. Chunking bounds the live working
    set and never changes results (queries are independent)."""
    B = operands[0].shape[0]
    if not chunk or B <= chunk:
        return fn(*operands)
    parts = [fn(*(x[s:s + chunk] for x in operands))
             for s in range(0, B, chunk)]
    return tuple(torch.cat(ys, dim=0) for ys in zip(*parts))


# ------------------------------------------------------------------- search
@_program
def hnsw_search(cfg: HNSWConfig, state: HNSWState, queries: torch.Tensor,
                k: int, ef: int | None = None, query_chunk: int | None = None):
    """Batched kNN search. queries (Q, W) int32 bits on the state's device.

    Returns (ids (Q, k) int32, sims (Q, k) f32); missing results are -1 /
    -inf. ef is clamped to >= k. query_chunk: an explicit argument wins,
    else cfg.query_chunk, else auto_query_chunk; 0 disables chunking."""
    ef = cfg.ef_search if ef is None else ef
    ef = max(ef, k)
    if query_chunk is None:
        query_chunk = (cfg.query_chunk if cfg.query_chunk is not None
                       else auto_query_chunk(cfg))
    qpcs = popc(queries).sum(-1).to(torch.int32)

    def run(q, qpc):
        n = q.shape[0]
        visited = _visited_new(cfg, n, q.device)
        cur, curd = _descend(cfg, state, q, qpc,
                             torch.zeros(n, dtype=torch.int32, device=q.device))
        ids, d = _search_layer(cfg, state, q, qpc, 0, ef, cur[:, None],
                               curd[:, None], visited)
        ids, d = _mask_dead_sorted(state, ids, d)
        ids, d = ids[:, :k], d[:, :k]
        empty = state.count == 0
        ids = torch.where(empty | (ids < 0) | ~torch.isfinite(d),
                          torch.full_like(ids, -1), ids)
        sims = torch.where(ids >= 0, 1.0 - d, torch.full_like(d, -_INF))
        return ids, sims

    return _chunked_map(run, (queries, qpcs), query_chunk)


# ------------------------------------------------------------------- insert
def _select_diverse(cfg: HNSWConfig, state: HNSWState, cand_ids, cand_d,
                    m_l: int) -> torch.Tensor:
    """hnswlib's neighbor-selection heuristic over R rows of E
    distance-sorted candidates (-1 / +inf padded): candidate c survives iff
    d(c, q) < min over already selected s of d(c, s), until m_l are taken.
    Returns (R, E) ids with non-selected slots -1.

    The candidate-candidate distances are computed for all rows at once
    (in row chunks bounding the XOR temporary); the selection is the
    reference's sequential loop over E, stepping every row together."""
    R, E = cand_ids.shape
    dev = cand_ids.device
    safe = torch.clamp(cand_ids, min=0).to(torch.int64)
    cc = torch.empty((R, E, E), dtype=torch.float32, device=dev)
    step = max(1, _PAIR_WORDS // max(E * E * state.vectors.shape[1], 1))
    for s in range(0, R, step):
        v = state.vectors[safe[s:s + step]]                   # (r, E, W)
        p = state.pb[safe[s:s + step]]                        # (r, E)
        cc[s:s + step] = _pair_dist(cfg, v[:, :, None, :], v[:, None, :, :],
                                    p[:, :, None], p[:, None, :])
    selected = torch.zeros((R, E), dtype=torch.bool, device=dev)
    count = torch.zeros(R, dtype=torch.int32, device=dev)
    inf = torch.full((R, E), _INF, device=dev)
    for i in range(E):
        ok = (cand_ids[:, i] >= 0) & (count < m_l)
        dsel = torch.where(selected, cc[:, i], inf).min(-1).values
        take = ok & (cand_d[:, i] < dsel)
        selected[:, i] = take
        count += take.to(torch.int32)
    return torch.where(selected, cand_ids, torch.full_like(cand_ids, -1))


def _diverse_rows(cfg: HNSWConfig, state: HNSWState, cand_ids, cand_d,
                  m_l: int) -> torch.Tensor:
    """Adjacency rows (R, M0) under the heuristic: the diverse subset of
    each row's sorted candidates, closest first, -1 padded."""
    div = _select_diverse(cfg, state, cand_ids, cand_d, m_l)
    div_d = torch.where(div >= 0, cand_d, torch.full_like(cand_d, _INF))
    hd, hidx = _sort_take(div_d, cfg.M0)
    return torch.where(torch.isfinite(hd), torch.gather(div, 1, hidx),
                       torch.full_like(hidx, -1, dtype=div.dtype))


def _closest_rows(cfg: HNSWConfig, cand_ids, cand_d, m_l: int
                  ) -> torch.Tensor:
    """Adjacency rows (R, M0) without the heuristic: the m_l closest
    finite candidates, -1 padded."""
    kd, ix = _sort_take(cand_d, cfg.M0)
    keep = torch.gather(cand_ids, 1, ix)
    slot = torch.arange(cfg.M0, device=cand_ids.device)[None, :]
    return torch.where((slot < m_l) & torch.isfinite(kd), keep,
                       torch.full_like(keep, -1))


def _prune_row(cfg: HNSWConfig, state: HNSWState, node: int, level: int,
               cand_ids, cand_d, m_l: int) -> None:
    """Write node's adjacency row at `level` from its (1, E) sorted
    candidates: the m_l closest, or the diverse subset under the
    heuristic. In place."""
    if cfg.select_heuristic:
        row = _diverse_rows(cfg, state, cand_ids, cand_d, m_l)
    else:
        row = _closest_rows(cfg, cand_ids, cand_d, m_l)
    state.neighbors[level, node] = row[0]


def _insert_per_doc(cfg: HNSWConfig, state: HNSWState, vecs, pcs, levels,
                    admit, slots) -> HNSWState:
    """The per-doc path (`batched_insert=False`, the reference's
    `_insert_one` under a fori_loop): one full top-down traversal per
    admitted row, in row order, each seeing every earlier row. The loop
    over rows is the reference's own order; every search inside it runs
    as the batched code does, on one query."""
    dev = state.vectors.device
    adm = admit.cpu().numpy()
    lvl = levels.cpu().numpy()
    slot = slots.cpu().numpy()
    entry, top, count = int(state.entry), int(state.top_level), int(state.count)
    for i in np.flatnonzero(adm):
        idx, level = int(slot[i]), int(lvl[i])
        state.vectors[idx] = vecs[i]
        state.pb[idx] = pcs[i].to(torch.int32)
        state.node_level[idx] = level
        state.dead[idx] = False
        count = max(count, idx + 1)
        if entry < 0:
            entry, top = idx, level
        else:
            q, qpc = vecs[i:i + 1], pcs[i:i + 1]
            cur, curd = _descend(cfg, state, q, qpc, levels[i:i + 1])
            s_ids, s_d = cur[:, None], curd[:, None]
            for lev in range(min(level, top), -1, -1):
                m_l = cfg.M0 if lev == 0 else cfg.M
                visited = _visited_new(cfg, 1, dev)
                c_ids, c_d = _search_layer(cfg, state, q, qpc, lev,
                                           cfg.ef_construction, s_ids, s_d,
                                           visited)
                # new nodes link only to LIVE nodes
                c_ids, c_d = _mask_dead_sorted(state, c_ids, c_d)
                _prune_row(cfg, state, idx, lev, c_ids, c_d, m_l)
                # distance-sorted, -1 last: the valid prefix of the first
                # m_l entries are the back-link targets
                sel = c_ids[0, :m_l]
                nv = int((sel >= 0).sum())
                if nv:
                    _link_back(cfg, state, idx, lev, sel[:nv], m_l)
                s_ids, s_d = c_ids[:, :1], c_d[:, :1]
            if level > top:
                entry, top = idx, level
        state = state._replace(entry=_scalar(entry, dev),
                               top_level=_scalar(top, dev))
    return state._replace(count=_scalar(count, dev))


# ----------------------------------------------- two-phase batched insert
def _pairwise_dists(cfg: HNSWConfig, vecs, pcs, chunk: int) -> torch.Tensor:
    """(B, B) distances among the batch rows, chunked on the query dim."""
    def rows(q, qpc):
        return (_dist_rows(cfg, q, qpc, vecs[None], pcs[None]),)

    return _chunked_map(rows, (vecs, pcs), chunk)[0]


def _discover_candidates(cfg: HNSWConfig, state: HNSWState, vecs, pcs,
                         levels, seed_ids, chunk: int):
    """Phase A: per-row, per-level candidates against the PRE-BATCH graph.

    seed_ids: optional (B, S) step-③ neighbor ids seeding the level-0
    beam. Returns (cand_ids, cand_d): (B, L+1, E) sorted ascending per
    level; inactive levels / an empty graph give -1 / +inf. Only the rows
    active at a level are searched there (the reference searches all and
    masks the inactive results away: the same outputs)."""
    E = cfg.ef_construction
    L1 = cfg.max_level + 1
    dev = vecs.device

    def run(q, qpc, level, *seeds):
        n = q.shape[0]
        cur, curd = _descend(cfg, state, q, qpc, level)
        s_ids, s_d = cur[:, None].clone(), curd[:, None].clone()
        out_ids = torch.full((n, L1, E), -1, dtype=torch.int32, device=dev)
        out_d = torch.full((n, L1, E), _INF, device=dev)
        for lev in range(cfg.max_level, -1, -1):
            active = lev <= torch.minimum(level, state.top_level)
            rows = torch.nonzero(active).squeeze(1)
            if rows.numel() == 0:
                continue
            init_ids, init_d = s_ids[rows], s_d[rows]
            if lev == 0 and seeds:
                # merge the step-③ seeds into the initial beam; repeats
                # (seed == descend result) are masked to keep ids distinct
                sd = seeds[0][rows]
                sdd = _dist_ids(cfg, state, q[rows], qpc[rows], sd)
                cat = torch.cat([init_ids, sd], dim=1)
                catd = torch.cat([init_d, sdd], dim=1)
                so, order = torch.sort(cat, dim=1, stable=True)
                sod = torch.gather(catd, 1, order)
                dup = torch.cat([torch.zeros((so.shape[0], 1), dtype=torch.bool,
                                             device=dev),
                                 so[:, 1:] == so[:, :-1]], dim=1)
                init_ids = torch.where(dup, torch.full_like(so, -1), so)
                init_d = torch.where(dup, torch.full_like(sod, _INF), sod)
            visited = _visited_new(cfg, rows.numel(), dev)
            c_ids, c_d = _search_layer(cfg, state, q[rows], qpc[rows], lev, E,
                                       init_ids, init_d, visited)
            s_ids[rows] = c_ids[:, :1]
            s_d[rows] = c_d[:, :1]
            out_ids[rows, lev] = c_ids
            out_d[rows, lev] = c_d
        # an unreachable / empty-graph "candidate" has +inf distance
        out_ids = torch.where(torch.isfinite(out_d), out_ids,
                              torch.full_like(out_ids, -1))
        out_d = torch.where(out_ids >= 0, out_d, torch.full_like(out_d, _INF))
        return out_ids, out_d

    operands = (vecs, pcs, levels) + (() if seed_ids is None else (seed_ids,))
    return _chunked_map(run, operands, chunk)


def _merge_candidates(cfg: HNSWConfig, state: HNSWState, levels, admit,
                      slots, cand_ids, cand_d, pair_d):
    """Merge each row's phase-A candidates with the batch's EARLIER
    admitted rows present at that level, and derive the new node's
    adjacency rows `fwd` and its back-link targets `sel`, both
    (B, L+1, M0), for the whole batch at once. `state` must be the
    slot-written state: the heuristic reads the batch rows' vectors.
    Under the heuristic `fwd` is computed only for the admitted rows that
    reach the level (no other row's `fwd` is read)."""
    B = slots.shape[0]
    E = cand_ids.shape[-1]
    dev = slots.device
    jidx = torch.arange(B, device=dev)
    earlier = (jidx[None, :] < jidx[:, None]) & admit[None, :]
    m0_slot = torch.arange(cfg.M0, device=dev)[None, :]
    fwd_levels, sel_levels = [], []
    for lev in range(cfg.max_level + 1):
        m_l = cfg.M0 if lev == 0 else cfg.M
        bmask = earlier & (levels[None, :] >= lev)
        b_ids = torch.where(bmask, slots[None, :].expand(B, B),
                            torch.full((B, B), -1, dtype=torch.int32, device=dev))
        b_d = torch.where(bmask, pair_d, torch.full_like(pair_d, _INF))
        cat_ids = torch.cat([cand_ids[:, lev], b_ids], dim=1)
        cat_d = torch.cat([cand_d[:, lev], b_d], dim=1)
        m_d, ix = _sort_take(cat_d, E)
        m_ids = torch.where(torch.isfinite(m_d), torch.gather(cat_ids, 1, ix),
                            torch.full_like(ix, -1, dtype=torch.int32))
        if cfg.select_heuristic:
            fwd = torch.full((B, cfg.M0), -1, dtype=torch.int32, device=dev)
            rows = torch.nonzero(admit & (levels >= lev)).squeeze(1)
            if rows.numel():
                fwd[rows] = _diverse_rows(cfg, state, m_ids[rows], m_d[rows],
                                          m_l)
        else:
            fwd = torch.where(
                (m0_slot < m_l) & torch.isfinite(m_d[:, :cfg.M0]),
                m_ids[:, :cfg.M0], torch.full_like(m_ids[:, :cfg.M0], -1))
        sel_levels.append(m_ids[:, :cfg.M0])
        fwd_levels.append(fwd)
    return torch.stack(fwd_levels, dim=1), torch.stack(sel_levels, dim=1)


def _link_back(cfg: HNSWConfig, state: HNSWState, new_id: int, level: int,
               sel_ids: torch.Tensor, m_l: int) -> None:
    """Add new_id into each selected neighbor's row at `level`; sel_ids
    (S,) are valid and distinct. In place.

    hnswlib's mutuallyConnectNewElement: while a row has room the new id
    is merged in (the closest m_l of the finite candidates); once the row
    would overflow and cfg.select_heuristic is on, the row is re-selected
    with the heuristic over its candidates sorted by distance (stable)."""
    S = sel_ids.shape[0]
    idx = sel_ids.to(torch.int64)
    rows = state.neighbors[level, idx]                          # (S, M0)
    cand = torch.cat([rows, torch.full((S, 1), new_id, dtype=torch.int32,
                                       device=rows.device)], dim=1)
    d = _dist_ids(cfg, state, state.vectors[idx], state.pb[idx], cand)
    new_rows = _closest_rows(cfg, cand, d, m_l)
    if cfg.select_heuristic:
        # only overfull rows take the heuristic's rows: score only them
        over = torch.nonzero((cand >= 0).sum(1) > m_l).squeeze(1)
        if over.numel():
            cd, order = torch.sort(d[over], dim=1, stable=True)
            new_rows[over] = _diverse_rows(
                cfg, state, torch.gather(cand[over], 1, order), cd, m_l)
    state.neighbors[level, idx] = new_rows


def _commit_batch(cfg: HNSWConfig, state: HNSWState, levels, admit, slots,
                  fwd, sel) -> HNSWState:
    """Phase B: the order-dependent graph surgery, in place.

    The sequential part is kept sequential and visible: a Python loop over
    the admitted rows, in row order, doing each row's back-links
    (_link_back). Which (row, level) pairs are active depends only on the
    levels and the running top level, so it is worked out on the host
    first (one copy of the small per-row arrays), and every forward row
    write happens before the loop: a row's own adjacency row is written
    by no earlier row's back-link (back-link targets are pre-batch nodes
    or EARLIER rows), so hoisting the writes changes nothing."""
    adm = admit.cpu().numpy()
    lvl = levels.cpu().numpy()
    slot = slots.cpu().numpy()
    # valid back-link targets are a prefix of each distance-sorted sel row
    n_sel = (sel >= 0).sum(-1).cpu().numpy()                   # (B, L+1)
    top = int(state.top_level)
    entry = int(state.entry)
    work = []                                   # (row, level) in commit order
    for i in np.flatnonzero(adm):
        for lev in range(min(int(lvl[i]), top), -1, -1):
            work.append((int(i), lev))
        if lvl[i] > top:
            entry, top = int(slot[i]), int(lvl[i])
    if work:
        rows = torch.tensor([i for i, _ in work], device=slots.device)
        levs = torch.tensor([lev for _, lev in work], device=slots.device)
        state.neighbors[levs, slots[rows].to(torch.int64)] = fwd[rows, levs]
    for i, lev in work:
        m_l = cfg.M0 if lev == 0 else cfg.M
        nv = min(int(n_sel[i, lev]), m_l)
        if nv:
            _link_back(cfg, state, int(slot[i]), lev, sel[i, lev, :nv], m_l)
    dev = state.entry.device
    return state._replace(entry=_scalar(entry, dev), top_level=_scalar(top, dev))


@_program
def hnsw_insert_batch(cfg: HNSWConfig, state: HNSWState, vecs: torch.Tensor,
                      pcs: torch.Tensor, levels, mask,
                      seed_ids: torch.Tensor | None = None,
                      free_slots: torch.Tensor | None = None
                      ) -> tuple[HNSWState, torch.Tensor]:
    """Insert a batch in deterministic row order; mask=False rows skip.

    vecs (B, W) int32 bits; pcs (B,) int32; levels (B,) pre-sampled;
    mask (B,) bool. seed_ids: optional (B, S) step-③ neighbor ids seeding
    candidate discovery (the per-doc path, cfg.batched_insert=False,
    ignores them). free_slots: optional (F,) reclaimed slot ids,
    -1 padded, consumed first. Updates `state`'s tensors in place and
    returns (state, n_inserted) with n_inserted a 0-dim device tensor
    (< mask.sum() when the index is full)."""
    dev = state.vectors.device
    mask = torch.as_tensor(mask, device=dev).to(torch.bool)
    levels = torch.as_tensor(levels, device=dev).to(torch.int32)
    count0 = state.count
    offs = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    if free_slots is None:
        slots = count0 + offs
        fresh = mask
    else:
        free_slots = torch.as_tensor(free_slots, device=dev).to(torch.int32)
        n_free = (free_slots >= 0).sum(dtype=torch.int32)
        use_free = (offs >= 0) & (offs < n_free)
        gather = torch.clamp(offs, 0, free_slots.shape[0] - 1).to(torch.int64)
        slots = torch.where(use_free, free_slots[gather],
                            count0 + offs - n_free)
        fresh = mask & ~use_free
    admit = mask & (slots >= 0) & (slots < cfg.capacity)
    n_ins = admit.sum(dtype=torch.int32)
    new_count = count0 + (admit & fresh).sum(dtype=torch.int32)

    if not cfg.batched_insert:
        # the per-doc path ignores seed_ids, as the reference's does
        return _insert_per_doc(cfg, state, vecs, pcs, levels, admit,
                               slots), n_ins

    chunk = (cfg.query_chunk if cfg.query_chunk is not None
             else auto_query_chunk(cfg))
    if seed_ids is not None:
        seed_ids = torch.as_tensor(seed_ids, device=dev).to(
            torch.int32)[:, :cfg.ef_construction - 1].contiguous()
    cand_ids, cand_d = _discover_candidates(cfg, state, vecs, pcs, levels,
                                            seed_ids, chunk)
    # new nodes link only to LIVE candidates
    cand_dead = (state.dead[torch.clamp(cand_ids, min=0).to(torch.int64)]
                 & (cand_ids >= 0))
    cand_ids = torch.where(cand_dead, torch.full_like(cand_ids, -1), cand_ids)
    cand_d = torch.where(cand_dead, torch.full_like(cand_d, _INF), cand_d)
    pair_d = _pairwise_dists(cfg, vecs, pcs, chunk)

    rows = torch.nonzero(admit).squeeze(1)
    tgt = slots[rows].to(torch.int64)
    state.vectors[tgt] = vecs[rows]
    state.pb[tgt] = pcs[rows].to(torch.int32)
    state.node_level[tgt] = levels[rows]
    state.dead[tgt] = False
    state = state._replace(count=new_count)
    fwd, sel = _merge_candidates(cfg, state, levels, admit, slots, cand_ids,
                                 cand_d, pair_d)
    state = _commit_batch(cfg, state, levels, admit, slots, fwd, sel)
    return state, n_ins



# ------------------------------------------------------- delete & compact
@_program
def hnsw_delete(cfg: HNSWConfig, state: HNSWState, ids
                ) -> tuple[HNSWState, torch.Tensor]:
    """Tombstone node ids (D,), -1 padded; out-of-range, unused and
    already-dead ids are ignored (duplicate live ids in one call would be
    double-counted: callers dedup). Dead nodes stay navigable but are
    masked from search results and new adjacency; their slots are
    reusable only after hnsw_compact. In place; returns (state,
    n_newly_dead) as a 0-dim device tensor."""
    ids = torch.as_tensor(ids, device=state.dead.device).to(torch.int32)
    safe = torch.clamp(ids, 0, cfg.capacity - 1).to(torch.int64)
    valid = ((ids >= 0) & (ids < cfg.capacity)
             & (state.node_level[safe] >= 0) & ~state.dead[safe])
    state.dead[safe[valid]] = True
    return state, valid.sum(dtype=torch.int32)


def needs_repair(state: HNSWState, live: torch.Tensor, lev: int
                 ) -> torch.Tensor:
    """Nodes whose level-`lev` row references a tombstone: the only rows
    `hnsw_compact` rebuilds (every other row comes back unchanged), as a
    1-D int64 index tensor."""
    rows = state.neighbors[lev]
    nb_dead = (state.dead[torch.clamp(rows, min=0).to(torch.int64)]
               & (rows >= 0)).any(1)
    return torch.nonzero(live & (state.node_level >= lev) & nb_dead
                         ).squeeze(1)


def _repair_rows(cfg: HNSWConfig, state: HNSWState, live, lev: int,
                 m_l: int, nodes: torch.Tensor) -> torch.Tensor:
    """Rebuilt level-`lev` rows (c, M0) for `nodes`: the candidate pool is
    each node's live neighbors plus its live neighbors-of-neighbors
    (hnswlib's repairConnectionsForUpdate), deduplicated, the closest E
    kept, then selected by the insert-time policy."""
    K = cfg.M0 * (1 + cfg.M0)
    E = min(K, max(cfg.ef_construction, cfg.M0))
    c = nodes.shape[0]
    row = state.neighbors[lev, nodes]                          # (c, M0)
    hops = state.neighbors[lev, torch.clamp(row, min=0).to(torch.int64)]
    hops = torch.where((row >= 0)[:, :, None], hops, torch.full_like(hops, -1))
    pool = torch.cat([row, hops.reshape(c, -1)], dim=1)        # (c, K)
    ok = ((pool >= 0) & live[torch.clamp(pool, min=0).to(torch.int64)]
          & (pool != nodes[:, None]))
    srt = torch.sort(torch.where(ok, pool, torch.full_like(pool, -1)),
                     dim=1).values
    dup = torch.cat([torch.zeros((c, 1), dtype=torch.bool, device=pool.device),
                     srt[:, 1:] == srt[:, :-1]], dim=1)
    pool = torch.where(dup, torch.full_like(srt, -1), srt)
    d = _dist_ids(cfg, state, state.vectors[nodes], state.pb[nodes], pool)
    c_d, ix = _sort_take(d, E)
    c_ids = torch.where(torch.isfinite(c_d), torch.gather(pool, 1, ix),
                        torch.full_like(ix, -1, dtype=pool.dtype))
    if cfg.select_heuristic:
        return _diverse_rows(cfg, state, c_ids, c_d, m_l)
    return _closest_rows(cfg, c_ids, c_d, m_l)


@_program
def hnsw_compact(cfg: HNSWConfig, state: HNSWState
                 ) -> tuple[HNSWState, torch.Tensor]:
    """Online compaction: rebuild every live row that references a
    tombstone (per level, from its live neighbors-of-neighbors), then
    unlink the dead so their slots become free-listed (node_level -1
    below the count mark), re-elect the entry if it died or was
    out-ranked, and lower `count` only when the tail itself died. In
    place; returns (state, n_reclaimed) as a 0-dim device tensor.

    The reference scores the candidate pool of every node at every level
    and keeps the old row where nothing needs repair; only the rows that
    `needs_repair` selects are scored here, in chunks bounding the
    (chunk, K, W) XOR temporary: the same state."""
    dev = state.vectors.device
    dead0 = state.dead.clone()
    live = (state.node_level >= 0) & ~dead0
    K = cfg.M0 * (1 + cfg.M0)
    chunk = max(1, _PAIR_WORDS // (K * cfg.words))
    for lev in range(cfg.max_level + 1):
        m_l = cfg.M0 if lev == 0 else cfg.M
        nodes = needs_repair(state, live, lev)
        # each level's repair reads only that level's rows: computing all
        # of them before writing keeps every read on the old rows
        new = [_repair_rows(cfg, state, live, lev, m_l, nodes[s:s + chunk])
               for s in range(0, nodes.shape[0], chunk)]
        if new:
            state.neighbors[lev, nodes] = torch.cat(new)
    # unlink the dead: clear their rows and drop any stale reference
    for lev in range(cfg.max_level + 1):
        nb = state.neighbors[lev]
        nb[dead0] = -1
        ref_dead = dead0[torch.clamp(nb, min=0).to(torch.int64)] & (nb >= 0)
        nb.masked_fill_(ref_dead, -1)
    state.node_level.masked_fill_(dead0, -1)
    state.dead.zero_()
    ar = torch.arange(cfg.capacity, dtype=torch.int32, device=dev)
    lv = torch.where(live, state.node_level, torch.full_like(ar, -1))
    top = lv.max()
    esafe = torch.clamp(state.entry, 0, cfg.capacity - 1).to(torch.int64)
    keep_entry = ((state.entry >= 0) & live[esafe]
                  & (state.node_level[esafe] >= top))
    first_top = torch.where(lv == top, ar, cfg.capacity).min()
    entry = torch.where(top >= 0, torch.where(keep_entry, state.entry,
                                              first_top),
                        torch.full_like(state.entry, -1)).to(torch.int32)
    count = torch.where(live, ar + 1, torch.zeros_like(ar)).max()
    state = state._replace(entry=entry.reshape(()),
                           top_level=torch.where(top >= 0, top,
                                                 -1).to(torch.int32).reshape(()),
                           count=count.to(torch.int32).reshape(()))
    return state, dead0.sum(dtype=torch.int32)
