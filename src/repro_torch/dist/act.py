"""Activation sharding anchors (port of `repro/dist/act.py`).

Model code calls `act.btd(x)` / `act.bd(x)` / `act.logits_spec(x)` at the
canonical activation shapes. When a mesh is active (set by the launcher
via `set_mesh`) and has more than one rank, each redistributes a DTensor
activation to the reference's constraint: the batch dim over the
data-parallel axes when they divide it, and the logits' vocab dim over
"model" when it divides. A Partial activation (the sum a tensor-parallel
product leaves) is reduced there, as GSPMD reduces it at the reference's
`with_sharding_constraint`, and the gradient is held to the same
placements. With no mesh set, or a mesh of one rank, each anchor is the
identity and returns the very tensor it was given, so model code never
branches on topology.

The other helpers stand where DTensor's op-by-op rules fall short, and
are plain ops on plain tensors:
  tile(x, dim, size)     gathers a dim whose shard does not split into
                         `size` equal blocks, before a reshape splits it
  shard_model(x, dim)    shards a merged dim back over "model" (a local
                         slice), so its gradient comes back gathered
  embed(table, tokens)   the vocab-parallel embedding gather
  put_rows_(c, pos, v)   a decode step's cache write, on local blocks
  blockwise(fn, ...)     a batch- and head-parallel function (attention,
                         the SSM scans, the experts' FFN) on each rank's
                         block
  replicated(op, ...)    an op DTensor has no rule for, on the gathered
                         (Replicate) tensors

The mesh is process-global: one launcher owns the mesh for the lifetime
of a run (`set_mesh` ... run ... `clear`), as launch/train.py and
launch/dryrun.py drive it.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.dist.sharding import P, dp_axes, to_placements

__all__ = ["set_mesh", "clear", "current_mesh", "btd", "bd", "logits_spec",
           "tile", "shard_model", "embed", "put_rows_", "blockwise",
           "replicated"]

_MESH: DeviceMesh | None = None


def set_mesh(mesh: DeviceMesh) -> None:
    global _MESH
    _MESH = mesh


def clear() -> None:
    global _MESH
    _MESH = None


def current_mesh() -> DeviceMesh | None:
    return _MESH


class _Constrain(torch.autograd.Function):
    """Redistribute to `placements`, and the gradient to the same ones: a
    sharding constraint holds for the cotangent too, as jax's does (a
    plain redistribute would hand back a partial-sum gradient, and DTensor
    would then gather weights to multiply it)."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements), None, None


def _constrain(x, parts):
    if _MESH is None or _MESH.size() == 1:
        return x
    if not isinstance(x, DTensor):
        raise TypeError("under a mesh of several ranks, activations are "
                        f"DTensors; got a {type(x).__name__}")
    return _Constrain.apply(x, _MESH, to_placements(P(*parts), _MESH))


def _mesh_dims(mesh) -> tuple[list[int], int | None]:
    """(the dp mesh dims, the "model" mesh dim or None)."""
    names = mesh.mesh_dim_names or ()
    return ([i for i, n in enumerate(names) if n != "model"],
            names.index("model") if "model" in names else None)


def _model_axis_for(dim: int):
    """Shard a feature dim over "model" only when it divides evenly."""
    names = _MESH.mesh_dim_names or ()
    if "model" not in names:
        return None
    return "model" if dim % _MESH.size(names.index("model")) == 0 else None


def _dp_axis_for(dim: int):
    """Batch-dim rule: the shared dp-axes convention, divisibility-gated."""
    dp = dp_axes(_MESH)
    if not dp:
        return None
    names = _MESH.mesh_dim_names
    n = math.prod(_MESH.size(names.index(a)) for a in dp)
    return dp if dim % n == 0 else None


def _active() -> bool:
    return _MESH is not None and _MESH.size() > 1


def btd(x):
    """(B, S, d) residual-stream activation: batch over DP, d replicated
    (TP keeps weights sharded and all-reduces partial sums back)."""
    if not _active():
        return x
    return _constrain(x, (_dp_axis_for(x.shape[0]), None, None))


def bd(x):
    """(B, d) single-token decode activation."""
    if not _active():
        return x
    return _constrain(x, (_dp_axis_for(x.shape[0]), None))


def logits_spec(x):
    """(B, S, V) logits: batch over DP, vocab over the tensor axis."""
    if not _active():
        return x
    return _constrain(x, (_dp_axis_for(x.shape[0]), None,
                          _model_axis_for(x.shape[-1])))


def _tiled(x, dim: int, size: int):
    mesh = x.device_mesh
    n = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                  if p.is_shard(dim))
    if size % n == 0:
        return x
    return x.redistribute(mesh, [Replicate() if p.is_shard(dim) else p
                                 for p in x.placements])


def tile(x, dim: int, size: int):
    """`x`, ready to have its dim `dim` split into `size` blocks (the heads
    of a (..., H * hd) projection): a DTensor sharded on that dim over
    ranks that do not divide `size` is gathered on it first, since
    DTensor cannot unflatten an uneven shard (GSPMD reshards there)."""
    if not isinstance(x, DTensor):
        return x
    return _tiled(x, dim % x.ndim, size)


def shard_model(x, dim: int):
    """`x` with its dim `dim` sharded over "model" where it is replicated
    there and the model ranks tile the dim: a local slice forward, a
    gather of the gradient backward. After the heads of an attention
    output are merged (and gathered by `tile` when they do not tile the
    ranks), the output projection then contracts a sharded dim, as GSPMD
    shards it, instead of every model rank computing the whole product
    and its weight gradient."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    _, mi = _mesh_dims(mesh)
    if mi is None or not isinstance(x.placements[mi], Replicate) or \
            x.shape[dim] % mesh.size(mi):
        return x
    pl = list(x.placements)
    pl[mi] = Shard(dim % x.ndim)
    return x.redistribute(mesh, pl)


def embed(table, tokens):
    """`table[tokens]`: rows of an embedding table. On a mesh this is the
    vocab-parallel gather: the table keeps its rows sharded over "model"
    where they are and is gathered over every other mesh dim (FSDP's
    all-gather of the embed dim), the tokens go over the dp axes when
    they divide the batch, and each rank gathers the rows its block holds
    (zeros for the others), so the result is a partial sum over "model".
    Its backward adds each rank's gradient rows into its own block on
    local tensors (DTensor's indexed-write rule is not used)."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    dp, mi = _mesh_dims(mesh)
    rows_split = mi is not None and table.placements[mi].is_shard(0)
    tab_pl = [Shard(0) if i == mi and rows_split else Replicate()
              for i in range(mesh.ndim)]
    on_dp = tokens.shape[0] % math.prod(mesh.size(i) for i in dp) == 0
    tok_pl = [Shard(0) if i in dp and on_dp else Replicate()
              for i in range(mesh.ndim)]
    out_pl = [Partial() if i == mi and rows_split else p
              for i, p in enumerate(tok_pl)]
    grad_pl = [Partial() if i in dp and on_dp else p
               for i, p in enumerate(tab_pl)]
    first = (mesh.get_local_rank(mi) * (table.shape[0] // mesh.size(mi))
             if rows_split else 0)

    def gather(tab, tok):
        if not rows_split:
            return tab[tok]
        local = tok - first
        mine = (local >= 0) & (local < tab.shape[0])
        rows = tab[local.clamp(0, tab.shape[0] - 1)]
        return rows * mine[..., None].to(rows.dtype)

    return local_map(gather, out_placements=out_pl,
                     in_placements=(tab_pl, tok_pl),
                     in_grad_placements=(grad_pl, tok_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def put_rows_(cache, pos, value) -> None:
    """`cache[b, pos[b]] = value[b]` for every row b, in place: a decode
    step's write into its (B, Smax, ...) cache. A DTensor cache takes it
    on its local blocks, `value` and `pos` first placed as the cache's
    batch and trailing dims (DTensor has no rule for an indexed write
    into a sharded dim)."""
    if not isinstance(cache, DTensor):
        cache[torch.arange(cache.shape[0], device=cache.device), pos] = value
        return
    mesh, pl = cache.device_mesh, cache.placements
    if any(p.is_shard(1) for p in pl):
        raise ValueError("a cache sharded over its positions")
    vpl = [Shard(p.dim - 1 if p.dim >= 2 else 0) if p.is_shard() else p
           for p in pl]
    ppl = [Shard(0) if p.is_shard(0) else Replicate() for p in pl]
    local = cache.to_local()
    pos = pos.redistribute(mesh, ppl).to_local()
    local[torch.arange(local.shape[0], device=local.device), pos] = \
        value.redistribute(mesh, vpl).to_local()


def blockwise(fn, args: tuple, dims: tuple, out_dims: tuple, *,
              heads: tuple[int, ...], sum_heads: bool = False):
    """`fn(*args)` on each rank's block, for an `fn` that is independent
    across its batch rows and its head (or channel) blocks: attention,
    the SSM scans, the experts' FFN. `dims` gives, per argument, (batch
    dim, head dim), each None where the argument has none; `out_dims` the
    same for the output, or a tuple of such pairs for several outputs.
    The batch goes over the dp axes when they divide it, the heads over
    "model" when it divides every size in `heads`; the rest is
    replicated. With `sum_heads` the output is the sum over the head
    blocks (a product that contracts them): a partial sum over "model".
    Each rank then runs the plain `fn` on its local tensors (no DTensor
    dispatch per op). With no DTensor argument it is `fn(*args)`."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args)
    dp, mi = _mesh_dims(mesh)
    on_dp = args[0].shape[dims[0][0]] % math.prod(
        mesh.size(i) for i in dp) == 0
    on_model = mi is not None and all(h % mesh.size(mi) == 0 for h in heads)

    def place(batch_dim, head_dim):
        # a list: local_map reads a tuple as one placement list per output
        pl = [Replicate()] * mesh.ndim
        if batch_dim is not None and on_dp:
            for i in dp:
                pl[i] = Shard(batch_dim)
        if head_dim is not None and on_model:
            pl[mi] = Shard(head_dim)
        return pl

    def grad_place(batch_dim, head_dim):
        # an argument replicated over mesh dims that split the work gets
        # from each rank the part of its gradient that rank's block saw
        pl = place(batch_dim, head_dim)
        split = (dp if on_dp else []) + ([mi] if on_model else [])
        return [Partial() if i in split and isinstance(p, Replicate) else p
                for i, p in enumerate(pl)]

    is_dt = [isinstance(a, DTensor) for a in args]
    in_pl = tuple(place(*d) if t else None for t, d in zip(is_dt, dims))
    grad_pl = tuple(grad_place(*d) if t else None
                    for t, d in zip(is_dt, dims))
    out_pl = (tuple(place(*d) for d in out_dims)
              if isinstance(out_dims[0], tuple) else place(*out_dims))
    if sum_heads and on_model:
        out_pl[mi] = Partial()
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def replicated(op, *args, **kwargs):
    """`op(*args, **kwargs)`, with every DTensor argument gathered to
    Replicate first and the result a Replicate DTensor on the same mesh:
    for the ops DTensor has no sharding rule for (named at each call)."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    if mesh is None:
        return op(*args, **kwargs)
    rep = [Replicate()] * mesh.ndim
    local = [a.redistribute(mesh, rep).to_local() if isinstance(a, DTensor)
             else a for a in args]
    return DTensor.from_local(op(*local, **kwargs), mesh, rep,
                              run_check=False)
