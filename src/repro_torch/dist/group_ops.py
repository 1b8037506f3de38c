"""Collectives over a process group for code that runs across the ranks of a
mesh: differentiable, recorded, and countable without a group.

``all_gather``, ``reduce_scatter`` and ``all_reduce`` are the ops a
``shard_map`` cell of the reference issues (``jax.lax.all_gather(tiled=
True)``, ``psum_scatter(tiled=True)``, ``psum``), as ``torch.autograd``
functions over a ``torch.distributed`` group:
  * the backward of an all-gather is a reduce-scatter (sum) of the
    cotangent, and the backward of a reduce-scatter an all-gather, as JAX
    transposes them; an all-gather may instead take ``backward="split"``:
    this rank's slice of the cotangent, where every rank computes one
    function of the gathered tensor and so holds its whole cotangent;
  * an all-reduce's backward is chosen by the caller: ``"sum"`` all-reduces
    the cotangent (``torch.distributed.nn``'s rule: each rank's loss is its
    own and the loss meant is their mean), ``"identity"`` passes it
    through (the result is one replicated value, every rank computes the
    same loss from it, and a replicated parameter's gradient is the sum of
    the ranks' gradients);
  * ``copy_to`` is the identity forward and an all-reduce of the cotangent
    backward: the entry of a region whose ranks each compute a part
    (Megatron's "copy to the tensor-parallel region"), whose cotangents
    each rank's input needs summed.
They call the list forms of ``torch.distributed.all_gather`` and
``reduce_scatter`` (the ``*_tensor`` forms are deprecated in newer
releases), which gloo runs on CPU and CUDA tensors, f32 and bf16, on
subgroups too; no op is staged through host memory here.

Every call is noted by the innermost active :func:`recording` (the op, its
operand bytes, the group's size), forward and backward alike. A
:class:`RecordingGroup` stands in for a group of ``size`` ranks and moves
nothing: a collective over it returns a tensor of the right shape and
dtype (on the meta device, with no storage), so a step runs on ``meta``
over a production mesh and its collectives are counted from the calls it
makes (``launch/dryrun.py``). ``collective_bytes`` sums the records in the
reference's shape (``src/repro/launch/dryrun.py``): operand bytes per op,
the per-device wire bytes of a ring algorithm, counts, totals.

``owned_rows`` and ``sum_owners`` read a table whose rows are split over
the ranks of a mesh (each rank holds one contiguous range): every rank
gathers the rows it owns for the ids and writes zero for the rest, and the
partial results are summed over the owners. Each id has exactly one owner,
so the sum adds one value to zeros and the rows arrive bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List

import torch
import torch.nn.functional as F

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


class RecordingGroup:
    """A group of ``size`` ranks in which this process is rank 0: the
    helpers here move nothing over it. A stand-in for counting, never for
    computing: the values it returns are this rank's own."""

    rank = 0

    def __init__(self, size: int):
        self.size = size

    def __repr__(self):
        return f"RecordingGroup(size={self.size})"


def group_size(group) -> int:
    """The number of ranks in ``group`` (None: the default group)."""
    if isinstance(group, RecordingGroup):
        return group.size
    import torch.distributed as dist

    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank within ``group`` (None: the default group)."""
    if isinstance(group, RecordingGroup):
        return group.rank
    import torch.distributed as dist

    return dist.get_rank(group)


@dataclasses.dataclass(frozen=True)
class Call:
    op: str             # one of COLLECTIVE_OPS
    operand_bytes: int  # what this rank puts in
    group_size: int
    dtype: torch.dtype


class Recorder:
    """The collectives issued while it was active, in order."""

    def __init__(self):
        self.calls: List[Call] = []

    def summary(self) -> dict:
        return collective_bytes(self.calls)


_RECORDERS: List[Recorder] = []


@contextlib.contextmanager
def recording():
    """Record every collective of this module issued inside the block."""
    rec = Recorder()
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def _note(op: str, x: torch.Tensor, n: int) -> None:
    if _RECORDERS:
        _RECORDERS[-1].calls.append(Call(op, x.numel() * x.element_size(), n, x.dtype))


def collective_bytes(calls) -> dict:
    """Per-device collective traffic of ``calls``, in the reference's shape
    and by its ring formulas, from each call's operand bytes b and group
    size g: all-gather wire b·(g−1); all-reduce 2·b·(g−1)/g; reduce-scatter
    b·(g−1)/g; all-to-all b·(g−1)/g; collective-permute b."""
    out = {op: 0.0 for op in COLLECTIVE_OPS}
    wire = {op: 0.0 for op in COLLECTIVE_OPS}
    count = {op: 0 for op in COLLECTIVE_OPS}
    for c in calls:
        b, g = float(c.operand_bytes), c.group_size
        if c.op == "all-gather":
            w = b * (g - 1)
        elif c.op == "all-reduce":
            w = 2.0 * b * (g - 1) / g
        elif c.op in ("reduce-scatter", "all-to-all"):
            w = b * (g - 1) / g
        else:
            w = b
        out[c.op] += b
        wire[c.op] += w
        count[c.op] += 1
    out["total"] = sum(out[o] for o in COLLECTIVE_OPS)
    out["wire_total"] = sum(wire[o] for o in COLLECTIVE_OPS)
    out["wire"] = wire
    out["counts"] = count
    return out


# ------------------------------------------------------------- the raw ops


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    _note("all-gather", x, n)
    if isinstance(group, RecordingGroup):
        return torch.cat([x] * n, dim=dim)
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter of {tuple(x.shape)} along {dim} over {n} ranks")
    _note("reduce-scatter", x, n)
    chunks = [c.contiguous() for c in x.chunk(n, dim=dim)]
    if isinstance(group, RecordingGroup):
        return chunks[group.rank].clone()
    import torch.distributed as dist

    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    _note("all-reduce", x, group_size(group))
    y = x.clone()
    if not isinstance(group, RecordingGroup):
        import torch.distributed as dist

        dist.all_reduce(y, group=group)
    return y


# ------------------------------------------------------- differentiable ops


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, backward):
        ctx.group, ctx.dim, ctx.backward = group, dim, backward
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "split":
            n = group_size(ctx.group)
            return g.chunk(n, dim=ctx.dim)[group_rank(ctx.group)].contiguous(), None, None, None
        return _scatter(g, ctx.group, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, backward):
        ctx.group, ctx.backward = group, backward
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "identity":
            return g, None, None
        return _sum(g, ctx.group), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def all_gather(x: torch.Tensor, group, dim: int = 0, backward: str = "sum") -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order
    (``all_gather(tiled=True)``). Backward: ``"sum"``, a reduce-scatter of
    the cotangent; ``"split"``, this rank's slice of it (see the module's
    docstring). A tensor that needs no gradient takes one call."""
    if backward not in ("sum", "split"):
        raise ValueError(f"unknown all-gather backward {backward!r}")
    if not x.requires_grad:
        return _gather(x, group, dim)
    return _AllGather.apply(x, group, dim, backward)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; backward, the ranks' cotangents summed over ``group``
    (one all-reduce, recorded). A tensor that needs no gradient passes
    through without a call."""
    if not x.requires_grad:
        return x
    return _CopyTo.apply(x, group)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` summed, and this rank's slice of the sum along
    ``dim`` (``psum_scatter(tiled=True)``). Backward: an all-gather."""
    return _ReduceScatter.apply(x, group, dim)


def all_reduce(x: torch.Tensor, group, backward: str = "sum") -> torch.Tensor:
    """The ranks' ``x`` summed (``psum``). ``backward``: ``"sum"``
    all-reduces the cotangent, ``"identity"`` passes it through (see the
    module's docstring). A tensor that needs no gradient takes one call."""
    if backward not in ("sum", "identity"):
        raise ValueError(f"unknown all-reduce backward {backward!r}")
    if not x.requires_grad:
        return _sum(x, group)
    return _AllReduce.apply(x, group, backward)


# ------------------------------------------------- row-sharded tables


class _OwnedRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, ids, lo):
        n = shard.shape[0]
        local = ids.to(torch.int64) - lo
        own = (local >= 0) & (local < n)
        ctx.n = n
        # non-owned ids point one row past the shard: the backward drops them
        ctx.save_for_backward(torch.where(own, local, n))
        rows = F.embedding(local.clamp(0, n - 1), shard)
        return torch.where(own[..., None], rows, rows.new_zeros(()))

    @staticmethod
    def backward(ctx, g):
        (local,) = ctx.saved_tensors
        grad = torch.ops.aten.embedding_dense_backward(
            g.contiguous(), local, ctx.n + 1, -1, False)
        return grad[: ctx.n], None, None


def owned_rows(shard: torch.Tensor, ids: torch.Tensor, lo: int) -> torch.Tensor:
    """``shard`` holds rows ``[lo, lo + len(shard))`` of a (V, D) or (V,)
    table: the rows of ``ids`` it holds, zero for the others, shaped
    ``ids.shape + shard.shape[1:]``. Backward: the cotangent of every owned
    id added into its row of the shard (``F.embedding``'s backward, in its
    order), the others dropped."""
    if shard.dim() == 1:
        return _OwnedRows.apply(shard[:, None], ids, lo)[..., 0]
    return _OwnedRows.apply(shard, ids, lo)


class _SumOwners(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, data, model, owners, replicated):
        ctx.data, ctx.replicated = data, replicated
        if replicated:
            return _sum_over(x, owners)
        return _sum_over(_scatter_over(x, data), model)

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            return _sum_over(g, ctx.data), None, None, None, None
        return _gather_over(g, ctx.data), None, None, None, None


def _sum_over(x, group):
    return x.clone() if group_size(group) == 1 else _sum(x, group)


def _scatter_over(x, group):
    return x.clone() if group_size(group) == 1 else _scatter(x, group, 0)


def _gather_over(x, group):
    return x.clone() if group_size(group) == 1 else _gather(x, group, 0)


def gather_ids(ids: torch.Tensor, data) -> torch.Tensor:
    """Every data shard's ``ids`` concatenated along the batch axis, in
    data order: the global batch's ids."""
    return _gather_over(ids, data)


def sum_owners(x: torch.Tensor, data, model, owners, replicated: bool) -> torch.Tensor:
    """The owners' partial lookups summed, for this rank. ``data``,
    ``model`` and ``owners`` are this rank's groups over the batch's axes,
    over the table rows' other axes, and over all the rows' axes.

    ``x`` looks up the global batch's ids (every data shard's, in data
    order): a reduce-scatter over ``data`` leaves this rank its own data
    shard's rows, summed over the data axis's owners, and an all-reduce
    over ``model`` adds the other owners'. Backward: the cotangent
    all-gathered over ``data``, so every owner sees every id's. The ranks
    of a model group compute one replicated loss, so their cotangents are
    one and it is taken once, not summed over them.

    ``replicated`` ids (the same on every rank): an all-reduce over the
    owners; backward, the data shards' cotangents summed over ``data``."""
    return _SumOwners.apply(x, data, model, owners, replicated)


__all__ = ["COLLECTIVE_OPS", "Call", "Recorder", "RecordingGroup", "all_gather",
           "all_reduce", "collective_bytes", "copy_to", "gather_ids", "group_rank", "group_size",
           "owned_rows", "recording", "reduce_scatter", "sum_owners"]
