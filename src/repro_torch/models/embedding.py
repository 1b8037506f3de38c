"""Sparse embedding stack for recsys models, in PyTorch.

The lookup is gather + sum-over-bag (dense multi-hot), the hot path the
paper's models spend their memory bandwidth on: the ``embedding_bag``
kernel on a card, one launch for all fields, its plain version on the CPU.

A training loss reads its tables through a :class:`Lookup`: whole tables on
one device (``WHOLE``), or, on a rank of a mesh that carries a process
group, :class:`ShardedLookup`, where every table whose rows divide the
mesh is split over its ranks and the batch over its ``data`` axis
(``table_lookup`` picks one from the sharding rules).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.embedding_bag import embedding_bag_fields
from ..train.state import TrackedSpec
from .layers import dense_init


def pad_rows(v: int, multiple: int = 512) -> int:
    """Round table rows up so they shard evenly over model×data mesh axes.
    Padding rows are never referenced by any id — safe for lookup-only
    tables (gradients there are identically zero)."""
    return ((v + multiple - 1) // multiple) * multiple


def init_tables(gen: torch.Generator, vocab_sizes: Sequence[int], dim: int,
                prefix: str = "emb") -> Dict[str, torch.Tensor]:
    return {f"{prefix}_{i}": dense_init(gen, (v, dim), scale=1.0 / np.sqrt(dim))
            for i, v in enumerate(vocab_sizes)}


def table_specs(vocab_sizes: Sequence[int], dim: int,
                prefix: str = "emb") -> Dict[str, TrackedSpec]:
    return {
        f"{prefix}_{i}": TrackedSpec(path=("tables", f"{prefix}_{i}"),
                                     units=v, rows=v, dim=dim)
        for i, v in enumerate(vocab_sizes)
    }


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)`` for a (V, D) or (V,) table. Its
    backward sums repeated ids' gradients by sort and segment sum
    (``F.embedding``); advanced indexing's backward serializes them, and
    the zipf-skewed ids of a training batch repeat by the thousand."""
    ids = ids.to(torch.int64)
    if table.dim() == 1:
        return F.embedding(ids, table[:, None])[..., 0]
    return F.embedding(ids, table)


def take_fields(tables: Sequence[torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    """The multi-field lookup as differentiable tensor ops, for training:
    each field's rows by ``take``, summed over H in f32, stacked and cast
    to bf16 — the numbers of ``embedding_bag_fields_torch``, with the
    backward that ``take`` gives (the kernel has none). It stays apart
    from that function, which is the kernel's plain version and is left as
    the kernel is held to it: its advanced indexing is the gather the
    kernel does, and its backward would serialize a batch's repeated ids."""
    return torch.stack([take(t, ids[:, f, :]).sum(dim=-2, dtype=torch.float32)
                        for f, t in enumerate(tables)], dim=1).to(torch.bfloat16)


class Ids(NamedTuple):
    """A batch's ids as a loss reads them: ``local``, this rank's; ``every``,
    the global batch's (every data shard's, in data order), or for
    ``replicated`` ids (one set on every rank, like shared negatives) the
    same ids. On one device both are the batch's ids."""

    local: torch.Tensor
    every: torch.Tensor
    replicated: bool = False

    @property
    def shape(self):
        return self.local.shape

    def field(self, f: int) -> "Ids":
        """Field ``f``'s ids of a (B, F, H) batch."""
        return Ids(self.local[:, f], self.every[:, f], self.replicated)


def _mask(n: int, ids: Sequence[torch.Tensor], lo: int, device) -> torch.Tensor:
    """A bool mask of rows ``[lo, lo + n)`` of a table, set where any of
    ``ids`` falls. Ids outside the range land on a row past the mask, so
    every shape is fixed by the ids' (the meta device runs it)."""
    idx = torch.cat([i.reshape(-1).to(torch.int64) for i in ids]) - lo
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    m = torch.zeros((n + 1,), dtype=torch.bool, device=device)
    m[idx] = True
    return m[:n]


class Lookup:
    """Whole tables on one device: how a training loss reads table rows,
    marks the rows it touched and reduces over its batch."""

    def ids(self, x: torch.Tensor, replicated: bool = False) -> Ids:
        return Ids(x, x, replicated)

    def owned(self, rows: int):
        """(first row, row count) of a ``rows``-row table held here."""
        return 0, rows

    def take(self, table: torch.Tensor, ids: Ids, rows: int) -> torch.Tensor:
        """``take(table, ids)``, differentiable."""
        del rows
        return take(table, ids.local)

    def fields(self, tables: Sequence[torch.Tensor], ids: Ids,
               rows: Sequence[int]) -> torch.Tensor:
        """``take_fields``: ids (B, F, H) → (B, F, D) bf16, differentiable."""
        del rows
        return take_fields(tables, ids.local)

    def rows(self, tables: Sequence[torch.Tensor], ids: Ids,
             rows: Sequence[int]) -> torch.Tensor:
        """Each field's rows of ids (B, F, H) → (B, F, H, D) in the tables'
        dtype, without a gradient (dlrm-rm2's sparse step)."""
        del rows
        idx = ids.local.to(torch.int64)
        return torch.stack([t[idx[:, f, :]] for f, t in enumerate(tables)], dim=1)

    def cotangents(self, g: torch.Tensor, ids: Ids) -> torch.Tensor:
        """The cotangent of ``rows``' result for every id of ``ids.every``."""
        del ids
        return g

    def touched(self, rows: int, *ids: Ids) -> torch.Tensor:
        """The held rows of a ``rows``-row table that ``ids`` touch."""
        lo, n = self.owned(rows)
        return _mask(n, [i.every for i in ids], lo, ids[0].every.device)

    def sums(self, *xs: torch.Tensor):
        """Each term's sum over the global batch."""
        return tuple(torch.sum(x) for x in xs)

    def means(self, *xs: torch.Tensor):
        """Each term's mean over the global batch."""
        return tuple(torch.mean(x) for x in xs)


WHOLE = Lookup()


class ShardedLookup(Lookup):
    """One rank of a mesh that carries a process group. A table of V rows
    is row-sharded where the rules split ``embed_rows`` over it (V divides
    the rows' axes' shard count n): this rank holds rows ``[i·V/n,
    (i+1)·V/n)``, i its index over those axes, the first outermost; other
    tables are replicated. The batch is this rank's data shard.

    A sharded table's rows come from ``dist.group_ops.owned_rows`` of the
    global batch's ids (gathered over ``data``) and ``sum_owners``; the
    field lookup moves bf16, after the cast (the reference's
    ``lookup_fields``: the exchange moves half the bytes), exactly when a
    bag's ids share one owner, as every bag of one id does. Losses are
    global: each term's sum goes through one all-reduce over ``data``
    whose backward passes the cotangent through, so every rank holds the
    global loss and a replicated parameter's gradient is the sum of the
    data ranks' (``train.steps.sum_grads``)."""

    def __init__(self, rules):
        mesh = rules.mesh
        row_axes = tuple(rules.axis_map["embed_rows"])
        batch_axes = tuple(rules.axis_map["batch"])
        if not set(batch_axes) < set(row_axes):
            raise ValueError(f"rows over {row_axes} need the batch's axes "
                             f"{batch_axes} among them")
        self.n = int(np.prod([mesh.shape[a] for a in row_axes]))
        self.n_data = int(np.prod([mesh.shape[a] for a in batch_axes]))
        self.index = 0
        for a in row_axes:
            self.index = self.index * mesh.shape[a] + mesh.axis_index(a)
        self.data = mesh.group_for(batch_axes)
        self.model = mesh.group_for(tuple(a for a in row_axes if a not in batch_axes))
        self.owners = mesh.group_for(row_axes)

    def sharded(self, rows: int) -> bool:
        return rows % self.n == 0

    def owned(self, rows: int):
        if not self.sharded(rows):
            return 0, rows
        return self.index * (rows // self.n), rows // self.n

    def ids(self, x, replicated=False):
        from ..dist.group_ops import gather_ids

        return Ids(x, x if replicated else gather_ids(x, self.data), replicated)

    def _owners_sum(self, partial, ids: Ids):
        from ..dist.group_ops import sum_owners

        return sum_owners(partial, self.data, self.model, self.owners, ids.replicated)

    def _check(self, table, rows):
        lo, n = self.owned(rows)
        if table.shape[0] != n:
            raise ValueError(f"a {rows}-row table on {self.n} shards: this rank holds "
                             f"{n} rows, not {table.shape[0]}")
        return lo

    def take(self, table, ids, rows):
        from ..dist.group_ops import owned_rows

        lo = self._check(table, rows)
        if not self.sharded(rows):
            return take(table, ids.local)
        return self._owners_sum(owned_rows(table, ids.every, lo), ids)

    def _split(self, tables, ids, rows, per_field):
        """Each field's ``per_field`` of its rows for ids (B, F, H), stacked
        on the field axis: a sharded field's of the owned rows of the
        global ids, all of them exchanged in one ``sum_owners``; a
        replicated field's of its local rows."""
        from ..dist.group_ops import owned_rows

        out = [None] * len(tables)
        idx = ids.local.to(torch.int64)
        sharded = [f for f, r in enumerate(rows) if self.sharded(r)]
        for f, (t, r) in enumerate(zip(tables, rows)):
            self._check(t, r)
            if f not in sharded:
                out[f] = per_field(take(t, idx[:, f, :]))
        if sharded:
            part = torch.stack([per_field(owned_rows(tables[f], ids.every[:, f, :],
                                                     self.owned(rows[f])[0]))
                                for f in sharded], dim=1)
            got = self._owners_sum(part, ids)
            for j, f in enumerate(sharded):
                out[f] = got[:, j]
        return torch.stack(out, dim=1)

    def fields(self, tables, ids, rows):
        return self._split(tables, ids, rows, _bag_bf16)

    def ids_over_owners(self, x: torch.Tensor) -> Ids:
        """``x`` with every rank's ``x`` gathered over the rows' axes, in
        rank order: where each rank holds another part of the batch (an LM
        rank's sequence slice of its data shard), the global batch's ids."""
        from ..dist.group_ops import gather_ids

        return Ids(x, gather_ids(x, self.owners))

    def take_sliced(self, table, ids: Ids, rows: int, dtype) -> torch.Tensor:
        """``take(table, ids.local).to(dtype)`` where each rank of the rows'
        axes holds another part of the batch (``ids_over_owners``): the
        owned rows of every rank's ids, cast to ``dtype`` (exact: one owner
        an id), reduce-scattered over the owners, each rank keeping its
        own. Backward: the cotangents all-gathered over the owners, each
        added into its owned row. A replicated table is a plain take."""
        from ..dist.group_ops import owned_rows, reduce_scatter

        lo = self._check(table, rows)
        if not self.sharded(rows):
            return take(table, ids.local).to(dtype)
        return reduce_scatter(owned_rows(table, ids.every, lo).to(dtype), self.owners, dim=0)

    def rows(self, tables, ids, rows):
        with torch.no_grad():
            return self._split(tables, ids, rows, lambda r: r)

    def cotangents(self, g, ids):
        from ..dist.group_ops import gather_ids

        return g if ids.replicated else gather_ids(g, self.data)

    def sums(self, *xs):
        from ..dist.group_ops import all_reduce

        s = all_reduce(torch.stack([torch.sum(x.to(torch.float32)) for x in xs]),
                       self.data, backward="identity")
        return tuple(s.unbind())

    def means(self, *xs):
        return tuple(s / (x.numel() * self.n_data) for s, x in zip(self.sums(*xs), xs))


def _bag_bf16(rows: torch.Tensor) -> torch.Tensor:
    """A field's bag sum over H in f32, cast to bf16 (``take_fields``)."""
    return rows.sum(dim=-2, dtype=torch.float32).to(torch.bfloat16)


def table_lookup(rules) -> Lookup:
    """``ShardedLookup`` on a mesh that carries a process group (or the
    recording groups of the dry run), ``WHOLE`` otherwise."""
    if rules is None or not getattr(rules.mesh, "has_group", False):
        return WHOLE
    return ShardedLookup(rules)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mode: str = "sum",
                  weights=None) -> torch.Tensor:
    """Dense multi-hot bag: ids (..., H) → (..., dim). EmbeddingBag-sum/mean/
    max built from a gather and a reduce over the bag, as the reference's
    (plain tensor ops; the kernel path is ``lookup_fields``)."""
    emb = table[ids.to(torch.int64)]  # (..., H, D)
    if weights is not None:
        emb = emb * weights[..., None]
    if mode == "sum":
        return emb.sum(dim=-2)
    if mode == "mean":
        return emb.mean(dim=-2)
    if mode == "max":
        return emb.amax(dim=-2)
    raise ValueError(mode)


def ragged_embedding_bag(table: torch.Tensor, values: torch.Tensor,
                         offsets: torch.Tensor, num_bags: int,
                         mode: str = "sum") -> torch.Tensor:
    """torch-style ragged EmbeddingBag: values (nnz,), offsets (num_bags+1,).
    Value i belongs to bag ``searchsorted(offsets[1:], i, right=True)``; a
    value past the last bag is dropped, as the reference's segment sum
    drops it. ``mean`` divides by ``max(count, 1)``."""
    emb = table[values.to(torch.int64)]  # (nnz, D)
    pos = torch.arange(values.shape[0], device=values.device)
    bag_ids = torch.searchsorted(offsets[1:].to(torch.int64), pos, right=True)
    keep = bag_ids < num_bags
    out = torch.zeros((num_bags,) + tuple(emb.shape[1:]), dtype=emb.dtype,
                      device=emb.device).index_add_(0, bag_ids[keep], emb[keep])
    if mode == "mean":
        counts = offsets[1:] - offsets[:-1]
        out = out / torch.clamp(counts[:, None], min=1)
    return out


def lookup_fields(tables: Dict[str, torch.Tensor], ids: torch.Tensor,
                  prefix: str = "emb", bag=embedding_bag_fields) -> torch.Tensor:
    """Multi-field lookup: ids (B, F, H) → (B, F, D) bf16 (bag-sum over H),
    cast as the reference casts before its cross-device exchange. One call
    of the multi-field op ``bag`` over all fields: by default
    ``embedding_bag_fields``, on a card one kernel launch, which has no
    backward, so this is the forward of serving (and of ``train_loss`` on
    the CPU). Pass ``embedding_bag_fields_torch`` to hold the kernel
    against the plain version, or ``take_fields`` for a differentiable
    lookup on a card."""
    return bag([tables[f"{prefix}_{f}"] for f in range(ids.shape[1])], ids)


def touched_masks(vocab_sizes: Sequence[int], ids: torch.Tensor,
                  prefix: str = "emb") -> Dict[str, torch.Tensor]:
    """Per-field touched-row masks from a batch of ids (B, F, H)."""
    masks = {}
    for f, v in enumerate(vocab_sizes):
        m = torch.zeros((v,), dtype=torch.bool, device=ids.device)
        m[ids[:, f, :].reshape(-1).to(torch.int64)] = True
        masks[f"{prefix}_{f}"] = m
    return masks


def mlp_init(gen: torch.Generator, dims: Sequence[int],
             bias: bool = True) -> list:
    """Weights in the reference's ``(d_in, d_out)`` layout (``x @ w + b``),
    so the dense snapshot arrays are laid out as the reference writes them."""
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        layer = dict(w=dense_init(gen, (din, dout)))
        if bias:
            layer["b"] = torch.zeros((dout,), dtype=torch.float32,
                                     device=gen.device)
        layers.append(layer)
    return layers


def mlp_apply(layers: list, x: torch.Tensor, act=torch.relu,
              final_act: bool = False,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    n = len(layers)
    h = x.to(compute_dtype)
    for i, layer in enumerate(layers):
        h = h @ layer["w"].to(compute_dtype)
        if "b" in layer:
            h = h + layer["b"].to(compute_dtype)
        if i < n - 1 or final_act:
            h = act(h)
    return h


def bce_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each example's binary cross-entropy with logits, in f32."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(bce_terms(logits, labels))
