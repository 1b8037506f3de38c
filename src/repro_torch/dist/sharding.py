"""Logical-axis sharding rules, and the row-shard layout of sharded
checkpoints.

Models and cell builders annotate tensors with *logical* axis names
("batch", "heads", "embed_rows", ...). A :class:`ShardingRules` maps those
names onto the axes of a :class:`~repro_torch.launch.mesh.Mesh`, gated on
divisibility: a logical axis only shards if its dimension divides the
product of the mapped mesh-axis sizes, otherwise it stays replicated. The
rules say where each tensor's shards live (the cells' partition specs, the
dry run's per-device bytes) and which ranks take part in a collective
(``models.layers.moe_ffn``'s expert-parallel dispatch).

``row_shard_bounds`` (each host owns a contiguous row-shard of every
embedding table) is canonical in ``core/range_reader.py``, since the
read-side planner inverts the same layout math; this module keeps the
write side's import path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..core.range_reader import row_shard_bounds  # noqa: F401


class PartitionSpec:
    """An immutable tuple of entries, one a tensor dimension: ``None``
    (replicated), one mesh axis name, or a tuple of names (the dimension
    split over their product, the first outermost). ``tuple(spec)`` gives
    the entries, as it does for ``jax.sharding.PartitionSpec``. It is not a
    ``tuple`` subclass, so tree walkers (``repro_torch.tree``) take it as
    a leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        object.__setattr__(self, "_entries", tuple(entries))

    def __setattr__(self, name, value):
        raise AttributeError("PartitionSpec is immutable")

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self._entries == other._entries
        if isinstance(other, tuple):
            return self._entries == other
        return NotImplemented

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self._entries) + ")"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """mesh + {logical axis name -> tuple of mesh axis names}."""

    mesh: Optional[object]  # launch.mesh.Mesh
    axis_map: Dict[str, Tuple[str, ...]] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------- resolution
    def axes_for(self, name: Optional[str], size: Optional[int] = None):
        """Mesh axes for logical axis ``name``, or None if it cannot shard
        (no mesh, unmapped name, or ``size`` not divisible)."""
        if self.mesh is None or name is None:
            return None
        axes = tuple(a for a in self.axis_map.get(name, ())
                     if a in self.mesh.shape)
        if not axes:
            return None
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        if size is not None and (size == 0 or size % n != 0):
            return None
        return axes

    def pspec(self, *logical, dims: Optional[Tuple[int, ...]] = None) -> PartitionSpec:
        """PartitionSpec for a tensor whose dims carry the given logical
        names (None entries stay replicated). Each mesh axis is used at most
        once — later duplicates are dropped, keeping the spec valid even
        when two logical axes map to the same mesh axis."""
        entries = []
        used = set()
        for i, name in enumerate(logical):
            size = dims[i] if dims is not None and i < len(dims) else None
            axes = self.axes_for(name, size)
            if axes:
                axes = tuple(a for a in axes if a not in used)
            if axes:
                used.update(axes)
                entries.append(axes if len(axes) > 1 else axes[0])
            else:
                entries.append(None)
        if dims is not None and len(entries) < len(dims):
            entries.extend([None] * (len(dims) - len(entries)))
        return PartitionSpec(*entries)

    def shard(self, x, *logical):
        """``x`` itself. The reference constrains ``x`` to the sharding its
        logical axes imply (``with_sharding_constraint``); torch has no
        sharding constraint, and a tensor of the port lives whole on its
        rank, so there is nothing to constrain."""
        del logical
        return x


NO_SHARDING = ShardingRules(mesh=None, axis_map={})


# ---------------------------------------------------------------------------
# Family rule sets. Mesh axis convention: ("data", "model").
# ---------------------------------------------------------------------------


def lm_rules(mesh, pure_fsdp: bool = False) -> ShardingRules:
    """Transformer LM rules: batch over data; heads/ff/vocab/experts tensor-
    parallel over model (or pure-FSDP: only d_model over model)."""
    if pure_fsdp:
        amap = {
            "batch": ("data",),
            "d_model": ("model",),
            "embed_rows": ("data", "model"),
        }
    else:
        amap = {
            "batch": ("data",),
            "heads": ("model",),
            "kv_heads": ("model",),
            "ff": ("model",),
            "vocab": ("model",),
            "experts": ("model",),
            "seq_sp": ("model",),
            "embed_rows": ("data", "model"),
        }
    return ShardingRules(mesh=mesh, axis_map=amap)


def recsys_rules(mesh) -> ShardingRules:
    """Recommendation-model rules: batch over data, embedding-table rows
    range-partitioned over the whole mesh, candidate sets over model."""
    return ShardingRules(mesh=mesh, axis_map={
        "batch": ("data",),
        "embed_rows": ("data", "model"),
        "candidates": ("model",),
    })


def gnn_rules(mesh) -> ShardingRules:
    """GNN rules: graph entity dims range-partitioned over the whole mesh."""
    return ShardingRules(mesh=mesh, axis_map={
        "batch": ("data",),
        "nodes": ("data", "model"),
        "edges": ("data", "model"),
        "triplets": ("data", "model"),
        "embed_rows": ("data", "model"),
    })


__all__ = ["NO_SHARDING", "P", "PartitionSpec", "ShardingRules", "gnn_rules",
           "lm_rules", "recsys_rules", "row_shard_bounds"]
