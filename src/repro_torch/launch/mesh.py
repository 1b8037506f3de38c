"""Device meshes: a named shape, and for code that runs across ranks the
``torch.distributed`` groups of its axes.

Production mesh, single pod: 16 × 16 = 256 devices, axes (data, model).
Multi-pod: 2 × 16 × 16 = 512 devices, axes (pod, data, model); the ``pod``
axis carries an extra level of data parallelism.

A :class:`Mesh` is the counterpart of ``jax.sharding.AbstractMesh``: the
axis names and sizes, in order, and nothing else. ``make_production_mesh``
needs no devices; the dry run (``launch/dryrun.py``) reads per-device bytes
off it. ``make_host_mesh`` lays a mesh over the ranks of an initialised
process group, in axis order with the last axis fastest (as
``jax.make_mesh`` lays out devices), and opens a subgroup for every set of
axes a collective may reduce over. ``make_recording_mesh`` gives a mesh's
shape a :class:`~repro_torch.dist.group_ops.RecordingGroup` for every set
of axes instead: code run over it issues its collectives and moves
nothing, so they are counted without ranks (the dry run).

The hardware constants are the roofline's: an NVIDIA H100 80GB HBM3 (SXM)
at its 700 W power limit, the data sheet's peaks (dense bf16 on the tensor
cores, and the HBM3 rate). They were not measured here. The card has no
inter-chip link that a measurement of this repo has read, so no
inter-chip rate is named.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Iterable, Mapping, Optional, Tuple

# NVIDIA H100 80GB HBM3 (SXM), 700 W power limit: data-sheet peaks
PEAK_FLOPS_BF16 = 989e12      # per card, dense bf16 on the tensor cores
HBM_BW = 3.35e12              # bytes/s per card


class Mesh:
    """Axis names and sizes (``shape``, in axis order). A mesh made by
    ``make_host_mesh`` also holds the process group it spans, this rank's
    index on each axis (``coords``) and the subgroup of every set of axes
    (``group_for``)."""

    def __init__(self, shape: Mapping[str, int], group=None,
                 coords: Optional[Mapping[str, int]] = None,
                 groups: Optional[Mapping[frozenset, object]] = None):
        self.shape: Dict[str, int] = dict(shape)
        self.group = group
        self.coords: Dict[str, int] = dict(coords or {})
        self._groups = dict(groups or {})

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def has_group(self) -> bool:
        return self.group is not None

    def axis_index(self, name: str) -> int:
        """This rank's index along axis ``name``."""
        return self.coords[name]

    def group_for(self, axes: Iterable[str]):
        """The process group of the ranks that share this rank's index on
        every axis outside ``axes``: the group a reduction over ``axes``
        runs in."""
        key = frozenset(axes)
        if not key:
            raise ValueError("a reduction needs at least one mesh axis")
        return self._groups[key]

    def __repr__(self):
        shape = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({shape}{', group' if self.group is not None else ''})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract 16 × 16 (data, model) mesh, or 2 × 16 × 16 (pod, data,
    model) with ``multi_pod``. It needs no devices."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def _coords(index: int, shape: Mapping[str, int]) -> Dict[str, int]:
    """Axis indices of position ``index``, the last axis fastest."""
    out = {}
    for name in reversed(list(shape)):
        index, out[name] = divmod(index, shape[name])
    return {name: out[name] for name in shape}


def make_host_mesh(data: int = 1, model: int = 1, group=None) -> Mesh:
    """A (data, model) mesh over the ranks of ``group`` (the default group
    when None), which must be initialised and hold ``data * model`` ranks.
    Every rank of the default group calls it, in the same order as its
    other group calls: ``torch.distributed.new_group`` is collective."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised "
                           "torch.distributed process group")
    shape = {"data": data, "model": model}
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(dist.get_world_size())))
    if len(ranks) != data * model:
        raise ValueError(f"the group holds {len(ranks)} ranks; a {data} x {model} "
                         f"mesh needs {data * model}")
    me = dist.get_rank()
    coords = _coords(ranks.index(me), shape) if me in ranks else {}
    names = list(shape)
    positions = [_coords(i, shape) for i in range(len(ranks))]
    groups = {}
    for n in range(1, len(names) + 1):
        for axes in itertools.combinations(names, n):
            key = frozenset(axes)
            if n == len(names):
                groups[key] = group if group is not None else dist.group.WORLD
                continue
            # the cosets: ranks that agree on every axis outside ``axes``
            cosets: Dict[tuple, list] = {}
            for r, pos in zip(ranks, positions):
                outside = tuple(pos[a] for a in names if a not in axes)
                cosets.setdefault(outside, []).append(r)
            mine = None
            for members in cosets.values():
                pg = dist.new_group(members)
                if me in members:
                    mine = pg
            groups[key] = mine
    return Mesh(shape, group=group if group is not None else dist.group.WORLD,
                coords=coords, groups=groups)


def make_recording_mesh(mesh: Mesh) -> Mesh:
    """``mesh``'s shape as seen by its first rank (index 0 on every axis),
    with a ``RecordingGroup`` of the right size for every set of axes: a
    collective over it is recorded and moves nothing."""
    from ..dist.group_ops import RecordingGroup

    names = list(mesh.shape)
    groups = {}
    for n in range(1, len(names) + 1):
        for axes in itertools.combinations(names, n):
            groups[frozenset(axes)] = RecordingGroup(math.prod(mesh.shape[a] for a in axes))
    return Mesh(mesh.shape, group=groups[frozenset(names)],
                coords={a: 0 for a in names}, groups=groups)
