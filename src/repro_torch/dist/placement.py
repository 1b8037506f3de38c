"""Where a cell's train state and batch live on the ranks of a (data, model)
mesh, read off the cell's partition specs.

A leaf whose spec names mesh axes is split along those dimensions, each
rank holding its contiguous block (the axes of one dimension linearized
with the first outermost, as ``make_host_mesh`` orders ranks with the last
axis fastest); a leaf whose spec names none is replicated. For the recsys
cells under ``recsys_rules`` that is every table whose rows divide the
mesh, its row-wise accumulator and its touched mask, and bert4rec's
``out_bias``, split over (data, model); the dense leaves replicated; the
batch's leading axis split over ``data`` (``neg_ids`` replicated). For
dimenet's ``molecule``, the batch over ``data`` and nothing else: its
95-row species table does not divide a mesh.

Under micro-batching (bert4rec's full batch in 4) a rank's data shard is
its slice of each micro-batch in turn, so the step's micro-batch i is the
rank's part of the reference's micro-batch i, whose masked mean divides by
that micro-batch's global count.

``gather_state`` brings the row-sharded leaves to rank 0's host over the
group for a save (one ``gather`` a dtype), so rank 0 writes the one chain a
single process would write for the whole state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from ..tree import flatten_with_path, keystr, map_with_path


def _axes(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_bounds(shape, spec, mesh) -> tuple:
    """This rank's ``(lo, hi)`` along each dimension of a ``shape`` leaf
    laid out by ``spec`` on ``mesh`` (its ``coords``)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for d, e in zip(shape, spec):
        axes = _axes(e)
        n = math.prod(mesh.shape[a] for a in axes)
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + mesh.axis_index(a)
        if d % n:
            raise ValueError(f"{d} does not split over {axes} ({n} shards)")
        out.append((i * (d // n), (i + 1) * (d // n)))
    return tuple(out)


def _whole_shape(shape, spec, mesh) -> tuple:
    """The whole leaf's shape of a ``shape`` block laid out by ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d * math.prod(mesh.shape[a] for a in _axes(e)) for d, e in zip(shape, spec))


def is_split(spec) -> bool:
    return any(e is not None for e in spec)


def local_shard(x, spec, mesh):
    """This rank's block of ``x`` (a tensor or a numpy array); ``x`` itself
    when ``spec`` is replicated. A tensor's block is a copy of its own, so
    the whole can be freed."""
    if not is_split(spec):
        return x
    block = x[tuple(slice(lo, hi) for lo, hi in shard_bounds(x.shape, spec, mesh))]
    return block.clone() if isinstance(block, torch.Tensor) else np.ascontiguousarray(block)


class Placement:
    """A train cell's layout on one rank of ``mesh``, from ``bundle``'s
    specs (``state_pspecs``, ``input_pspecs``)."""

    def __init__(self, bundle, mesh):
        from ..train.state import TrainState

        self.mesh = mesh
        self.bundle = bundle
        self.specs: TrainState = bundle.state_pspecs()
        self.input_specs = bundle.input_pspecs
        self.n_micro = getattr(bundle.step_fn, "n_micro", 1)
        self._split_params = {keystr(p) for p, s in flatten_with_path(self.specs.params)
                              if is_split(s)}

    # ------------------------------------------------------------ layout
    def param_is_replicated(self, path) -> bool:
        """Whether the parameter at ``path`` (a tree path) is replicated."""
        return keystr(path) not in self._split_params

    def replicated_tables(self) -> List[str]:
        """The tracked tables every rank holds whole."""
        return [name for name, spec in self.bundle.tracked.items()
                if not is_split(_at(self.specs.params, spec.path))]

    def _split_leaves(self, state):
        """``[(tag, path, leaf, spec)]`` of every split leaf of ``state``:
        tag ``params``, ``opt_state`` or ``touched``."""
        out = []
        for tag in ("params", "opt_state", "touched"):
            specs = {keystr(p): s for p, s in flatten_with_path(getattr(self.specs, tag))}
            for p, leaf in flatten_with_path(getattr(state, tag)):
                if is_split(specs[keystr(p)]):
                    out.append((tag, p, leaf, specs[keystr(p)]))
        return out

    def local_state(self, state):
        """This rank's part of a whole ``state``: copies, the replicated
        leaves too, so a step that updates tables in place (dlrm-rm2's)
        leaves ``state`` as it was."""
        def part(tag):
            specs = {keystr(p): s for p, s in flatten_with_path(getattr(self.specs, tag))}
            return map_with_path(
                lambda p, x: (local_shard(x, specs[keystr(p)], self.mesh)
                              if is_split(specs[keystr(p)]) else x.clone()),
                getattr(state, tag))
        return dataclasses.replace(state, params=part("params"),
                                   opt_state=part("opt_state"), touched=part("touched"))

    def local_batch(self, batch: Dict) -> Dict:
        """This rank's part of a global batch (host arrays or tensors): each
        array by its spec; under micro-batching a data-sharded array is cut
        into the micro-batches first, and the rank's slice of each is
        concatenated in turn."""
        out = {}
        for k, x in batch.items():
            spec = self.input_specs[k]
            if self.n_micro == 1 or not is_split(spec):
                out[k] = local_shard(x, spec, self.mesh)
                continue
            m = x.reshape((self.n_micro, x.shape[0] // self.n_micro) + tuple(x.shape[1:]))
            part = local_shard(m, (None,) + tuple(spec), self.mesh)
            out[k] = part.reshape((-1,) + tuple(x.shape[1:]))
        return out

    def local_dense(self, dense: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """A snapshot's flat dense arrays (``params[...]``, ``opt[...]``, as
        ``train.state.state_to_snapshot`` names them) with this rank's block
        of every split dense leaf."""
        specs = {}
        for p, s in flatten_with_path(self.specs.params["dense"]):
            specs["params" + keystr(p)] = s
        for p, s in flatten_with_path(self.specs.opt_state):
            specs["opt" + keystr(p)] = s
        return {k: local_shard(v, specs[k], self.mesh) if k in specs else v
                for k, v in dense.items()}

    # ------------------------------------------------------------ saves
    def gather_state(self, state):
        """Every rank calls it at a save: the split leaves of ``state`` go to
        rank 0's host over the mesh's group, one ``gather`` a dtype. Rank 0
        gets the whole state (host tensors), the others None."""
        import torch.distributed as dist

        from ..launch.mesh import Mesh

        group, n = self.mesh.group, self.mesh.size
        me = dist.get_rank(group)
        # group rank r sits at position r of the mesh, the last axis fastest
        ranks = [Mesh(self.mesh.shape, coords=dict(zip(self.mesh.shape, np.unravel_index(
            r, tuple(self.mesh.shape.values()))))) for r in range(n)]
        by_dtype: Dict[torch.dtype, list] = {}
        for item in self._split_leaves(state):
            by_dtype.setdefault(_wire_dtype(item[2].dtype), []).append(item)
        whole = {}
        for dtype, items in by_dtype.items():
            mine = torch.cat([leaf.detach().reshape(-1).to("cpu").to(dtype)
                              for _, _, leaf, _ in items])
            parts = [torch.empty_like(mine) for _ in range(n)] if me == 0 else None
            dist.gather(mine, parts, dst=0, group=group)
            if me != 0:
                continue
            for rank_mesh, buf in zip(ranks, parts):
                for (tag, p, leaf, spec), chunk in zip(
                        items, torch.split(buf, [x[2].numel() for x in items])):
                    key = (tag, keystr(p))
                    if key not in whole:
                        whole[key] = torch.empty(_whole_shape(leaf.shape, spec, self.mesh),
                                                 dtype=leaf.dtype)
                    block = tuple(slice(lo, hi) for lo, hi in
                                  shard_bounds(whole[key].shape, spec, rank_mesh))
                    whole[key][block] = chunk.reshape(leaf.shape).to(leaf.dtype)
        if me != 0:
            return None

        def assemble(tag):
            return map_with_path(
                lambda p, x: whole.get((tag, keystr(p)), x.detach().to("cpu")),
                getattr(state, tag))
        return dataclasses.replace(state, params=assemble("params"),
                                   opt_state=assemble("opt_state"),
                                   touched=assemble("touched"))

    def split_bytes(self, state) -> int:
        """This rank's bytes of the split leaves (what a save gathers)."""
        return sum(leaf.numel() * leaf.element_size() for *_, leaf, _ in self._split_leaves(state))


def _wire_dtype(dtype):
    """gloo moves no bool: the touched masks travel as uint8."""
    return torch.uint8 if dtype == torch.bool else dtype


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def rows_digest(arrays) -> str:
    """SHA-256 of a sequence of arrays' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).view(np.uint8).reshape(-1))
    return h.hexdigest()


__all__ = ["Placement", "is_split", "local_shard", "rows_digest", "shard_bounds"]
