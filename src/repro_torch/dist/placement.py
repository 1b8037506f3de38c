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

For the LM train cells under ``lm_rules``: the leaves whose heads, kv
heads, ff, vocabulary or experts divide ``model`` split over it (``wq``,
``bq``, ``wo``, ``wk``, ``wv``, ``bk``, ``bv``, ``w1``, ``wg``, ``w2``, MLA's
``w_uq``, ``w_uk``, ``w_uv``, ``w_o``, the three expert blocks, ``w_out``'s
vocabulary columns), with their accumulators, and replicated over
``data``; ``tok_emb``'s rows over (data, model) where they divide the mesh,
with its row-wise accumulator and touched mask; the norm gains, the
router, MLA's latent projections and every leaf whose axis does not divide
replicated; the tokens and labels split over ``data``. ``init_state`` makes
each leaf in turn and keeps the rank's block, so no rank holds the whole
state. An expert block's tracked rows (its (L·E·rows, dim) view) are one
range a layer on a rank (``row_ranges``), which a restore reads.

Under micro-batching (bert4rec's full batch in 4) a rank's data shard is
its slice of each micro-batch in turn, so the step's micro-batch i is the
rank's part of the reference's micro-batch i, whose masked mean divides by
that micro-batch's global count.

``gather_state`` brings the split leaves (row-sharded tables, the LM's
model-sharded dense leaves and expert blocks) to rank 0's host over the
group for a save, each block once, so rank 0 writes the one chain a single
process would write for the whole state.
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
        self._shapes = None

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

    def init_state(self, seed: int = 0):
        """This rank's part of ``bundle.make_state(seed)``, made without the
        whole: where the bundle makes its params leaf by leaf
        (``init_kept``) each is cut to the rank's block as it is made, the
        optimizer state is made from the blocks and the touched masks are
        cut; otherwise the whole state is made and cut."""
        from ..train.state import init_train_state, rng_key_data

        b = self.bundle
        if b.init_kept is None:
            return self.local_state(b.make_state(seed))
        specs = {keystr(p): s for p, s in flatten_with_path(self.specs.params)}
        gen = torch.Generator(device=b.device)
        gen.manual_seed(seed)
        params = b.init_kept(gen, lambda path, x: local_shard(x, specs[keystr(path)],
                                                              self.mesh))
        state = init_train_state(params, b.optimizer, b.tracked, rng_key_data(1), b.device)
        return dataclasses.replace(state, touched={
            k: local_shard(m, self.specs.touched[k], self.mesh) for k, m in state.touched.items()})

    def row_ranges(self, name: str, mesh=None) -> List[tuple]:
        """The ``[lo, hi)`` ranges of tracked table ``name``'s (rows, dim)
        checkpoint view that the rank at ``mesh``'s coordinates (this
        rank's by default) holds, in order: one for a row-sharded table,
        one a layer for an expert block split over ``model``, the whole
        for a replicated one."""
        mesh = mesh or self.mesh
        spec = self.bundle.tracked[name]
        leaf_spec = _at(self.specs.params, spec.path)
        if self._shapes is None:
            self._shapes = self.bundle.params_shapes()
        shape = _at(self._shapes, spec.path).shape
        bounds = shard_bounds(shape, leaf_spec, mesh)
        # the view's rows run over the leading dims whose product is rows
        lead, n = 0, 1
        while n < spec.rows:
            n *= shape[lead]
            lead += 1
        if n != spec.rows or any(b != (0, d) for b, d in zip(bounds[lead:], shape[lead:])):
            raise ValueError(f"{name}: a block of {tuple(shape)} by {leaf_spec} is not "
                             f"whole rows of its ({spec.rows}, {spec.dim}) view")
        ranges = [(0, 1)]
        for (lo, hi), size in zip(bounds[:lead], shape[:lead]):
            if (lo, hi) == (0, size):
                ranges = [(a * size, b * size) for a, b in ranges]
            else:
                ranges = [(p * size + lo, p * size + hi) for a, b in ranges
                          for p in range(a, b)]
            ranges = _merged(ranges)
        return [[lo, hi] for lo, hi in ranges]

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
        rank 0's host over the mesh's group, one ``gather`` for each set of
        axes a spec names and each dtype, from the ranks at index 0 on the
        other axes (a leaf split over ``model`` alone is the same on every
        ``data`` index: one copy of each block travels). Rank 0 gets the
        whole state (host tensors), the others None."""
        import torch.distributed as dist

        from ..launch.mesh import Mesh

        mesh, n = self.mesh, self.mesh.size
        me = dist.get_rank(mesh.group)
        # group rank r sits at position r of the mesh, the last axis fastest
        ranks = [Mesh(mesh.shape, coords=dict(zip(mesh.shape, np.unravel_index(
            r, tuple(mesh.shape.values()))))) for r in range(n)]
        by_key: Dict[tuple, list] = {}
        for item in self._split_leaves(state):
            axes = frozenset(a for e in item[3] for a in _axes(e))
            by_key.setdefault((axes, _wire_dtype(item[2].dtype)), []).append(item)
        whole = {}
        for (axes, dtype), items in by_key.items():
            outside = [a for a in mesh.shape if a not in axes]
            if any(mesh.axis_index(a) for a in outside):
                continue
            holders = [m for m in ranks if not any(m.coords[a] for a in outside)]
            group = mesh.group if not outside else mesh.group_for(axes)
            mine = torch.cat([leaf.detach().reshape(-1).to("cpu").to(dtype)
                              for _, _, leaf, _ in items])
            parts = [torch.empty_like(mine) for _ in holders] if me == 0 else None
            dist.gather(mine, parts, dst=dist.get_global_rank(mesh.group, 0), group=group)
            if me != 0:
                continue
            for rank_mesh, buf in zip(holders, parts):
                for (tag, p, leaf, spec), chunk in zip(
                        items, torch.split(buf, [x[2].numel() for x in items])):
                    key = (tag, keystr(p))
                    if key not in whole:
                        whole[key] = torch.empty(_whole_shape(leaf.shape, spec, mesh),
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
        """This rank's bytes of the split leaves."""
        return sum(leaf.numel() * leaf.element_size() for *_, leaf, _ in self._split_leaves(state))

    def gathered_bytes(self, state) -> int:
        """The bytes a save gathers to rank 0: every split leaf whole."""
        return sum(math.prod(_whole_shape(leaf.shape, spec, self.mesh)) * leaf.element_size()
                   for *_, leaf, spec in self._split_leaves(state))


def _merged(ranges):
    """Adjacent ``[lo, hi)`` ranges, in order, joined."""
    out = []
    for lo, hi in ranges:
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


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
