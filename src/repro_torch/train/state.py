"""Train state + the adapter between model trees and Check-N-Run snapshots,
in PyTorch.

Conventions (repro-wide):
  * ``params = {"tables": {name: (rows, dim)}, "dense": {...nested...}}`` —
    ``tables`` are embedding tables trained with row-wise AdaGrad;
    everything else lives under ``dense``.
  * Tracked state is declared by ``TrackedSpec``s (1 unit = 1 row for an
    embedding table).
  * ``state.touched[name]`` is a bool vector of ``units`` per tracked spec,
    marked inside the train step (tracker.py) and replaced by a fresh one
    after each snapshot.

The snapshot a state produces is the reference's key for key
(``params['bot'][0]['w']``, ``opt['dense']['top'][2]['b']``, ``step``,
``rng``), so a checkpoint written by either package restores in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..core.snapshot import Snapshot, take_snapshot
from ..core.tracker import init_touched
from ..tree import flatten_with_path, keystr, map_with_path, tree_map


@dataclasses.dataclass(frozen=True)
class TrackedSpec:
    """Declares one incrementally-checkpointed parameter block."""

    path: Tuple[str, ...]        # into params, e.g. ("tables", "emb_3")
    units: int                   # tracked units (rows / (layer,expert) pairs)
    rows: int                    # rows of the 2-D checkpoint view
    dim: int                     # columns of the 2-D checkpoint view
    rowwise_aux: bool = True     # include per-row optimizer aux ((rows,) acc)

    @property
    def expansion(self) -> int:
        assert self.rows % self.units == 0
        return self.rows // self.units


def tree_get(tree, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree, path: Tuple[str, ...], value):
    if len(path) == 1:
        return {**tree, path[0]: value}
    return {**tree, path[0]: tree_set(tree[path[0]], path[1:], value)}


@dataclasses.dataclass
class TrainState:
    """``step`` is a host int. ``rng`` is the reference's key data, a
    ``uint32 (2,)`` host array: the DLRM step draws no random numbers, and
    the snapshot writes it where the reference's restore expects it."""

    step: int
    params: Any
    opt_state: Any
    touched: Dict[str, torch.Tensor]
    rng: np.ndarray


def rng_key_data(seed: int) -> np.ndarray:
    """The key data ``jax.random.key(seed)`` holds, as ``uint32 (2,)``."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def init_train_state(params, optimizer, specs: Dict[str, TrackedSpec],
                     rng: np.ndarray, device) -> TrainState:
    return TrainState(
        step=0,
        params=params,
        opt_state=optimizer.init(params),
        touched={name: init_touched(s.units, device) for name, s in specs.items()},
        rng=rng,
    )


def state_from_numpy(np_state: Mapping[str, Any], device) -> TrainState:
    """A port TrainState from the reference's, given as nested numpy arrays
    (``step``, ``params``, ``opt_state``, ``touched``, ``rng``): the tensors
    are copies on ``device``, so both packages can start a step from the
    same numbers."""
    to_t = lambda a: torch.tensor(np.asarray(a), device=device)
    return TrainState(
        step=int(np.asarray(np_state["step"])),
        params=tree_map(to_t, np_state["params"]),
        opt_state=tree_map(to_t, np_state["opt_state"]),
        touched={k: to_t(v) for k, v in np_state["touched"].items()},
        rng=np.asarray(np_state["rng"], dtype=np.uint32).copy())


# ------------------------------------------------------- snapshot adapters


def _flatten_dense(tree, prefix="") -> Dict[str, Any]:
    return {prefix + keystr(path): leaf
            for path, leaf in flatten_with_path(tree)}


def state_to_snapshot(state: TrainState, specs: Dict[str, TrackedSpec],
                      extra: Dict[str, Any]) -> Snapshot:
    """Build the Check-N-Run snapshot view of a train state (the host copy
    happens in take_snapshot — here we only slice the tree)."""
    tables: Dict[str, torch.Tensor] = {}
    row_state: Dict[str, Dict[str, torch.Tensor]] = {}
    touched: Dict[str, torch.Tensor] = {}
    for name, spec in specs.items():
        tables[name] = tree_get(state.params, spec.path).reshape(spec.rows, spec.dim)
        aux: Dict[str, torch.Tensor] = {}
        opt_leaf = _find_opt_leaf(state.opt_state, spec.path)
        if opt_leaf is not None:
            if tuple(opt_leaf.shape) == (spec.rows,):
                aux["opt_acc"] = opt_leaf
            else:
                aux["opt_acc2d"] = (opt_leaf.reshape(spec.rows, -1)
                                    if opt_leaf.dim() else opt_leaf)
        row_state[name] = aux
        mask = state.touched[name]
        if spec.expansion > 1:
            mask = mask.repeat_interleave(spec.expansion)
        touched[name] = mask

    dense_params = _flatten_dense(state.params["dense"], prefix="params")
    # exclude tracked dense paths from the dense dump
    for spec in specs.values():
        if spec.path[0] == "dense":
            dense_params.pop("params" + keystr(spec.path[1:]), None)
    dense_opt = _flatten_dense(_prune_tracked_opt(state.opt_state, specs),
                               prefix="opt")
    dense_all = {**dense_params, **dense_opt,
                 "step": np.asarray(state.step, dtype=np.int32),
                 "rng": np.asarray(state.rng, dtype=np.uint32)}

    return take_snapshot(
        step=int(state.step),
        tables=tables, row_state=row_state, touched=touched,
        dense=dense_all, extra=extra)


def _find_opt_leaf(opt_state, path: Tuple[str, ...]):
    """Locate the optimizer accumulator matching a tracked param path
    (split_optimizer state mirrors the params structure under the same
    keys: tables → row-wise acc (rows,))."""
    try:
        return tree_get(opt_state, path)
    except (KeyError, TypeError):
        return None


def _prune_tracked_opt(opt_state, specs: Dict[str, TrackedSpec]):
    pruned = opt_state
    for spec in specs.values():
        try:
            sub = tree_get(pruned, spec.path[:-1])
            if spec.path[-1] in sub:
                new_sub = {k: v for k, v in sub.items() if k != spec.path[-1]}
                pruned = tree_set(pruned, spec.path[:-1], new_sub) if len(spec.path) > 1 \
                    else {k: v for k, v in pruned.items() if k != spec.path[0]}
        except (KeyError, TypeError):
            continue
    return pruned


def restore_train_state(template: TrainState, restored,
                        specs: Dict[str, TrackedSpec]) -> TrainState:
    """Rebuild a TrainState from a RestoredState (host arrays), matching the
    template's structure, dtypes and devices."""
    params = template.params
    opt = template.opt_state
    for name, spec in specs.items():
        orig = tree_get(params, spec.path)
        params = tree_set(params, spec.path, _like(
            restored.tables[name].reshape(tuple(orig.shape)), orig))
        aux = restored.row_state.get(name, {})
        opt_leaf = _find_opt_leaf(opt, spec.path)
        if opt_leaf is not None and "opt_acc" in aux:
            opt = tree_set(opt, spec.path, _like(aux["opt_acc"], opt_leaf))
        elif opt_leaf is not None and "opt_acc2d" in aux:
            opt = tree_set(opt, spec.path, _like(
                aux["opt_acc2d"].reshape(tuple(opt_leaf.shape)), opt_leaf))

    dense_flat = dict(restored.dense)
    params = {**params, "dense": _restore_dense(
        params["dense"], {k[len("params"):]: v for k, v in dense_flat.items()
                          if k.startswith("params")})}
    opt = _restore_dense(opt, {k[len("opt"):]: v for k, v in dense_flat.items()
                               if k.startswith("opt")})
    step = int(dense_flat["step"]) if "step" in dense_flat else int(restored.step)
    rng = (np.asarray(dense_flat["rng"], dtype=np.uint32).copy()
           if "rng" in dense_flat else template.rng)
    touched = {name: torch.zeros_like(m) for name, m in template.touched.items()}
    return TrainState(step=step, params=params, opt_state=opt,
                      touched=touched, rng=rng)


def splice_shard_state(state: TrainState, restored,
                       specs: Dict[str, TrackedSpec]) -> TrainState:
    """Overwrite ONLY one recovered shard's rows of a live TrainState.

    ``restored`` is a ``CheckNRunManager.restore_part`` result: shard-sized
    table/aux arrays plus ``extra["shard"]["row_range"]`` naming each
    table's ``[lo, hi)``. Every row outside the ranges — including all of
    the dense params/opt and the step/rng — keeps its LIVE value: this is
    the CPR staleness model (only the failed shard rolls back to the
    checkpoint) and the exact-mode shard splice (where the caller first
    rebuilt the survivors from the boundary snapshot, so "live" already
    means "at the committed step").

    A new TrainState comes back and ``state`` is left as it was: a table,
    accumulator or touched mask is cloned before rows are written into it
    (the reference's functional ``.at[lo:hi].set``), so tensors the caller
    still holds keep their live values.

    The spliced rows' touched bits are re-fenced to False: they now hold
    the last committed values, so a since-last-commit touched claim for
    them is stale (the manager-side mask twin is
    ``CheckNRunManager.refence_shard``). For coarse-tracked specs
    (``expansion > 1``) only units FULLY COVERED by the range are
    cleared: a resharded recovery's ranges need not be unit-aligned, and
    a partial unit still carries live rows whose touched claim must
    survive (re-storing an already-committed row is merely redundant;
    losing a legitimate claim would drop data from the next increment).
    """
    shard = (restored.extra or {}).get("shard") or {}
    ranges = shard.get("row_range") or {}
    params = state.params
    opt = state.opt_state
    touched = dict(state.touched)
    for name, spec in specs.items():
        if name not in restored.tables or name not in ranges:
            continue
        lo, hi = ranges[name]
        if lo >= hi:
            continue  # an empty shard: nothing to overwrite or re-fence
        params = tree_set(params, spec.path, _spliced(
            tree_get(params, spec.path), spec.rows, lo, hi,
            restored.tables[name]))
        aux = restored.row_state.get(name, {})
        opt_leaf = _find_opt_leaf(opt, spec.path)
        if opt_leaf is not None and "opt_acc" in aux:
            opt = tree_set(opt, spec.path, _spliced(
                opt_leaf, spec.rows, lo, hi, aux["opt_acc"]))
        elif opt_leaf is not None and "opt_acc2d" in aux:
            opt = tree_set(opt, spec.path, _spliced(
                opt_leaf, spec.rows, lo, hi, aux["opt_acc2d"]))
        ulo = -(-lo // spec.expansion)  # ceil — first fully-covered unit
        uhi = hi // spec.expansion      # floor — one past the last
        if ulo < uhi:
            mask = touched[name].clone()
            mask[ulo:uhi] = False
            touched[name] = mask
    return TrainState(step=state.step, params=params, opt_state=opt,
                      touched=touched, rng=state.rng)


def _spliced(leaf: torch.Tensor, rows: int, lo: int, hi: int,
             arr: np.ndarray) -> torch.Tensor:
    """A copy of ``leaf`` whose rows ``[lo, hi)`` of its ``(rows, -1)`` view
    hold host ``arr`` (cast to the leaf's dtype, on its device)."""
    out = leaf.clone(memory_format=torch.contiguous_format)
    flat = out.view(rows, -1)
    flat[lo:hi] = torch.from_numpy(np.ascontiguousarray(arr)).reshape(
        hi - lo, flat.shape[1]).to(device=out.device, dtype=out.dtype)
    return out


def _like(arr: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    """A private tensor copy of host ``arr`` with ``leaf``'s dtype and device."""
    return torch.tensor(np.asarray(arr), device=leaf.device).to(leaf.dtype)


def _restore_dense(tree, flat: Dict[str, np.ndarray]):
    """Write flattened host arrays back into the tree by keystr match."""
    def leaf(path, t):
        key = keystr(path)
        if key not in flat:
            return t
        return _like(np.asarray(flat[key]).reshape(tuple(t.shape)), t)
    return map_with_path(leaf, tree)
