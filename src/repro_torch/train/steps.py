"""The generic train step: autograd over a model's loss, in PyTorch."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..optim.optimizers import Optimizer, apply_updates
from ..tree import flatten_with_path, map_with_path, tree_map
from .state import TrainState, tree_get


def sum_grads(grads, group):
    """The sum over ``group``'s ranks of each gradient in the tree
    (``sum_grads_by`` with one group for every leaf)."""
    return sum_grads_by(grads, lambda path: group)


def sum_grads_by(grads, group_of: Callable):
    """Each gradient summed over ``group_of(path)``'s ranks (None: left as
    it is): one all-reduce a group, of its leaves flattened into one f32
    buffer and split back into their shapes and dtypes; the groups in the
    order their first leaf comes in the tree, so every rank issues the
    same calls."""
    from ..dist.group_ops import all_reduce

    flat = flatten_with_path(grads)
    groups, picked = [], {}
    for path, g in flat:
        group = group_of(path)
        if group is None:
            continue
        if not any(group is x for x in groups):
            groups.append(group)
        picked[path] = group
    summed = {}
    for group in groups:
        leaves = [(path, g) for path, g in flat if picked.get(path) is group]
        buf = all_reduce(torch.cat([g.reshape(-1).to(torch.float32) for _, g in leaves]), group)
        for (path, g), part in zip(leaves, torch.split(buf, [g.numel() for _, g in leaves])):
            summed[path] = part.reshape(g.shape).to(g.dtype)
    return map_with_path(lambda path, g: summed.get(path, g), grads)


def _nested(path, leaf, skeleton):
    """A tree of ``skeleton``'s top-level keys holding ``leaf`` at ``path``
    alone."""
    tree = {k: {} for k in skeleton}
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = leaf
    return tree


def update_in_place(optimizer: Optimizer, box: list, state: TrainState) -> None:
    """``optimizer``'s update written into ``state``'s own parameters and
    optimizer state, one leaf at a time: each leaf's update on a tree of
    that leaf alone, its new accumulator copied in and its step added to
    the parameter (``p + u``, as ``apply_updates``), its gradient then
    freed. ``box`` holds the gradients' tree and is emptied, so the caller
    keeps no reference to them. The numbers are the functional update's;
    at most one leaf's new values exist beside the state. For optimizers
    whose update is elementwise within a leaf and whose state mirrors the
    params (adagrad, row-wise adagrad, and ``split_optimizer`` of them)."""
    flat = flatten_with_path(box.pop())
    for i, (path, g) in enumerate(flat):
        p, a = tree_get(state.params, path), tree_get(state.opt_state, path)
        upd, new = optimizer.update(_nested(path, g, state.params),
                                    _nested(path, a, state.opt_state),
                                    _nested(path, p, state.params))
        a.copy_(tree_get(new, path))
        p.add_(tree_get(upd, path).to(p.dtype))
        flat[i] = None
        del g, upd, new


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    n_micro: int = 1, grad_groups: Optional[Callable] = None,
                    in_place: bool = False) -> Callable:
    """loss_fn(params, batch) -> (loss, aux); aux may carry 'touched' masks
    which are OR-ed into the state's incremental-checkpoint tracker.

    ``n_micro > 1`` accumulates gradients over micro-batches, as the
    reference's scan does: every batch array is split along its first axis
    (the shared negatives too), the f32 gradients are summed and divided by
    ``n_micro``, the loss and the other aux are the means over the
    micro-batches, and the touched masks are OR-ed. Activation memory
    scales with 1/n_micro; the gradient buffer is one params-sized f32
    tree. The update allocates new params, as the reference's does.

    ``grad_groups(path)``: the step of one rank of a mesh whose ranks each
    compute one global loss: each leaf's gradient is summed over the group
    it names (``sum_grads_by``; None: not summed) before the update, so
    every rank that holds the leaf applies the same one. The sharded
    DimeNet sums every leaf over its node axes' group; a cell with
    row-sharded tables (``models.embedding.ShardedLookup``) sums only the
    replicated leaves, over ``data``: a table shard's gradient is already
    whole, from every data shard's ids, and its rows are its rank's alone;
    the LM's tensor-parallel step sums each leaf over the ranks that hold
    other parts of its gradient (``configs._families.lm_grad_axes``).

    ``in_place`` updates the state passed in (``update_in_place``): a rank
    of an LM cell on a mesh then holds its blocks, their accumulators and
    at most their gradients, three copies where the functional update holds
    six at once. The functional update stays the default: its callers may
    keep the state they pass in (a traced extra step whose state the run
    then goes on from, a one-process step on a state whose slices a mesh's
    ranks hold, a check that a step changed a leaf).

    Under micro-batching on a mesh the batch's data-sharded arrays hold
    this rank's slice of each micro-batch in turn
    (``dist.placement.Placement.local_batch``), so micro-batch i here is
    the rank's part of the reference's micro-batch i."""

    def grads_of(params, batch):
        leaves = []

        def track(t):
            leaves.append(t.detach().requires_grad_(True))
            return leaves[-1]

        loss, aux = loss_fn(tree_map(track, params), batch)
        grads = iter(torch.autograd.grad(loss, leaves))
        return loss.detach(), aux, tree_map(lambda _: next(grads), params)

    def train_step(state: TrainState, batch):
        if n_micro == 1:
            loss, aux, grads = grads_of(state.params, batch)
            touched_new = aux.get("touched", {})
            metrics = {k: v.detach() for k, v in aux.items() if k != "touched"}
        else:
            micro = {k: v.reshape((n_micro, v.shape[0] // n_micro) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads, loss, touched_new, sums = None, 0.0, {}, {}
            for i in range(n_micro):
                l_i, aux, g = grads_of(state.params, {k: v[i] for k, v in micro.items()})
                grads = g if grads is None else tree_map(torch.add, grads, g)
                loss = loss + l_i
                for k, m in aux.get("touched", {}).items():
                    touched_new[k] = m if k not in touched_new else touched_new[k] | m
                for k, v in aux.items():
                    if k != "touched":
                        sums[k] = v.detach() + sums.get(k, 0.0)
            grads = tree_map(lambda g: g / n_micro, grads)
            loss = loss / n_micro
            metrics = {k: v / n_micro for k, v in sums.items()}

        with torch.no_grad():
            if grad_groups is not None:
                grads = sum_grads_by(grads, grad_groups)
            if in_place:
                box = [grads]
                del grads
                update_in_place(optimizer, box, state)
                params, opt_state = state.params, state.opt_state
            else:
                updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
                params = apply_updates(state.params, updates)
        touched = dict(state.touched)
        for name, mask in touched_new.items():
            if name in touched:
                touched[name] = touched[name] | mask
        metrics["loss"] = loss
        new_state = TrainState(step=state.step + 1, params=params,
                               opt_state=opt_state, touched=touched,
                               rng=state.rng)
        return new_state, metrics

    train_step.n_micro = n_micro
    return train_step

