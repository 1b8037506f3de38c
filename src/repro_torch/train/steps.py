"""The generic train step: autograd over a model's loss, in PyTorch."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..optim.optimizers import Optimizer, apply_updates
from ..tree import map_with_path, tree_map
from .state import TrainState


def sum_grads(grads, group, only: Optional[Callable] = None):
    """The sum over ``group``'s ranks of each gradient in the tree: one
    all-reduce of every leaf flattened into one f32 buffer, split back into
    the leaves' shapes and dtypes. ``only(path)`` picks the leaves summed
    (by their path in the tree); the others come back as they are."""
    from ..dist.group_ops import all_reduce

    leaves = []

    def pick(path, g):
        if only is None or only(path):
            leaves.append(g)

    map_with_path(pick, grads)
    if not leaves:
        return grads
    flat = all_reduce(torch.cat([g.reshape(-1).to(torch.float32) for g in leaves]), group)
    parts = iter(torch.split(flat, [g.numel() for g in leaves]))

    def put(path, g):
        if only is None or only(path):
            return next(parts).reshape(g.shape).to(g.dtype)
        return g

    return map_with_path(put, grads)


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    n_micro: int = 1, grad_group=None,
                    summed: Optional[Callable] = None) -> Callable:
    """loss_fn(params, batch) -> (loss, aux); aux may carry 'touched' masks
    which are OR-ed into the state's incremental-checkpoint tracker.

    ``n_micro > 1`` accumulates gradients over micro-batches, as the
    reference's scan does: every batch array is split along its first axis
    (the shared negatives too), the f32 gradients are summed and divided by
    ``n_micro``, the loss and the other aux are the means over the
    micro-batches, and the touched masks are OR-ed. Activation memory
    scales with 1/n_micro; the gradient buffer is one params-sized f32
    tree. The update allocates new params, as the reference's does.

    ``grad_group``: the step of one rank of a mesh whose ranks each
    compute one global loss: the ranks' gradients are summed over the
    group (``sum_grads``) before the update, so every rank applies the same
    one. The sharded DimeNet sums every leaf over its node axes' group; a
    cell with row-sharded tables (``models.embedding.ShardedLookup``) sums
    only the replicated leaves (``summed(path)`` true), over ``data``: a
    table shard's gradient is already whole, from every data shard's ids,
    and its rows are its rank's alone.

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
            if grad_group is not None:
                grads = sum_grads(grads, grad_group, summed)
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

