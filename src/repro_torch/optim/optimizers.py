"""Pure-function optimizers over parameter trees, in PyTorch.

The DLRM-standard split (paper §2.2): embedding tables use **row-wise
AdaGrad** (one accumulator per row — the per-row state is checkpointed
incrementally together with its rows), dense parameters use AdaGrad/AdamW.

An ``Optimizer`` is an (init, update) pair over a tree; ``update`` returns
*additive* updates and allocates new tensors, as the reference's do. The
sparse DLRM step updates the tables in place instead (see
``models/dlrm.py``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..tree import flatten_with_path, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (updates, state)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params):
        del params
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), state
        new_m = tree_map(lambda m, g: momentum * m + g, state, grads)
        return tree_map(lambda m: -lr * m, new_m), new_m

    return Optimizer(init, update)


def adagrad(lr: float, eps: float = 1e-8) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params):
        del params
        new_acc = tree_map(lambda a, g: a + torch.square(g), state, grads)
        upd = tree_map(lambda g, a: -lr * g / (torch.sqrt(a) + eps),
                       grads, new_acc)
        return upd, new_acc

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with the reference's arithmetic: ``count`` an int32 scalar,
    the bias corrections ``1 - b ** count`` in f32, and the weight decay
    added to the step before it is scaled by ``-lr``."""

    def init(params):
        leaves = [p for _, p in flatten_with_path(params)]
        device = leaves[0].device if leaves else None
        zeros = lambda: tree_map(torch.zeros_like, params)
        return dict(mu=zeros(), nu=zeros(),
                    count=torch.zeros((), dtype=torch.int32, device=device))

    def update(grads, state, params):
        count = state["count"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g), state["nu"], grads)
        n = count.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=n.device), n)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=n.device), n)

        def leaf(m, v, p):
            step = m / c1 / (torch.sqrt(v / c2) + eps)
            return -lr * (step + weight_decay * p)

        upd = tree_map(leaf, mu, nu, params)
        return upd, dict(mu=mu, nu=nu, count=count)

    return Optimizer(init, update)


def rowwise_adagrad(lr: float, eps: float = 1e-8) -> Optimizer:
    """Row-wise AdaGrad for 2-D embedding tables (FBGEMM/DLRM standard).

    State per table: one f32 accumulator per ROW — the per-row optimizer
    state that Check-N-Run checkpoints incrementally alongside the row.
    Untouched rows receive zero gradient, so their accumulator (and row) are
    bit-identical across an interval — exactly the sparsity the incremental
    checkpoint exploits.
    """

    def init(params):
        return tree_map(lambda t: torch.zeros((t.shape[0],), dtype=torch.float32,
                                              device=t.device), params)

    def update(grads, state, params):
        del params
        new_state = tree_map(
            lambda g, a: a + torch.mean(torch.square(g),
                                        dim=tuple(range(1, g.dim()))),
            grads, state)

        def upd(g, new_a):
            shape = (-1,) + (1,) * (g.dim() - 1)
            return -lr * g / (torch.sqrt(new_a).reshape(shape) + eps)

        return tree_map(upd, grads, new_state), new_state

    return Optimizer(init, update)


def split_optimizer(table_opt: Optimizer, dense_opt: Optimizer) -> Optimizer:
    """Tables → table_opt, everything else → dense_opt (repro convention:
    ``params = {"tables": {...}, "dense": {...}}``)."""

    def init(params):
        return dict(tables=table_opt.init(params["tables"]),
                    dense=dense_opt.init(params["dense"]))

    def update(grads, state, params):
        t_upd, t_state = table_opt.update(grads["tables"], state["tables"], params["tables"])
        d_upd, d_state = dense_opt.update(grads["dense"], state["dense"], params["dense"])
        return dict(tables=t_upd, dense=d_upd), dict(tables=t_state, dense=d_state)

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
