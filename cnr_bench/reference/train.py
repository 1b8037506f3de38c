"""Plain reference of a training cell's first steps: the configuration's
plain loss (``configs/<name>.py``), its gradients by autograd in float32
with TF32 off, row-wise AdaGrad on the tables and AdaGrad on the rest, in
plain PyTorch, from the same weights (``weights.make_weights``) and the
same batches the program got. Imports nothing of the program.

The batch runs in blocks of rows (the loss is a mean, so the blocks'
gradients add up), so a step fits beside nothing else on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..weights import make_weights


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 (saturated at ±448), its gradient
    passed through: the control's precision."""
    q = x.detach().clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(x.dtype)
    return x + (q - x.detach())


def reference_steps(model, cfg: dict, seed: int, batches: Sequence[Dict[str, np.ndarray]],
                    device, lp: Callable = identity, block_rows: int = 8192,
                    lr: float = 0.01, eps: float = 1e-8, half_batch: bool = False) -> dict:
    """``len(batches)`` steps from the seed's weights. → ``losses`` (one a
    step), ``grad`` (each leaf's first gradient's norm, by path) and
    ``change`` (each leaf's change after the last step, its norm)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    specs = model.param_specs(cfg)
    w = make_weights(specs, seed, device)
    tabs = model.tables(cfg)
    dense_paths = [p for p, _, _ in specs if p[0] != "tables"]
    acc = {p: (torch.zeros(w[p].shape[0], device=device) if p[0] == "tables"
               else torch.zeros_like(w[p])) for p, _, _ in specs}
    losses: List[float] = []
    grad = None
    for step, b in enumerate(batches):
        ids = torch.from_numpy(np.ascontiguousarray(b["sparse_ids"])).to(device).to(torch.int64)
        label = torch.from_numpy(b["label"]).to(device)
        dense_x = torch.from_numpy(b["dense"]).to(device) if "dense" in b else None
        B = ids.shape[0] // 2 if half_batch else ids.shape[0]
        g = {p: torch.zeros_like(w[p]) for p, _, _ in specs}
        total = 0.0
        for lo in range(0, B, block_rows):
            hi = min(B, lo + block_rows)
            dp = {p: w[p].detach().requires_grad_(True) for p in dense_paths}
            rows = {name: w[("tables", name)][ids[lo:hi, f]].detach().requires_grad_(True)
                    for name, f in tabs}
            blk = dict(label=label[lo:hi])
            if dense_x is not None:
                blk["dense"] = dense_x[lo:hi]
            loss = model.loss_sum(dp, rows, blk, cfg, lp) / B
            gs = torch.autograd.grad(loss, list(dp.values()) + list(rows.values()))
            with torch.no_grad():
                for p, gp in zip(dense_paths, gs[:len(dense_paths)]):
                    g[p] += gp
                for (name, f), gr in zip(tabs, gs[len(dense_paths):]):
                    g[("tables", name)].index_add_(0, ids[lo:hi, f].reshape(-1),
                                                   gr.reshape(-1, gr.shape[-1]))
            total += float(loss.detach())
            del dp, rows, gs, loss
        losses.append(total)
        with torch.no_grad():
            if grad is None:
                grad = {p: float(torch.linalg.vector_norm(g[p])) for p in g}
            for p, gp in g.items():
                if p[0] == "tables":
                    acc[p] += torch.mean(torch.square(gp), dim=1)
                    w[p] -= lr * gp / (torch.sqrt(acc[p])[:, None] + eps)
                else:
                    acc[p] += torch.square(gp)
                    w[p] -= lr * gp / (torch.sqrt(acc[p]) + eps)
        del g
    w0 = make_weights(specs, seed, device)
    change = {p: float(torch.linalg.vector_norm(w[p] - w0[p])) for p in w}
    del w, w0, acc
    return dict(losses=losses, grad=grad, change=change)


STEP_CHECKS = ("loss_gap", "grad_gap", "grad_gap_median", "change_gap")


def _moving(ref: dict):
    """Leaves whose first reference gradient is at least a thousandth of
    the median leaf's."""
    med = float(np.median(list(ref["grad"].values())))
    return [p for p in ref["grad"] if ref["grad"][p] >= 1e-3 * med]


def _leaf_gaps(prog: dict, ref: dict, key: str, paths) -> Dict:
    med = float(np.median([ref[key][p] for p in paths]))
    return {p: abs(prog[key][p] - ref[key][p]) / max(ref[key][p], med, 1e-30) for p in paths}


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The step's numbers compared: ``loss_gap``, the relative gap of the
    first step's loss (the later steps' losses swing from seed to seed:
    AdaGrad's first step from a zero accumulator moves every weight by
    ``lr`` in its gradient's sign, so a rounding that flips a sign moves
    the next loss; ``detail`` gives every step's); ``grad_gap`` and
    ``change_gap``, the worst leaf's gap of norms, against the larger of
    that leaf's reference norm and the median leaf's; ``grad_gap_median``,
    the median leaf's gradient gap, steady from seed to seed where one
    small leaf's round-off sets the worst. A configuration compares those
    that its ``limits`` name. Leaves whose first
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone under AdaGrad: they are left out of ``change_gap``."""
    loss_gap = abs(prog["losses"][0] - ref["losses"][0]) / max(abs(ref["losses"][0]), 1e-30)
    grad = list(_leaf_gaps(prog, ref, "grad", list(ref["grad"])).values())
    return dict(loss_gap=loss_gap, grad_gap=max(grad), grad_gap_median=float(np.median(grad)),
                change_gap=max(_leaf_gaps(prog, ref, "change", _moving(ref)).values()))


def detail(prog: dict, ref: dict) -> dict:
    """What the gaps are made of: each step's loss gap, and the three
    leaves with the largest gradient and change gaps."""
    top = lambda d: [[g, str(p)] for p, g in sorted(d.items(), key=lambda kv: -kv[1])[:3]]
    return dict(loss_gaps=[abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])],
                losses=ref["losses"], grad=top(_leaf_gaps(prog, ref, "grad", list(ref["grad"]))),
                change=top(_leaf_gaps(prog, ref, "change", _moving(ref))))
