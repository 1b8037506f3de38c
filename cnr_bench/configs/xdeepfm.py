"""Plain reference of the xdeepfm configuration (``xdeepfm.json``):
xDeepFM's forward pass and loss in float32, in plain PyTorch, from the
published description (arXiv:1803.05170): a linear term (one weight a
field's id, the ``lin_*`` tables), a compressed interaction network over
the field vectors (layer k: the outer product of x_{k-1} and x_0 over the
fields, compressed by W_k, summed over the embedding dimension into the
output), a deep MLP over the concatenated field vectors, a bias, binary
cross-entropy with logits.

``lp`` rounds every operand of a product to a lower precision (the
identity for the reference; the control passes an fp8 rounding). Imports
nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def param_specs(cfg: dict) -> List[Tuple[Tuple, Tuple[int, ...], float]]:
    """``(path, shape, scale)`` of every parameter, in the program's tree
    paths: ``emb_*`` ``N(0, 1/dim)``, ``lin_*`` ``N(0, 1)``, CIN weights
    (H_k, H_{k-1}, F) ``N(0, 1/H_k)``, ``cin_out`` and the MLP's weights
    ``N(0, 1/fan_in)``, biases zero."""
    D, F = cfg["embed_dim"], len(cfg["vocab_sizes"])
    specs = [(("tables", f"emb_{f}"), (int(v), D), 1.0 / math.sqrt(D))
             for f, v in enumerate(cfg["vocab_sizes"])]
    specs += [(("tables", f"lin_{f}"), (int(v), 1), 1.0)
              for f, v in enumerate(cfg["vocab_sizes"])]
    h_prev = F
    for k, h in enumerate(cfg["cin_layers"]):
        specs.append((("dense", "cin", k), (h, h_prev, F), 1.0 / math.sqrt(h)))
        h_prev = h
    n_cin = sum(cfg["cin_layers"])
    specs.append((("dense", "cin_out"), (n_cin, 1), 1.0 / math.sqrt(n_cin)))
    dims = [F * D] + list(cfg["mlp"]) + [1]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        specs.append((("dense", "deep", i, "w"), (a, b), 1.0 / math.sqrt(a)))
        specs.append((("dense", "deep", i, "b"), (b,), 0.0))
    specs.append((("dense", "bias"), (), 0.0))
    return specs


def tables(cfg: dict) -> List[Tuple[str, int]]:
    """``(table name, sparse field)`` of every embedding table."""
    F = len(cfg["vocab_sizes"])
    return [(f"emb_{f}", f) for f in range(F)] + [(f"lin_{f}", f) for f in range(F)]


def bce_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.clamp(logits, min=0) - logits * labels
                     + torch.log1p(torch.exp(-torch.abs(logits))))


def loss_sum(p: Dict, rows: Dict[str, torch.Tensor], batch: Dict, cfg: dict, lp):
    """The sum over ``batch``'s examples of the loss. ``rows[name]`` holds
    each example's rows of the table, (B, H, D)."""
    F = len(cfg["vocab_sizes"])
    emb = torch.stack([rows[f"emb_{f}"].sum(dim=1) for f in range(F)], dim=1)   # (B, F, D)
    lin = torch.stack([rows[f"lin_{f}"].sum(dim=1)[:, 0] for f in range(F)], dim=1)
    B, _, D = emb.shape
    x0 = lp(emb)
    xk = x0
    pooled = []
    for k in range(len(cfg["cin_layers"])):
        w = p[("dense", "cin", k)]                                  # (H, Hp, F)
        z = (xk[:, :, None, :] * x0[:, None, :, :]).reshape(B, -1, D)   # (B, Hp*F, D)
        xk = lp(w).reshape(w.shape[0], -1) @ lp(z)                  # (B, H, D)
        pooled.append(xk.sum(dim=-1))
        xk = lp(xk)
    cin_term = (lp(torch.cat(pooled, dim=-1)) @ lp(p[("dense", "cin_out")]))[:, 0]
    h = emb.reshape(B, F * D)
    n = len(cfg["mlp"]) + 1
    for i in range(n):
        h = lp(h) @ lp(p[("dense", "deep", i, "w")]) + p[("dense", "deep", i, "b")]
        if i < n - 1:
            h = torch.relu(h)
    logits = lin.sum(dim=-1) + cin_term + h[:, 0] + p[("dense", "bias")]
    return bce_sum(logits, batch["label"])


# Frozen copy of src/repro_torch/models/xdeepfm.py::dense_flops (called there
# through configs/_families.py::recsys_dense_flops).
def dense_flops(cfg: dict, batch: int) -> float:
    """Analytic forward FLOPs of ``batch`` examples: the CIN's outer
    products and compressions, and the MLP."""
    F, D = len(cfg["vocab_sizes"]), cfg["embed_dim"]
    f = 0.0
    h_prev = F
    for h in cfg["cin_layers"]:
        f += 2 * h_prev * F * D
        f += 2 * h * h_prev * F * D
        h_prev = h
    dims = [F * D] + list(cfg["mlp"]) + [1]
    f += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    return float(f) * batch
