"""Plain reference of the dlrm-rm2 configuration (``dlrm-rm2.json``):
DLRM's forward pass and loss in float32, in plain PyTorch, from the
published description (arXiv:1906.00091): a bottom MLP over the dense
features, one embedding row a sparse field (the bag summed), the pairwise
dots of the bottom MLP's output and the field vectors, a top MLP over
``[bottom, dots]``, binary cross-entropy with logits.

``lp`` rounds every operand of a product to a lower precision (the
identity for the reference; the control passes an fp8 rounding). Imports
nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def _mlp_dims(cfg: dict):
    n_interact = (len(cfg["vocab_sizes"]) + 1) * len(cfg["vocab_sizes"]) // 2
    bot = [cfg["n_dense"]] + list(cfg["bot_mlp"])
    top = [cfg["embed_dim"] + n_interact] + list(cfg["top_mlp"])
    return bot, top


def param_specs(cfg: dict) -> List[Tuple[Tuple, Tuple[int, ...], float]]:
    """``(path, shape, scale)`` of every parameter, in the program's tree
    paths: tables ``N(0, 1/dim)``, weights ``N(0, 1/fan_in)`` in the
    ``(d_in, d_out)`` layout, biases zero."""
    D = cfg["embed_dim"]
    specs = [(("tables", f"emb_{f}"), (int(v), D), 1.0 / math.sqrt(D))
             for f, v in enumerate(cfg["vocab_sizes"])]
    for name, dims in zip(("bot", "top"), _mlp_dims(cfg)):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            specs.append((("dense", name, i, "w"), (a, b), 1.0 / math.sqrt(a)))
            specs.append((("dense", name, i, "b"), (b,), 0.0))
    return specs


def tables(cfg: dict) -> List[Tuple[str, int]]:
    """``(table name, sparse field)`` of every embedding table."""
    return [(f"emb_{f}", f) for f in range(len(cfg["vocab_sizes"]))]


def _mlp(p, name: str, n: int, x, lp, final_act: bool):
    for i in range(n):
        x = lp(x) @ lp(p[("dense", name, i, "w")]) + p[("dense", name, i, "b")]
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


def bce_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.clamp(logits, min=0) - logits * labels
                     + torch.log1p(torch.exp(-torch.abs(logits))))


def loss_sum(p: Dict, rows: Dict[str, torch.Tensor], batch: Dict, cfg: dict, lp):
    """The sum over ``batch``'s examples of the loss. ``rows[name]`` holds
    each example's rows of the table, (B, H, D)."""
    bot_dims, top_dims = _mlp_dims(cfg)
    bot = _mlp(p, "bot", len(bot_dims) - 1, batch["dense"], lp, final_act=True)
    emb = torch.stack([rows[name].sum(dim=1) for name, _ in tables(cfg)], dim=1)
    feats = lp(torch.cat([bot[:, None, :], emb], dim=1))             # (B, F+1, D)
    dots = feats @ feats.transpose(1, 2)
    iu, ju = np.triu_indices(feats.shape[1], k=1)
    inter = dots[:, torch.from_numpy(iu).to(dots.device), torch.from_numpy(ju).to(dots.device)]
    top = _mlp(p, "top", len(top_dims) - 1, torch.cat([bot, inter], dim=-1), lp,
               final_act=False)
    return bce_sum(top[:, 0], batch["label"])


# Frozen copy of src/repro_torch/models/dlrm.py::dense_flops (called there
# through configs/_families.py::recsys_dense_flops).
def dense_flops(cfg: dict, batch: int) -> float:
    """Analytic forward FLOPs of ``batch`` examples: the two MLPs' products
    and the dot interaction (the matmul-dominated terms)."""
    dims = [cfg["n_dense"]] + list(cfg["bot_mlp"])
    f = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    Ft = len(cfg["vocab_sizes"]) + 1
    f += 2 * Ft * Ft * cfg["embed_dim"]
    n_interact = Ft * (Ft - 1) // 2
    dims = [cfg["embed_dim"] + n_interact] + list(cfg["top_mlp"])
    f += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    return float(f) * batch
