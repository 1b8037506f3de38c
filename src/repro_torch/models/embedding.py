"""Sparse embedding stack for recsys models, in PyTorch.

The lookup is ``index_select`` + sum-over-bag (dense multi-hot), the hot
path the paper's models spend their memory bandwidth on. Tables live whole
on one device: the reference's row sharding over a mesh waits for the
multi-device slice.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..train.state import TrackedSpec
from .layers import dense_init


def pad_rows(v: int, multiple: int = 512) -> int:
    """Round table rows up so they shard evenly over model×data mesh axes.
    Padding rows are never referenced by any id — safe for lookup-only
    tables (gradients there are identically zero)."""
    return ((v + multiple - 1) // multiple) * multiple


def init_tables(gen: torch.Generator, vocab_sizes: Sequence[int], dim: int,
                prefix: str = "emb") -> Dict[str, torch.Tensor]:
    return {f"{prefix}_{i}": dense_init(gen, (v, dim), scale=1.0 / np.sqrt(dim))
            for i, v in enumerate(vocab_sizes)}


def table_specs(vocab_sizes: Sequence[int], dim: int,
                prefix: str = "emb") -> Dict[str, TrackedSpec]:
    return {
        f"{prefix}_{i}": TrackedSpec(path=("tables", f"{prefix}_{i}"),
                                     units=v, rows=v, dim=dim)
        for i, v in enumerate(vocab_sizes)
    }


def embedding_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Dense multi-hot bag-sum: ids (..., H) → (..., dim)."""
    emb = table[ids.to(torch.int64)]  # (..., H, D)
    return emb.sum(dim=-2)


def lookup_fields(tables: Dict[str, torch.Tensor], ids: torch.Tensor,
                  prefix: str = "emb") -> torch.Tensor:
    """Multi-field lookup: ids (B, F, H) → (B, F, D) bf16 (bag-sum over H),
    cast as the reference casts before its cross-device exchange."""
    outs = [embedding_bag(tables[f"{prefix}_{f}"], ids[:, f, :])
            for f in range(ids.shape[1])]
    return torch.stack(outs, dim=1).to(torch.bfloat16)


def touched_masks(vocab_sizes: Sequence[int], ids: torch.Tensor,
                  prefix: str = "emb") -> Dict[str, torch.Tensor]:
    """Per-field touched-row masks from a batch of ids (B, F, H)."""
    masks = {}
    for f, v in enumerate(vocab_sizes):
        m = torch.zeros((v,), dtype=torch.bool, device=ids.device)
        m[ids[:, f, :].reshape(-1).to(torch.int64)] = True
        masks[f"{prefix}_{f}"] = m
    return masks


def mlp_init(gen: torch.Generator, dims: Sequence[int],
             bias: bool = True) -> list:
    """Weights in the reference's ``(d_in, d_out)`` layout (``x @ w + b``),
    so the dense snapshot arrays are laid out as the reference writes them."""
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        layer = dict(w=dense_init(gen, (din, dout)))
        if bias:
            layer["b"] = torch.zeros((dout,), dtype=torch.float32,
                                     device=gen.device)
        layers.append(layer)
    return layers


def mlp_apply(layers: list, x: torch.Tensor, act=torch.relu,
              final_act: bool = False,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    n = len(layers)
    h = x.to(compute_dtype)
    for i, layer in enumerate(layers):
        h = h @ layer["w"].to(compute_dtype)
        if "b" in layer:
            h = h + layer["b"].to(compute_dtype)
        if i < n - 1 or final_act:
            h = act(h)
    return h


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))
