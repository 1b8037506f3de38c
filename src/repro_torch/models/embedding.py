"""Sparse embedding stack for recsys models, in PyTorch.

The lookup is gather + sum-over-bag (dense multi-hot), the hot path the
paper's models spend their memory bandwidth on: the ``embedding_bag``
kernel on a card, one launch for all fields, its plain version on the CPU. Tables live whole on one
device: the reference's row sharding over a mesh waits for the
multi-device slice.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.embedding_bag import embedding_bag_fields
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


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)`` for a (V, D) or (V,) table. Its
    backward sums repeated ids' gradients by sort and segment sum
    (``F.embedding``); advanced indexing's backward serializes them, and
    the zipf-skewed ids of a training batch repeat by the thousand."""
    ids = ids.to(torch.int64)
    if table.dim() == 1:
        return F.embedding(ids, table[:, None])[..., 0]
    return F.embedding(ids, table)


def take_fields(tables: Sequence[torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    """The multi-field lookup as differentiable tensor ops, for training:
    each field's rows by ``take``, summed over H in f32, stacked and cast
    to bf16 — the numbers of ``embedding_bag_fields_torch``, with the
    backward that ``take`` gives (the kernel has none). It stays apart
    from that function, which is the kernel's plain version and is left as
    the kernel is held to it: its advanced indexing is the gather the
    kernel does, and its backward would serialize a batch's repeated ids."""
    return torch.stack([take(t, ids[:, f, :]).sum(dim=-2, dtype=torch.float32)
                        for f, t in enumerate(tables)], dim=1).to(torch.bfloat16)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mode: str = "sum",
                  weights=None) -> torch.Tensor:
    """Dense multi-hot bag: ids (..., H) → (..., dim). EmbeddingBag-sum/mean/
    max built from a gather and a reduce over the bag, as the reference's
    (plain tensor ops; the kernel path is ``lookup_fields``)."""
    emb = table[ids.to(torch.int64)]  # (..., H, D)
    if weights is not None:
        emb = emb * weights[..., None]
    if mode == "sum":
        return emb.sum(dim=-2)
    if mode == "mean":
        return emb.mean(dim=-2)
    if mode == "max":
        return emb.amax(dim=-2)
    raise ValueError(mode)


def ragged_embedding_bag(table: torch.Tensor, values: torch.Tensor,
                         offsets: torch.Tensor, num_bags: int,
                         mode: str = "sum") -> torch.Tensor:
    """torch-style ragged EmbeddingBag: values (nnz,), offsets (num_bags+1,).
    Value i belongs to bag ``searchsorted(offsets[1:], i, right=True)``; a
    value past the last bag is dropped, as the reference's segment sum
    drops it. ``mean`` divides by ``max(count, 1)``."""
    emb = table[values.to(torch.int64)]  # (nnz, D)
    pos = torch.arange(values.shape[0], device=values.device)
    bag_ids = torch.searchsorted(offsets[1:].to(torch.int64), pos, right=True)
    keep = bag_ids < num_bags
    out = torch.zeros((num_bags,) + tuple(emb.shape[1:]), dtype=emb.dtype,
                      device=emb.device).index_add_(0, bag_ids[keep], emb[keep])
    if mode == "mean":
        counts = offsets[1:] - offsets[:-1]
        out = out / torch.clamp(counts[:, None], min=1)
    return out


def lookup_fields(tables: Dict[str, torch.Tensor], ids: torch.Tensor,
                  prefix: str = "emb", bag=embedding_bag_fields) -> torch.Tensor:
    """Multi-field lookup: ids (B, F, H) → (B, F, D) bf16 (bag-sum over H),
    cast as the reference casts before its cross-device exchange. One call
    of the multi-field op ``bag`` over all fields: by default
    ``embedding_bag_fields``, on a card one kernel launch, which has no
    backward, so this is the forward of serving (and of ``train_loss`` on
    the CPU). Pass ``embedding_bag_fields_torch`` to hold the kernel
    against the plain version, or ``take_fields`` for a differentiable
    lookup on a card."""
    return bag([tables[f"{prefix}_{f}"] for f in range(ids.shape[1])], ids)


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
