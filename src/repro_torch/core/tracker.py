"""Modified-row tracking (Check-N-Run §4.1.2), in PyTorch.

The paper tracks touched embedding rows with a per-GPU bit-vector updated
during the forward pass (most rows read forward are written backward). Here
the touched mask is part of the train state: a ``bool`` vector per tracked
table on the table's device, marked inside the train step.

Memory: 1 byte/row unpacked on device (<0.4% of a dim>=32 fp32 table; the
paper quotes <0.05% for its packed bit-vector — we pack on host at
serialization time only).

Masks are never updated in place: a snapshot taken on the CPU device would
otherwise alias the live mask.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def init_touched(num_rows: int, device="cpu") -> torch.Tensor:
    return torch.zeros((num_rows,), dtype=torch.bool, device=device)


def mark_touched(mask: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """A new mask with ``mask[indices] = True``, with the reference's
    ``mode="drop"`` scatter semantics made explicit: duplicates are fine,
    negative ids count from the end (as jnp indexing normalizes them), and
    ids still outside ``[0, len(mask))`` are dropped."""
    n = mask.shape[0]
    idx = indices.reshape(-1).to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    idx = idx[(idx >= 0) & (idx < n)]
    out = mask.clone()
    out[idx] = True
    return out


def merge_touched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.logical_or(a, b)


def reset_touched(mask: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(mask)


def touched_fraction(mask: torch.Tensor) -> torch.Tensor:
    return torch.mean(mask.to(torch.float32))


def shard_indices(mask: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """One host's view of a touched-row set: GLOBAL indices of touched rows
    inside its range ``[lo, hi)``. Host-side (numpy) — runs on the already
    device→host-copied snapshot mask. Unioning the result over the row
    partition reproduces ``np.nonzero(mask)`` exactly, which is what keeps
    incremental policies coherent under sharded writers."""
    return (np.nonzero(np.asarray(mask[lo:hi]))[0] + lo).astype(np.uint32)


def tree_reset(masks: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: reset_touched(v) for k, v in masks.items()}


def tree_merge(a: Mapping[str, torch.Tensor],
               b: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: merge_touched(a[k], b[k]) for k in a}
