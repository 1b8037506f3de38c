"""Decoupled in-memory snapshots (Check-N-Run §3.2), in PyTorch.

Training stalls only while the model state is copied device→host (the
paper's <7 s GPU→DRAM copy on 128 GPUs). Everything downstream — policy
decision, quantization, packing, storage — runs in background threads on
the snapshot, while training proceeds on device.

Every array in a snapshot is a private host copy. On the CPU device
``tensor.cpu().numpy()`` would share memory with the live tensor, and the
next train step's in-place update would corrupt a snapshot that is still
being written in the background.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch


@dataclasses.dataclass
class Snapshot:
    step: int
    tables: Dict[str, np.ndarray]                 # name -> (rows, dim) f32
    row_state: Dict[str, Dict[str, np.ndarray]]   # name -> aux -> (rows,) arrays
    touched: Dict[str, np.ndarray]                # name -> (rows,) bool
    dense: Dict[str, np.ndarray]                  # flat path -> ndarray
    extra: Dict[str, Any]                         # JSON-serializable
    stall_time_s: float = 0.0

    def total_param_bytes(self) -> int:
        n = sum(t.nbytes for t in self.tables.values())
        n += sum(a.nbytes for d in self.row_state.values() for a in d.values())
        n += sum(a.nbytes for a in self.dense.values())
        return n


def _to_host(x) -> np.ndarray:
    """A host copy that shares no memory with ``x``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def take_snapshot(
    step: int,
    tables: Dict[str, torch.Tensor],
    row_state: Dict[str, Dict[str, torch.Tensor]],
    touched: Dict[str, torch.Tensor],
    dense: Dict[str, Any],
    extra: Dict[str, Any],
) -> Snapshot:
    """Atomic device→host copy; the only part that stalls training."""
    t0 = time.monotonic()
    snap = Snapshot(
        step=step,
        tables={k: _to_host(v) for k, v in tables.items()},
        row_state={k: {a: _to_host(v) for a, v in d.items()} for k, d in row_state.items()},
        touched={k: _to_host(v) for k, v in touched.items()},
        dense={k: _to_host(v) for k, v in dense.items()},
        extra=dict(extra),
    )
    snap.stall_time_s = time.monotonic() - t0
    return snap
