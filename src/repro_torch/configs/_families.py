"""Family-level cell builders: (arch config × shape) → CellBundle.

A CellBundle is everything one train cell needs: the step callable, the
input specs, the tracked specs for Check-N-Run, the optimizer, and the
device it all lives on. Only the recsys family's train cells with the
sparse DLRM step are ported so far; serve and retrieval cells, and the
other families, come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import dlrm as m_dlrm
from ..optim.optimizers import adagrad, rowwise_adagrad, split_optimizer
from ..train.state import TrackedSpec, TrainState, init_train_state, rng_key_data
from . import shapes as S


class InputSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: Any  # numpy dtype


@dataclasses.dataclass
class CellBundle:
    arch: str
    shape: str
    kind: str                       # train (the only kind ported so far)
    cfg: Any
    device: torch.device
    init: Callable                  # torch.Generator -> params
    step_fn: Callable               # (state, batch) -> (state, metrics)
    make_inputs: Callable           # () -> {name: InputSpec}
    tracked: Dict[str, TrackedSpec]
    optimizer: Any

    def make_state(self, seed: int = 0) -> TrainState:
        """A fresh TrainState on the bundle's device, params drawn from a
        generator seeded with ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = self.init(gen)
        return init_train_state(params, self.optimizer, self.tracked,
                                rng_key_data(1), self.device)


def recsys_cell(arch: str, cfg, shape: str, reduced: bool = False,
                device="cuda") -> CellBundle:
    spec = (S.RECSYS_SHAPES_REDUCED if reduced else S.RECSYS_SHAPES)[shape]
    kind = spec["kind"]
    if arch != "dlrm-rm2" or kind != "train":
        raise NotImplementedError(
            f"({arch}, {shape}) is not ported yet: this slice ports the "
            f"dlrm-rm2 train cells; other recsys archs and serve/retrieval "
            f"cells come with later slices")
    dev = resolve_device(device)
    B = spec["batch"]
    tracked = m_dlrm.tracked_specs(cfg)
    optimizer = split_optimizer(rowwise_adagrad(0.01), adagrad(0.01))
    inputs = dict(sparse_ids=InputSpec((B, cfg.n_sparse, cfg.multi_hot), np.int32),
                  label=InputSpec((B,), np.float32))
    if cfg.n_dense:
        inputs["dense"] = InputSpec((B, cfg.n_dense), np.float32)

    return CellBundle(
        arch=arch, shape=shape, kind=kind, cfg=cfg, device=dev,
        init=lambda gen: m_dlrm.init_params(gen, cfg),
        # the sparse embedding update (see models/dlrm.py)
        step_fn=m_dlrm.make_sparse_train_step(cfg, adagrad(0.01)),
        make_inputs=lambda: dict(inputs), tracked=tracked,
        optimizer=optimizer)
