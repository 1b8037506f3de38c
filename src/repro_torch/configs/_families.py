"""Family-level cell builders: (arch config × shape) → CellBundle.

A CellBundle is everything one cell needs: the step callable, the input
specs, the tracked specs for Check-N-Run, the optimizer, and the device it
all lives on. dlrm-rm2's train cells (the sparse DLRM step) and serve
cells (``serve_p99``, ``serve_bulk``) are ported; the retrieval cell and
the other archs and families come with later slices.
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
    kind: str                       # train | serve
    cfg: Any
    device: torch.device
    init: Callable                  # torch.Generator -> params
    step_fn: Callable               # train: (state, batch) -> (state, metrics)
                                    # serve: (params, batch) -> probs
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
    if arch != "dlrm-rm2":
        raise NotImplementedError(
            f"({arch}, {shape}) is not ported yet: only dlrm-rm2 is; the "
            f"other archs come with ROADMAP A6")
    if kind not in ("train", "serve"):
        raise NotImplementedError(
            f"({arch}, {shape}) is not ported yet: the {kind} cell "
            f"(serve_retrieval) comes with ROADMAP A3")
    dev = resolve_device(device)
    B = spec["batch"]
    tracked = m_dlrm.tracked_specs(cfg)
    optimizer = split_optimizer(rowwise_adagrad(0.01), adagrad(0.01))
    inputs = dict(sparse_ids=InputSpec((B, cfg.n_sparse, cfg.multi_hot), np.int32))
    if kind == "train":
        inputs["label"] = InputSpec((B,), np.float32)
        # the sparse embedding update (see models/dlrm.py)
        step_fn = m_dlrm.make_sparse_train_step(cfg, adagrad(0.01))
    else:
        step_fn = lambda params, batch: m_dlrm.serve(params, batch, cfg)
    if cfg.n_dense:
        inputs["dense"] = InputSpec((B, cfg.n_dense), np.float32)

    return CellBundle(
        arch=arch, shape=shape, kind=kind, cfg=cfg, device=dev,
        init=lambda gen: m_dlrm.init_params(gen, cfg),
        step_fn=step_fn, make_inputs=lambda: dict(inputs), tracked=tracked,
        optimizer=optimizer)
