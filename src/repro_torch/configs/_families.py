"""Family-level cell builders: (arch config × shape) → CellBundle.

A CellBundle is everything one cell needs: the step callable, the input
specs, the tracked specs for Check-N-Run, the optimizer, and the device it
all lives on. The recsys family is ported whole: the train cells
(dlrm-rm2's sparse DLRM step, the generic autograd step for xdeepfm, mind
and bert4rec), the serve cells (``serve_p99``, ``serve_bulk``) and the
retrieval cell (``retrieval_cand``: one user against C candidates) of its
four archs. The gnn and LM families come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import bert4rec as m_bert4rec
from ..models import dlrm as m_dlrm
from ..models import mind as m_mind
from ..models import xdeepfm as m_xdeepfm
from ..optim.optimizers import adagrad, rowwise_adagrad, split_optimizer
from ..train.state import TrackedSpec, TrainState, init_train_state, rng_key_data
from ..train.steps import make_train_step
from . import shapes as S


class InputSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: Any  # numpy dtype


@dataclasses.dataclass
class CellBundle:
    arch: str
    shape: str
    kind: str                       # train | serve | retrieval
    cfg: Any
    device: torch.device
    init: Callable                  # torch.Generator -> params
    step_fn: Callable               # train: (state, batch) -> (state, metrics)
                                    # serve: (params, batch) -> probs
                                    # retrieval: (params, batch) -> (C,)
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


_RECSYS_MODULES = {"dlrm-rm2": m_dlrm, "xdeepfm": m_xdeepfm, "mind": m_mind,
                   "bert4rec": m_bert4rec}


def _recsys_inputs(arch: str, cfg, B: int, kind: str, reduced: bool):
    """Input specs per recsys arch and cell kind (the reference's
    ``_recsys_stream``, with its serve overrides)."""
    if arch in ("dlrm-rm2", "xdeepfm"):
        d = dict(sparse_ids=InputSpec((B, cfg.n_sparse, cfg.multi_hot), np.int32))
        if kind == "train":
            d["label"] = InputSpec((B,), np.float32)
        if getattr(cfg, "n_dense", 0):
            d["dense"] = InputSpec((B, cfg.n_dense), np.float32)
        return d
    if arch == "mind":
        d = dict(hist=InputSpec((B, cfg.hist_len), np.int32),
                 target=InputSpec((B,), np.int32))
        if kind == "train":
            d["neg_ids"] = InputSpec((128 if reduced else 1024,), np.int32)
        return d
    items = InputSpec((B, cfg.seq_len), np.int32)
    if kind == "serve":
        return dict(items=items, candidate_ids=InputSpec((B, 100), np.int32))
    return dict(items=items, labels=InputSpec((B, cfg.seq_len), np.int32),
                mask=InputSpec((B, cfg.seq_len), np.bool_),
                neg_ids=InputSpec((64 if reduced else 256,), np.int32))


def _retrieval_inputs(arch: str, cfg, C: int, reduced: bool):
    """The user's train stream keys at batch 1, labels dropped, then the C
    candidate ids (the reference's retrieval override)."""
    user = {k: InputSpec((1,) + v.shape[1:], v.dtype)
            for k, v in _recsys_inputs(arch, cfg, 1, "train", reduced).items()
            if k not in ("label", "labels", "mask", "neg_ids", "target")}
    return dict(user, candidate_ids=InputSpec((C,), np.int32))


def recsys_cell(arch: str, cfg, shape: str, reduced: bool = False,
                device="cuda") -> CellBundle:
    spec = (S.RECSYS_SHAPES_REDUCED if reduced else S.RECSYS_SHAPES)[shape]
    kind = spec["kind"]
    if arch not in _RECSYS_MODULES:
        raise NotImplementedError(
            f"({arch}, {shape}) is not ported yet: only "
            f"{sorted(_RECSYS_MODULES)} are; dimenet and the LMs come with "
            f"ROADMAP A6.3-A6.5")
    dev = resolve_device(device)
    mod = _RECSYS_MODULES[arch]
    B = spec["batch"]
    tracked = mod.tracked_specs(cfg)
    optimizer = split_optimizer(rowwise_adagrad(0.01), adagrad(0.01))
    if kind == "train" and arch == "dlrm-rm2":
        # the sparse embedding update (see models/dlrm.py)
        step_fn = m_dlrm.make_sparse_train_step(cfg, adagrad(0.01))
    elif kind == "train":
        # bert4rec's full batch accumulates over 4 micro-batches, as the
        # reference's does; the other archs take the batch whole
        step_fn = make_train_step(
            lambda params, batch: mod.train_loss(params, batch, cfg), optimizer,
            n_micro=4 if (arch == "bert4rec" and not reduced and B >= 65536) else 1)
    elif kind == "serve":
        step_fn = lambda params, batch: mod.serve(params, batch, cfg)
    elif kind == "retrieval":
        step_fn = lambda params, batch: mod.serve_retrieval(params, batch, cfg)
    else:
        raise ValueError(kind)
    inputs = (_retrieval_inputs(arch, cfg, spec["n_candidates"], reduced)
              if kind == "retrieval"
              else _recsys_inputs(arch, cfg, B, kind, reduced))

    return CellBundle(
        arch=arch, shape=shape, kind=kind, cfg=cfg, device=dev,
        init=lambda gen: mod.init_params(gen, cfg),
        step_fn=step_fn, make_inputs=lambda: dict(inputs), tracked=tracked,
        optimizer=optimizer)
