"""Concrete batch generation for a CellBundle — shapes match
``bundle.make_inputs()`` exactly, values come from the deterministic
synthetic streams, and for the same ``(cell, batch_idx, seed)`` the batch is
the reference's (``src/repro/data/cells.py``) array for array. Only the
recsys train cells are ported so far."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..configs._families import CellBundle
from . import synthetic as syn


def batch_for_cell(bundle: CellBundle, batch_idx: int, seed: int = 0) -> Dict[str, np.ndarray]:
    specs = bundle.make_inputs()
    arch, kind, cfg = bundle.arch, bundle.kind, bundle.cfg
    if arch == "dlrm-rm2" and kind == "train":
        B = specs["sparse_ids"].shape[0]
        b = syn.recsys_batch(syn.RecsysStreamConfig(
            batch=B, n_dense=getattr(cfg, "n_dense", 0),
            n_sparse=cfg.n_sparse, vocab_sizes=cfg.vocab_sizes,
            multi_hot=cfg.multi_hot, seed=seed), batch_idx)
        out = dict(sparse_ids=b["sparse_ids"])
        if "dense" in specs:
            out["dense"] = b["dense"]
        out["label"] = b["label"]
        return out
    raise ValueError(f"no batch generator for ({arch}, {kind})")
