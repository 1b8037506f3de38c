"""Concrete batch generation for a CellBundle — shapes match
``bundle.make_inputs()`` exactly, values come from the deterministic
synthetic streams, and for the same ``(cell, batch_idx, seed)`` the batch is
the reference's (``src/repro/data/cells.py``) array for array. The dlrm-rm2 and
bert4rec train and serve cells are ported so far."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..configs._families import CellBundle
from . import synthetic as syn


def batch_for_cell(bundle: CellBundle, batch_idx: int, seed: int = 0) -> Dict[str, np.ndarray]:
    specs = bundle.make_inputs()
    arch, kind, cfg = bundle.arch, bundle.kind, bundle.cfg
    rng = np.random.default_rng([seed, batch_idx, 7])
    if arch == "dlrm-rm2" and kind in ("train", "serve"):
        B = specs["sparse_ids"].shape[0]
        b = syn.recsys_batch(syn.RecsysStreamConfig(
            batch=B, n_dense=getattr(cfg, "n_dense", 0),
            n_sparse=cfg.n_sparse, vocab_sizes=cfg.vocab_sizes,
            multi_hot=cfg.multi_hot, seed=seed), batch_idx)
        out = dict(sparse_ids=b["sparse_ids"])
        if "dense" in specs:
            out["dense"] = b["dense"]
        if kind == "train":
            out["label"] = b["label"]
        return out
    if arch == "bert4rec" and kind == "train":
        B = specs["items"].shape[0]
        b = syn.seqrec_batch(syn.SeqRecStreamConfig(
            batch=B, seq_len=cfg.seq_len, n_items=cfg.n_items, seed=seed), batch_idx)
        N = specs["neg_ids"].shape[0]
        return dict(items=b["items"], labels=b["labels"], mask=b["mask"],
                    neg_ids=(syn.zipf_like(rng, cfg.n_items - 1, (N,)) + 1).astype(np.int32))
    if arch == "bert4rec" and kind == "serve":
        B, Sq = specs["items"].shape
        items = (syn.zipf_like(rng, cfg.n_items - 1, (B, Sq)) + 1).astype(np.int32)
        C = specs["candidate_ids"].shape[1]
        return dict(items=items,
                    candidate_ids=(syn.zipf_like(rng, cfg.n_items - 1, (B, C)) + 1).astype(np.int32))
    raise ValueError(f"no batch generator for ({arch}, {kind})")
