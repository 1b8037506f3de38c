"""Assigned input-shape sets. The recsys shapes are ported; the
``retrieval_cand`` cell is listed so that asking for it names its ROADMAP
entry, and the other families come with later slices."""

from __future__ import annotations

from typing import Dict

RECSYS_SHAPES: Dict[str, dict] = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

# Reduced shape set for CPU tests (same code paths, tiny extents).
RECSYS_SHAPES_REDUCED: Dict[str, dict] = {
    "train_batch": dict(kind="train", batch=64),
    "serve_p99": dict(kind="serve", batch=16),
    "serve_bulk": dict(kind="serve", batch=128),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=512),
}
