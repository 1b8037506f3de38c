"""Assigned input-shape sets. Only the recsys train shape is ported so far;
the serve and retrieval shapes come with the serving slice."""

from __future__ import annotations

from typing import Dict

RECSYS_SHAPES: Dict[str, dict] = {
    "train_batch": dict(kind="train", batch=65536),
}

# Reduced shape set for CPU tests (same code paths, tiny extents).
RECSYS_SHAPES_REDUCED: Dict[str, dict] = {
    "train_batch": dict(kind="train", batch=64),
}
