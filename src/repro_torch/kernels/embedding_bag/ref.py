"""numpy oracle of EmbeddingBag-sum (the reference's
``src/repro/kernels/embedding_bag/ref.py``, in numpy): gather the rows,
sum each bag over H in float32."""

from __future__ import annotations

import numpy as np


def embedding_bag_np(table: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """table (V, D) f32, ids (B, H) ints → (B, D) f32 bag sums."""
    return np.take(table, ids.astype(np.int64), axis=0).sum(axis=-2,
                                                            dtype=np.float32)
