"""numpy oracle of the DLRM pairwise-dot interaction (the reference's
``src/repro/kernels/dot_interaction/ref.py``, in numpy): the dots
<f_i, f_j> for i < j in ``np.triu_indices`` order, in float32."""

from __future__ import annotations

import numpy as np


def dot_interaction_np(feats: np.ndarray) -> np.ndarray:
    """feats (B, F, D) → (B, F(F-1)/2) f32."""
    x = feats.astype(np.float32)
    z = np.einsum("bfd,bgd->bfg", x, x)
    iu, ju = np.triu_indices(feats.shape[1], k=1)
    return z[:, iu, ju]
