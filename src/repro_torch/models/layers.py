"""Dense-layer building blocks, in PyTorch. Only ``dense_init`` is ported so
far: the DLRM slice needs no other layer of ``src/repro/models/layers.py``."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Normal weights times ``scale`` (default ``1/sqrt(fan_in)``), drawn
    from ``gen`` on the generator's device. The numbers differ from the
    reference's ``jax.random`` ones; the distribution is the same."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
    return torch.randn(tuple(shape), generator=gen, dtype=dtype,
                       device=gen.device) * scale
