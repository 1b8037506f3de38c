from .ops import (
    LAUNCHES,
    dot_interaction,
    dot_interaction_cuda,
    dot_interaction_torch,
)
from .ref import dot_interaction_np

__all__ = ["LAUNCHES", "dot_interaction", "dot_interaction_cuda",
           "dot_interaction_np", "dot_interaction_torch"]
