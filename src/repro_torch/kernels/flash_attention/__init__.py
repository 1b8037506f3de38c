from .ops import LAUNCHES, flash_attention, flash_attention_cuda
from .ref import flash_attention_torch

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_cuda",
           "flash_attention_torch"]
