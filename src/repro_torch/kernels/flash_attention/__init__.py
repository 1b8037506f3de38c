from .ops import MMA_LAUNCHES, SIMT_LAUNCHES, flash_attention, flash_attention_cuda
from .ref import flash_attention_torch

__all__ = ["MMA_LAUNCHES", "SIMT_LAUNCHES", "flash_attention",
           "flash_attention_cuda", "flash_attention_torch"]
