"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch twins.

Each wrapper launches its CUDA kernel for a CUDA tensor and runs the plain
version for a CPU tensor. The kernels build on first use (``build.py``).
The public ops are the ones ``repro.kernels`` exports.
"""

from .adaptive_quant import adaptive_quant
from .chunk_hash import chunk_hash32, chunk_hash32_device
from .dot_interaction import dot_interaction
from .embedding_bag import embedding_bag
from .flash_attention import flash_attention

__all__ = ["adaptive_quant", "chunk_hash32", "chunk_hash32_device",
           "dot_interaction", "embedding_bag", "flash_attention"]
