"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch twins.

Each wrapper launches its CUDA kernel for a CUDA tensor and runs the plain
version for a CPU tensor. The kernels build on first use (``build.py``).
"""
