"""Error-feedback int8 gradient compression collectives, in PyTorch.

Each leaf is compressed to int8 with a single per-leaf scale before the
all-reduce; the quantization residual is fed back into the next round's
gradient (error feedback), so the transmitted signal is unbiased over time.
``ef_allreduce_shardmap`` keeps the reference's name and takes a
``torch.distributed`` process group where the reference takes a
``shard_map`` axis name: each rank compresses its own gradients and the
group sums the dequantized values.
"""

from __future__ import annotations

import torch

from ..tree import tree_map


def quantize_int8(x: torch.Tensor):
    """Symmetric int8: scale = max|x|/127 (scalar per leaf)."""
    x = x.to(torch.float32)
    amax = torch.max(torch.abs(x))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_int8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def compress_leaf(g: torch.Tensor, residual: torch.Tensor):
    """Error-feedback compression of one leaf: quantize (g + residual),
    return (codes, scale, new_residual)."""
    corrected = g.to(torch.float32) + residual
    codes, scale = quantize_int8(corrected)
    new_residual = corrected - dequantize_int8(codes, scale)
    return codes, scale, new_residual


def init_residuals(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def ef_allreduce_shardmap(grads, residuals, group=None):
    """Mean-all-reduce a tree of this rank's gradients with int8 EF
    compression over ``group`` (``torch.distributed``; None: the default
    group) → (mean_tree, new_residuals). Every rank of the group calls it
    with trees of one structure, as every cell of the reference's
    ``shard_map`` does."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    leaves, new_res = [], []

    def one(g, r):
        codes, scale, new_r = compress_leaf(g, r)
        total = dequantize_int8(codes, scale)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        new_res.append(new_r)
        return total / n

    means = tree_map(one, grads, residuals)
    it = iter(new_res)
    return means, tree_map(lambda _: next(it), grads)
