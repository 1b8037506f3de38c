"""EmbeddingBag-sum, the recsys lookup: the CUDA kernel and its plain
PyTorch twin.

``embedding_bag(table, ids)`` sums, for each bag ``b``, the rows
``table[ids[b, h]]`` over ``h``: through the hand-written kernel
(``csrc/embedding_bag.cu``) for a CUDA tensor, through the plain version
for a CPU tensor. Forward only, as the Pallas kernel it replaces: the
sparse train step gathers its own vectors and never calls it.
"""

from __future__ import annotations

import torch

from ..build import LaunchCounter, check, library, stream_of

LAUNCHES = LaunchCounter()


def embedding_bag_torch(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The plain version on ``table``'s device: gather, then sum over H in
    float32. table (V, D) f32, ids (B, H) integers → (B, D) f32."""
    return table[ids.to(torch.int64)].sum(dim=-2, dtype=torch.float32)


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The hand-written Hopper kernel. ``table`` f32 (V, D), contiguous;
    ``ids`` int32 (B, H), H >= 1, unit stride along H (a field's column of
    a (B, F, H) id tensor is taken as it lies); both on one CUDA device.
    An id outside [0, V) makes its bag NaN."""
    if not (table.is_cuda and ids.is_cuda):
        raise ValueError("embedding_bag_cuda needs CUDA tensors")
    if table.device != ids.device:
        raise ValueError(f"table on {table.device}, ids on {ids.device}")
    if table.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous 2-D tensor")
    if ids.dim() != 2 or ids.shape[1] < 1 or (ids.shape[1] > 1 and ids.stride(1) != 1):
        raise ValueError(f"ids must be (B, H >= 1) with unit stride along H, "
                         f"got shape {tuple(ids.shape)} strides {ids.stride()}")
    vocab, dim = table.shape
    bags, hot = ids.shape
    if bags >= 2 ** 31 or dim >= 2 ** 31 or hot >= 2 ** 31:
        raise ValueError(f"shape {tuple(ids.shape)} x {tuple(table.shape)} "
                         f"outside the kernel's int extents")
    out = torch.empty((bags, dim), dtype=torch.float32, device=table.device)
    if bags and dim:
        lib = library()
        with torch.cuda.device(table.device):
            err = lib.embedding_bag_launch(
                table.data_ptr(), ids.data_ptr(), out.data_ptr(), vocab, dim,
                bags, hot, ids.stride(0), stream_of(table))
            check(err, "embedding_bag_launch")
            LAUNCHES.add()
    return out


def embedding_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """EmbeddingBag-sum: (V, D) table x (B, H) ids → (B, D) f32, where the
    table lives: the kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if table.is_cuda:
        return embedding_bag_cuda(table, ids)
    return embedding_bag_torch(table, ids)
