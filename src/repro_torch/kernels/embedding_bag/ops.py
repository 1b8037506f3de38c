"""EmbeddingBag-sum, the recsys lookup: the CUDA kernel and its plain
PyTorch twin.

``embedding_bag(table, ids)`` sums, for each bag ``b``, the rows
``table[ids[b, h]]`` over ``h``; ``embedding_bag_fields(tables, ids)`` does
so for every field ``f`` of a (B, F, H) id tensor on its own table, into
one (B, F, D) bf16 tensor (the multi-field lookup of the recsys models).
Both take the plain version when every tensor they are given lies on the
CPU, and otherwise the one hand-written kernel (``csrc/embedding_bag.cu``),
a launch a call, whose wrapper refuses anything but CUDA tensors on one
device. Forward only, as the Pallas kernel it replaces: the sparse train
step gathers its own vectors and never calls it.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..build import LaunchCounter, check, library, stream_of

LAUNCHES = LaunchCounter()

MAX_FIELDS = 64  # the kernel parameter's table slots (csrc/embedding_bag.cu)


def embedding_bag_torch(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The plain version on ``table``'s device: gather, then sum over H in
    float32. table (V, D) f32, ids (B, H) integers → (B, D) f32."""
    return table[ids.to(torch.int64)].sum(dim=-2, dtype=torch.float32)


def embedding_bag_fields_torch(tables: Sequence[torch.Tensor],
                               ids: torch.Tensor) -> torch.Tensor:
    """The plain version of the multi-field lookup: one bag-sum per field,
    stacked, cast to bf16. tables F x (V_f, D) f32, ids (B, F, H) → (B, F,
    D) bf16."""
    outs = [embedding_bag_torch(t, ids[:, f, :]) for f, t in enumerate(tables)]
    return torch.stack(outs, dim=1).to(torch.bfloat16)


def _launch(tables, ids, out, strides) -> None:
    """One kernel launch over ``tables`` (contiguous f32, checked) with the
    ids' (b, f, h) element strides, into ``out`` (B, F, D)."""
    n = len(tables)
    bags, hot = ids.shape[0], ids.shape[-1]
    dim = tables[0].shape[1]
    if bags and dim:
        lib = library()
        ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in tables])
        vocabs = (ctypes.c_longlong * n)(*[t.shape[0] for t in tables])
        with torch.cuda.device(ids.device):
            err = lib.embedding_bag_launch(
                ptrs, vocabs, n, ids.data_ptr(), *strides, out.data_ptr(),
                int(out.dtype == torch.bfloat16), bags, hot, dim,
                stream_of(ids))
            check(err, "embedding_bag_launch")
            LAUNCHES.add()


def _check_args(tables, ids, what: str, ids_dim: int) -> None:
    if not 1 <= len(tables) <= MAX_FIELDS:
        raise ValueError(f"{what} takes 1 to {MAX_FIELDS} tables, got {len(tables)}")
    if not (ids.is_cuda and all(t.is_cuda for t in tables)):
        raise ValueError(f"{what} needs CUDA tensors")
    if any(t.device != ids.device for t in tables):
        raise ValueError(f"{what}: tables on {sorted({str(t.device) for t in tables})}, "
                         f"ids on {ids.device}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if ids.dim() != ids_dim or ids.shape[-1] < 1:
        raise ValueError(f"ids must have {ids_dim} dims with H >= 1, got shape "
                         f"{tuple(ids.shape)}")
    for t in tables:
        if t.dtype != torch.float32:
            raise TypeError(f"tables must be float32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"tables must be contiguous 2-D tensors, got shape "
                             f"{tuple(t.shape)}")
    dim = tables[0].shape[1]
    if any(t.shape[1] != dim for t in tables):
        raise ValueError(f"tables of widths {sorted({t.shape[1] for t in tables})}")
    if ids.shape[0] >= 2 ** 31 or dim >= 2 ** 31 or ids.shape[-1] >= 2 ** 31:
        raise ValueError(f"shape {tuple(ids.shape)} x D {dim} outside the "
                         f"kernel's int extents")


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The hand-written Hopper kernel with one table. ``table`` f32 (V, D),
    contiguous; ``ids`` int32 (B, H), H >= 1, strided as it lies (a field's
    column of a (B, F, H) id tensor is taken without a copy); both on one
    CUDA device. → (B, D) f32. An id outside [0, V) makes its bag NaN."""
    _check_args([table], ids, "embedding_bag_cuda", 2)
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    _launch([table], ids, out, (ids.stride(0), 0, ids.stride(1)))
    return out


def embedding_bag_fields_cuda(tables: Sequence[torch.Tensor],
                              ids: torch.Tensor) -> torch.Tensor:
    """The same kernel over F fields in one launch. ``tables`` F (<= 64)
    contiguous f32 (V_f, D), one D; ``ids`` int32 (B, F, H), H >= 1, strided
    as it lies; all on one CUDA device. → (B, F, D) bf16, each bag summed in
    f32 over h in order, then rounded once. An id outside [0, V_f) makes its
    bag NaN."""
    tables = list(tables)
    _check_args(tables, ids, "embedding_bag_fields_cuda", 3)
    if ids.shape[1] != len(tables):
        raise ValueError(f"ids have {ids.shape[1]} fields, {len(tables)} tables given")
    out = torch.empty((ids.shape[0], len(tables), tables[0].shape[1]),
                      dtype=torch.bfloat16, device=ids.device)
    _launch(tables, ids, out, ids.stride())
    return out


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """EmbeddingBag-sum: (V, D) table x (B, H) ids → (B, D) f32: the plain
    version when both lie on the CPU, else the kernel (which raises unless
    both lie on one CUDA device)."""
    if _on_cpu((table, ids)):
        return embedding_bag_torch(table, ids)
    return embedding_bag_cuda(table, ids)


def embedding_bag_fields(tables: Sequence[torch.Tensor],
                         ids: torch.Tensor) -> torch.Tensor:
    """The multi-field lookup: F tables (V_f, D) x (B, F, H) ids → (B, F,
    D) bf16: the plain version when all lie on the CPU, else one kernel
    launch (which raises unless all lie on one CUDA device)."""
    tables = list(tables)
    if _on_cpu(tables + [ids]):
        return embedding_bag_fields_torch(tables, ids)
    return embedding_bag_fields_cuda(tables, ids)
