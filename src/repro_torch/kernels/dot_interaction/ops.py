"""DLRM dot-product feature interaction: the CUDA kernel and its plain
PyTorch twin.

``dot_interaction(feats)`` maps (B, F, D) features, bf16 or f32, to the
(B, F(F-1)/2) f32 dots <f_i, f_j> for i < j in ``np.triu_indices`` order,
accumulated in f32 as the Pallas kernel does: through the hand-written
kernel (``csrc/dot_interaction.cu``: bf16 on the tensor cores, f32 on the
CUDA cores) for a CUDA tensor, through the plain version for a CPU tensor.
Forward only, as the Pallas kernel: the train step keeps
``models.dlrm.dot_interaction``, which autograd differentiates.
"""

from __future__ import annotations

import numpy as np
import torch

from ..build import LaunchCounter, check, library, stream_of

LAUNCHES = LaunchCounter()


def dot_interaction_torch(feats: torch.Tensor) -> torch.Tensor:
    """The plain version on ``feats``' device: the f32 Gram matrix, then
    its strict upper triangle."""
    x = feats.to(torch.float32)
    z = torch.bmm(x, x.transpose(1, 2))
    iu, ju = (torch.from_numpy(a).to(feats.device)
              for a in np.triu_indices(feats.shape[1], k=1))
    return z[:, iu, ju]


MMA_MAX_F = 64            # the bf16 route's four 16-row m-tiles
MMA_SMEM = 227 * 1024     # a block's shared memory on the card


def mma_warp_bytes(nf: int, dim: int) -> int:
    """Shared memory one warp of the bf16 route takes: two buffers of 4
    batch rows of features at a pitch of 2*DP + 16 bytes (DP = dim rounded
    up to 16), 4 rows of f32 dots, a 16-byte zero chunk
    (``csrc/dot_interaction.cu``, ``mma_warp_bytes``)."""
    pitch = 2 * (-(-dim // 16) * 16) + 16
    return 2 * 4 * nf * pitch + 4 * (nf * (nf - 1) // 2) * 4 + 16


def dot_interaction_cuda(feats: torch.Tensor) -> torch.Tensor:
    """The hand-written Hopper kernel. ``feats`` (B, F, D) bf16 or f32,
    contiguous, on a CUDA device, F >= 2. bf16 takes the tensor-core route
    for F <= 64 where one warp's buffers (:func:`mma_warp_bytes`) fit
    227 KB; f32 the CUDA cores, where one batch row's features as f32 and
    the pair table fit 48 KB. Other shapes raise."""
    if not feats.is_cuda:
        raise ValueError("dot_interaction_cuda needs a CUDA tensor")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"feats must be float32 or bfloat16, got {feats.dtype}")
    if feats.dim() != 3 or not feats.is_contiguous():
        raise ValueError("feats must be a contiguous 3-D tensor")
    batch, nf, dim = feats.shape
    if nf < 2 or dim < 1:
        raise ValueError(f"need F >= 2 and D >= 1, got F={nf}, D={dim}")
    pairs = nf * (nf - 1) // 2
    if feats.dtype == torch.bfloat16:
        if nf > MMA_MAX_F or mma_warp_bytes(nf, dim) > MMA_SMEM:
            raise ValueError(f"bf16 shape {tuple(feats.shape)} outside the tensor-core "
                             f"route: F <= {MMA_MAX_F} and a warp's buffers within "
                             f"{MMA_SMEM} bytes")
    elif nf * (dim | 1) * 4 + pairs * 4 > 48 * 1024:
        raise ValueError(f"f32 shape {tuple(feats.shape)} outside the kernel's "
                         f"shared-memory budget")
    if batch >= 2 ** 31:
        raise ValueError(f"batch {batch} does not fit the kernel's int extents")
    out = torch.empty((batch, pairs), dtype=torch.float32, device=feats.device)
    if batch:
        lib = library()
        with torch.cuda.device(feats.device):
            err = lib.dot_interaction_launch(
                feats.data_ptr(), out.data_ptr(), batch, nf, dim,
                int(feats.dtype == torch.bfloat16), stream_of(feats))
            check(err, "dot_interaction_launch")
            LAUNCHES.add()
    return out


def dot_interaction(feats: torch.Tensor) -> torch.Tensor:
    """(B, F, D) → (B, F(F-1)/2) f32 pairwise dots, where ``feats`` lives:
    the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if feats.is_cuda:
        return dot_interaction_cuda(feats)
    return dot_interaction_torch(feats)
