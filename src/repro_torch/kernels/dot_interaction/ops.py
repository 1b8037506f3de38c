"""DLRM dot-product feature interaction: the CUDA kernel and its plain
PyTorch twin.

``dot_interaction(feats)`` maps (B, F, D) features, bf16 or f32, to the
(B, F(F-1)/2) f32 dots <f_i, f_j> for i < j in ``np.triu_indices`` order,
accumulated in f32 as the Pallas kernel does: through the hand-written
kernel (``csrc/dot_interaction.cu``) for a CUDA tensor, through the plain
version for a CPU tensor. Forward only, as the Pallas kernel: the train
step keeps ``models.dlrm.dot_interaction``, which autograd differentiates.
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


def dot_interaction_cuda(feats: torch.Tensor) -> torch.Tensor:
    """The hand-written Hopper kernel. ``feats`` (B, F, D) bf16 or f32,
    contiguous, on a CUDA device, F >= 2; one batch row's features, as f32,
    must fit the kernel's 48 KB of shared memory."""
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
    if nf * (dim | 1) * 4 + pairs * 4 > 48 * 1024 or batch >= 2 ** 31:
        raise ValueError(f"shape {tuple(feats.shape)} outside the kernel's "
                         f"shared-memory budget or int extents")
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
