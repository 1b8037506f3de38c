"""Flash attention forward: two CUDA kernels and their plain PyTorch twin.

``flash_attention(q, k, v, causal)`` maps q (B, Sq, Hq, D) and k, v
(B, Sk, Hkv, D), bf16 or f32, to softmax(q k^T / sqrt(D)) v in q's dtype,
with GQA (q head ``h`` reads kv head ``h // (Hq // Hkv)``) and an optional
causal mask. A CUDA tensor goes through a hand-written kernel chosen by
dtype: bf16 through the tensor-core kernel (``csrc/flash_attention_mma.cu``,
``mma.sync`` in bf16 with f32 accumulation), f32 through the SIMT kernel
(``csrc/flash_attention.cu``, f32 FMAs). Each route counts its own
launches; neither falls back to the other or to the plain version. A CPU
tensor goes through the plain version (``ref.py``). Forward only, as the
Pallas kernel: the models train through
``models.layers.chunked_attention``, which autograd differentiates.
"""

from __future__ import annotations

import numpy as np
import torch

from ..build import LaunchCounter, check, library, stream_of
from .ref import flash_attention_torch

MMA_LAUNCHES = LaunchCounter()   # bf16: the tensor-core kernel
SIMT_LAUNCHES = LaunchCounter()  # f32: the SIMT kernel

# the SIMT kernel pads D to a multiple of 32, the tensor-core kernel to a
# multiple of 16, both up to 128
MAX_HEAD_DIM = 128


def _vec16(t: torch.Tensor) -> bool:
    """Base pointer and batch, sequence and head strides all multiples of
    16 bytes (8 bf16 or 4 f32 elements): whole 16-byte pieces of a row are
    aligned."""
    return t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0
                                          for s in t.stride()[:3])


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """The hand-written Hopper kernels: bf16 through the tensor-core kernel,
    f32 through the SIMT kernel. q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D),
    all bf16 or all f32 on one CUDA device, each with unit stride along D
    (any batch, sequence and head strides: the projections' views are taken
    as they lie; views that are not 16-byte aligned load element by
    element); D <= 128, Hq % Hkv == 0. Returns a contiguous (B, Sq, Hq, D)
    tensor of q's dtype."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"dtypes differ: q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, Sq, Hq, D), k = v (B, Sk, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside [1, {MAX_HEAD_DIM}]")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} q heads are not a multiple of {Hkv} kv heads")
    if Sk < 1:
        raise ValueError("no keys")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride along D, got "
                             f"strides {t.stride()}")
    if B * Hq >= 2 ** 31:
        raise ValueError(f"B * Hq = {B * Hq} outside the kernel's grid")
    o = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if B and Sq:
        lib = library()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                B, Sq, Sk, Hq, Hkv, D, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], float(np.float32(1.0 / np.sqrt(D))), int(causal),
                int(_vec16(q)), int(_vec16(k) and _vec16(v)))
        with torch.cuda.device(q.device):
            if q.dtype == torch.bfloat16:
                err = lib.flash_attention_mma_launch(*args, stream_of(q))
                check(err, "flash_attention_mma_launch")
                MMA_LAUNCHES.add()
            else:
                err = lib.flash_attention_f32_launch(*args, stream_of(q))
                check(err, "flash_attention_f32_launch")
                SIMT_LAUNCHES.add()
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Fused attention: (B,Sq,Hq,D) x (B,Sk,Hkv,D)^2 → (B,Sq,Hq,D), where
    q lives: the kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal)
    return flash_attention_torch(q, k, v, causal=causal)
