"""On-device chunk content hash: the CUDA kernel and its plain PyTorch twin.

``chunk_hash32_device(words)`` hashes the packed uint32 word stream that
``quant_pack`` just produced, without the codes ever leaving the device:
the hand-written kernel (``csrc/chunk_hash.cu``) for a CUDA tensor, the
plain PyTorch version for a CPU tensor. The result equals
``ref.chunk_hash32`` of the serialized payload bytes
(``core.packing.words_to_payload``) because the packed stream's tail bits
beyond the payload are zero.

The plain version works in int64 with ``& 0xFFFFFFFF`` (PyTorch has no
uint32 shifts or multiplies); each 32x32-bit product is split into 16-bit
halves so that no int64 product overflows.
"""

from __future__ import annotations

import torch

from ..build import LaunchCounter, check, library, pick_impl, stream_of
from .ref import PRIME1, PRIME2, PRIME3, chunk_hash32, finalize, hash_words_np

_MASK = 0xFFFFFFFF

LAUNCHES = LaunchCounter()


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for int64 ``a`` in [0, 2**32) and a 32-bit
    constant ``c``: each partial product stays below 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK


def mix_terms_torch(words: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Per-word mixed terms as int64 in [0, 2**32) — ``ref.mix_terms_np``
    bit for bit."""
    t = (words + _mul32(index, PRIME2)) & _MASK
    t = t ^ (t >> 15)
    t = _mul32(t, PRIME1)
    t = t ^ (t >> 13)
    return _mul32(t, PRIME3)


def hash_words_torch(words: torch.Tensor, count: int) -> int:
    """Plain PyTorch hash of ``words[:count]`` on the words' device."""
    w = words[:count].to(torch.int64) & _MASK
    i = torch.arange(count, dtype=torch.int64, device=w.device)
    acc = int(mix_terms_torch(w, i).sum().item()) & _MASK
    return finalize(acc, count)


def hash_words_cuda(words: torch.Tensor, count: int) -> int:
    """The CUDA kernel's hash of ``words[:count]`` (words uint32, 1-D,
    contiguous, on a CUDA device). One 4-byte read-back."""
    if not words.is_cuda:
        raise ValueError("hash_words_cuda needs a CUDA tensor")
    if words.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"words must be uint32, got {words.dtype}")
    if words.dim() != 1 or not words.is_contiguous():
        raise ValueError("words must be a contiguous 1-D tensor")
    if not 0 <= count <= words.shape[0]:
        raise ValueError(f"count {count} outside [0, {words.shape[0]}]")
    if count == 0:
        return finalize(0, 0)
    acc = torch.zeros(1, dtype=torch.int32, device=words.device)
    launch_sum(words, count, acc)
    return finalize(int(acc.item()) & _MASK, count)


def launch_sum(words: torch.Tensor, count: int, acc: torch.Tensor) -> None:
    """Launch the kernel: add ``sum(mix(w_i + i*P2)) mod 2**32`` over
    ``words[:count]`` into the zeroed 4-byte ``acc`` on the current stream,
    without waiting for it. ``hash_words_cuda`` checks the arguments."""
    lib = library()
    with torch.cuda.device(words.device):
        err = lib.chunk_hash_launch(words.data_ptr(), count, acc.data_ptr(),
                                    stream_of(words))
        check(err, "chunk_hash_launch")
        LAUNCHES.add()


def chunk_hash32_device(words: torch.Tensor, count=None,
                        impl: str = "auto") -> int:
    """Hash ``words[:count]`` (uint32 stream) where it lives; returns the
    Python int hash. ``impl``: "auto" (the kernel for a CUDA tensor, the
    plain version for a CPU tensor), "cuda", "torch"."""
    n = int(words.shape[0]) if count is None else int(count)
    if pick_impl(impl, words) == "cuda":
        return hash_words_cuda(words, n)
    return hash_words_torch(words, n)


__all__ = ["LAUNCHES", "chunk_hash32", "chunk_hash32_device", "hash_words_cuda",
           "hash_words_np", "hash_words_torch", "launch_sum", "mix_terms_torch"]
