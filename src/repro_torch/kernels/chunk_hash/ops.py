"""On-device chunk content hash: the CUDA kernel and its plain PyTorch twin.

``chunk_hash32_device(words)`` hashes the packed uint32 word stream that
``quant_pack`` just produced, without the codes ever leaving the device:
the hand-written kernel (``csrc/chunk_hash.cu``) for a CUDA tensor, the
plain PyTorch version for a CPU tensor. The result equals
``ref.chunk_hash32`` of the serialized payload bytes
(``core.packing.words_to_payload``) because the packed stream's tail bits
beyond the payload are zero.

``hash_words_async(words, count)`` is the same hash without the wait: it
launches the kernel (a 4-byte memset and one launch, no PyTorch fill) and
returns the one-element device tensor the words' term sum lands in, so the
save path reads its 4 bytes after the payload's own copies have
synchronized the stream; ``hash_value(sum, count)`` then applies the
length fold and avalanche on the host.

The plain version works in int64 with ``& 0xFFFFFFFF`` (PyTorch has no
uint32 shifts or multiplies); each 32x32-bit product is split into 16-bit
halves so that no int64 product overflows.
"""

from __future__ import annotations

import torch

from ..build import LaunchCounter, check, library, stream_of
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


def _sum_torch(words: torch.Tensor, count: int) -> int:
    """The terms' sum mod 2**32 over ``words[:count]``, in plain PyTorch."""
    w = words[:count].to(torch.int64) & _MASK
    i = torch.arange(count, dtype=torch.int64, device=w.device)
    return int(mix_terms_torch(w, i).sum().item()) & _MASK


def hash_words_torch(words: torch.Tensor, count: int) -> int:
    """Plain PyTorch hash of ``words[:count]`` on the words' device."""
    return finalize(_sum_torch(words, count), count)


def hash_words_torch_async(words: torch.Tensor, count: int) -> torch.Tensor:
    """The plain counterpart of ``hash_words_cuda_async``: the terms' sum
    over ``words[:count]`` as one int32 element (the sum's bits) on the
    words' device."""
    s = _sum_torch(words, count)
    return torch.tensor([s - (1 << 32) if s >> 31 else s], dtype=torch.int32,
                        device=words.device)


def hash_value(s: torch.Tensor, count: int) -> int:
    """The hash of ``count`` words from the sum tensor that
    ``hash_words_async(words, count)`` returned: the length fold and
    avalanche of ``ref.finalize``, on the host."""
    return finalize(int(s.reshape(-1)[0].item()) & _MASK, count)


def hash_words_cuda_async(words: torch.Tensor, count: int) -> torch.Tensor:
    """Launch the CUDA kernel on ``words[:count]`` (words uint32 or int32,
    1-D, contiguous, on a CUDA device; any 4-byte offset) on the current
    stream, and return at once the one-element int32 device tensor the
    terms' sum lands in (``hash_value`` finishes it). The launcher zeroes
    that tensor with a 4-byte memset on the stream: one launch, no PyTorch
    fill, no wait, no state kept between calls."""
    if not words.is_cuda:
        raise ValueError("hash_words_cuda_async needs a CUDA tensor")
    if words.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"words must be uint32, got {words.dtype}")
    if words.dim() != 1 or not words.is_contiguous():
        raise ValueError("words must be a contiguous 1-D tensor")
    if not 0 <= count <= words.shape[0]:
        raise ValueError(f"count {count} outside [0, {words.shape[0]}]")
    if count >= 1 << 32:
        raise ValueError(f"count {count} at or above 2**32 words")
    lib = library()
    with torch.cuda.device(words.device):
        out = torch.empty(1, dtype=torch.int32, device=words.device)
        err = lib.chunk_hash_launch(words.data_ptr(), count, out.data_ptr(),
                                    stream_of(words))
        check(err, "chunk_hash_launch")
        LAUNCHES.add()
    return out


def hash_words_cuda(words: torch.Tensor, count: int) -> int:
    """The CUDA kernel's hash of ``words[:count]`` (the arguments of
    ``hash_words_cuda_async``). Waits for it: one 4-byte read-back."""
    return hash_value(hash_words_cuda_async(words, count), count)


def hash_words_async(words: torch.Tensor, count=None) -> torch.Tensor:
    """Start hashing ``words[:count]`` where they live, without waiting:
    the terms' sum as a one-element int32 tensor on the words' device
    (``hash_value(sum, count)`` gives the hash), from the kernel for a CUDA
    tensor and the plain version for a CPU tensor."""
    n = int(words.shape[0]) if count is None else int(count)
    if words.is_cuda:
        return hash_words_cuda_async(words, n)
    return hash_words_torch_async(words, n)


def chunk_hash32_device(words: torch.Tensor, count=None) -> int:
    """Hash ``words[:count]`` (uint32 stream) where it lives; returns the
    Python int hash: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    n = int(words.shape[0]) if count is None else int(count)
    return hash_value(hash_words_async(words, n), n)


__all__ = ["LAUNCHES", "chunk_hash32", "chunk_hash32_device", "hash_value",
           "hash_words_async", "hash_words_cuda", "hash_words_cuda_async",
           "hash_words_np", "hash_words_torch", "hash_words_torch_async",
           "mix_terms_torch"]
