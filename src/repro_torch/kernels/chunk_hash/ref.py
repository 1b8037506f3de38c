"""Host reference oracle for the 32-bit chunk content hash.

The hash is defined over the chunk's packed payload interpreted as a
little-endian uint32 word stream, zero-padded to a whole word. Because the
packed code stream's trailing bits beyond ``count * bits`` are zero by
construction (``kernels.adaptive_quant`` ORs codes into zeroed words, and
``core.packing.words_to_payload`` only truncates zero tail bytes), hashing
the device-side word array and hashing the serialized payload bytes give
the SAME value — that byte-equivalence is what lets the write path hash on
device while ``ckpt scan`` / the decode path re-derive the hash from the
stored bytes with this numpy oracle.

Construction (xxhash-style primes, all arithmetic mod 2^32):

    t_i  = mix(w_i + i * P2)        # index folding makes it order-sensitive
    acc  = sum_i t_i                # associative -> parallel partial sums
    h    = finalize(acc + n * P5)   # length folding + avalanche

The per-word terms are independent, so any blocking of the sum (Pallas
grid blocks, jnp segments) reproduces the oracle exactly.
"""

from __future__ import annotations

import numpy as np

PRIME1 = 0x9E3779B1  # 2654435761
PRIME2 = 0x85EBCA77  # 2246822519
PRIME3 = 0xC2B2AE3D  # 3266489917
PRIME5 = 0x165667B1  # 374761393

_MASK = 0xFFFFFFFF


def mix_terms_np(words: np.ndarray, start_index: int = 0) -> np.ndarray:
    """Per-word mixed terms (uint32, wraparound) — the summands of the
    hash. ``start_index`` offsets the position fold so block-partial sums
    compose."""
    w = np.ascontiguousarray(words, dtype=np.uint32)
    i = (np.arange(start_index, start_index + w.size, dtype=np.uint64)
         & _MASK).astype(np.uint32)
    t = w + i * np.uint32(PRIME2)
    t = t ^ (t >> np.uint32(15))
    t = t * np.uint32(PRIME1)
    t = t ^ (t >> np.uint32(13))
    t = t * np.uint32(PRIME3)
    return t


def finalize(acc: int, count: int) -> int:
    """Fold the word count into the accumulated sum and avalanche."""
    h = (acc + count * PRIME5) & _MASK
    h ^= h >> 16
    h = (h * PRIME1) & _MASK
    h ^= h >> 13
    h = (h * PRIME3) & _MASK
    h ^= h >> 16
    return h


def hash_words_np(words: np.ndarray) -> int:
    """Hash a uint32 word stream (numpy, host). The reference for the
    device implementations in ``ops.py`` / ``kernel.py``."""
    w = np.ascontiguousarray(words, dtype=np.uint32)
    acc = int(np.sum(mix_terms_np(w), dtype=np.uint64) & _MASK)
    return finalize(acc, w.size)


def chunk_hash32(payload: bytes) -> int:
    """Hash a serialized chunk section: little-endian uint32 view,
    zero-padded to a whole word. THE definition the manifest's
    ``ChunkRecord.hash32`` records and every verifier checks against."""
    pad = (-len(payload)) % 4
    if pad:
        payload = payload + b"\x00" * pad
    return hash_words_np(np.frombuffer(payload, dtype="<u4"))
