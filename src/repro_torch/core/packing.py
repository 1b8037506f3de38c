"""Host-side bit packing for quantized checkpoint payloads.

Codes are stored unpacked (uint8) on device; serialization packs them into a
dense little-endian bit stream so the on-disk/bandwidth accounting matches the
true entropy of an N-bit code (incl. the awkward 3-bit case: 8 codes / 3
bytes). Pure numpy — this runs in the background checkpoint writer, not in the
jitted training path.

Two implementations share one wire format:

* the vectorized word-wise packer (``pack_bits``/``unpack_bits``) — the
  production path. Bit widths dividing a byte (1/2/4/8) pack ``8//bits``
  codes per output byte with a handful of shift-OR column ops; the ragged
  widths (3/5/6/7) pack groups of 8 codes into ``bits`` output byte planes,
  so every op stays uint8 and touches each byte once (9-40x the bit-matrix
  version, which expanded every code to ``bits`` whole bytes).
* the original bit-matrix expansion, kept as ``pack_bits_reference`` /
  ``unpack_bits_reference`` — the oracle for equivalence tests and the
  baseline for the packing microbench in ``benchmarks/write_path.py``.
"""

from __future__ import annotations

import numpy as np


def _validate(codes: np.ndarray, bits: int) -> np.ndarray:
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    codes = np.ascontiguousarray(codes, dtype=np.uint8).reshape(-1)
    if codes.size and int(codes.max()) >= (1 << bits):
        raise ValueError(f"code out of range for {bits}-bit packing")
    return codes


def pack_bits(codes: np.ndarray, bits: int) -> bytes:
    """Pack uint8 codes (< 2**bits) into a little-endian bit stream."""
    codes = _validate(codes, bits)
    n = codes.size
    if bits == 8 or n == 0:
        return codes.tobytes()
    if 8 % bits == 0:
        # 1/2/4 bits: k codes per byte, one shift-OR column op per slot
        k = 8 // bits
        pad = (-n) % k
        if pad:
            codes = np.concatenate([codes, np.zeros(pad, np.uint8)])
        g = codes.reshape(-1, k)
        out = g[:, 0].copy()
        for j in range(1, k):
            out |= g[:, j] << (bits * j)
        return out.tobytes()
    # 3/5/6/7 bits: 8 codes -> `bits` output bytes; each code lands at bit
    # offset bits*j, spanning at most two byte planes
    pad = (-n) % 8
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, np.uint8)])
    g = codes.reshape(-1, 8)
    out = np.zeros((g.shape[0], bits), np.uint8)
    for j in range(8):
        bitpos = bits * j
        bi, sh = bitpos >> 3, bitpos & 7
        out[:, bi] |= (g[:, j] << sh).astype(np.uint8)
        if sh + bits > 8:
            out[:, bi + 1] |= g[:, j] >> (8 - sh)
    total = (n * bits + 7) // 8
    return out.tobytes()[:total]


def unpack_bits(buf: bytes, bits: int, count: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`; returns uint8 array of ``count`` codes."""
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    if count == 0:
        return np.zeros(0, np.uint8)
    if bits == 8:
        return np.frombuffer(buf, dtype=np.uint8, count=count).copy()
    raw = np.frombuffer(buf, dtype=np.uint8)
    mask = np.uint8((1 << bits) - 1)
    if 8 % bits == 0:
        k = 8 // bits
        nbytes = (count + k - 1) // k
        raw = raw[:nbytes]
        out = np.empty((raw.size, k), np.uint8)
        for j in range(k):
            out[:, j] = (raw >> (bits * j)) & mask
        return out.reshape(-1)[:count].copy()
    ngroups = (count + 7) // 8
    need = ngroups * bits
    if raw.size < need:  # stream may end mid-group; zero-extend
        raw = np.concatenate([raw, np.zeros(need - raw.size, np.uint8)])
    g = raw[:need].reshape(ngroups, bits)
    out = np.empty((ngroups, 8), np.uint8)
    for j in range(8):
        bitpos = bits * j
        bi, sh = bitpos >> 3, bitpos & 7
        c = g[:, bi] >> sh
        if sh + bits > 8:
            c = c | (g[:, bi + 1] << (8 - sh)).astype(np.uint8)
        out[:, j] = c & mask
    return out.reshape(-1)[:count].copy()


def packed_nbytes(count: int, bits: int) -> int:
    """Exact packed payload size in bytes for ``count`` N-bit codes."""
    return (count * bits + 7) // 8


def words_to_payload(words: np.ndarray, count: int, bits: int) -> bytes:
    """Serialize a device-packed uint32 word stream (the fused
    quantize+pack kernel's output) to the ``pack_bits`` wire format.

    The word stream is little-endian by construction (code ``p`` at stream
    bit ``bits*p``), so on little-endian hosts this is a plain byte view
    truncated to the exact payload length; ``astype("<u4")`` keeps
    big-endian hosts correct at the cost of one copy there.
    """
    buf = np.ascontiguousarray(words, dtype="<u4").tobytes()
    return buf[:packed_nbytes(count, bits)]


# ---------------------------------------------------------------------------
# Reference implementation (original bit-matrix expansion). Same wire format;
# kept as the correctness oracle and microbench baseline.
# ---------------------------------------------------------------------------


def pack_bits_reference(codes: np.ndarray, bits: int) -> bytes:
    codes = _validate(codes, bits)
    if bits == 8:
        return codes.tobytes()
    bit_cols = np.arange(bits, dtype=np.uint8)
    bit_matrix = (codes[:, None] >> bit_cols[None, :]) & 1  # (n, bits)
    stream = bit_matrix.reshape(-1)
    pad = (-stream.size) % 8
    if pad:
        stream = np.concatenate([stream, np.zeros(pad, dtype=np.uint8)])
    return np.packbits(stream.reshape(-1, 8), axis=-1, bitorder="little").tobytes()


def unpack_bits_reference(buf: bytes, bits: int, count: int) -> np.ndarray:
    if bits == 8:
        out = np.frombuffer(buf, dtype=np.uint8, count=count)
        return out.copy()
    raw = np.frombuffer(buf, dtype=np.uint8)
    stream = np.unpackbits(raw, bitorder="little")
    stream = stream[: count * bits].reshape(count, bits)
    weights = (1 << np.arange(bits, dtype=np.uint8)).astype(np.uint8)
    return (stream * weights[None, :]).sum(axis=-1).astype(np.uint8)
