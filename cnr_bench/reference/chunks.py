"""Plain reader of Check-N-Run's store format, and the plain quantizer and
hash the chunks are judged by. Imports nothing of the program.

Frozen from the program's format (``src/repro_torch/core/manifest.py``,
``core/checkpoint.py::_encode_chunk``, ``core/packing.py``,
``kernels/chunk_hash/ref.py``, ``kernels/adaptive_quant/ops.py::
_quant_torch``):

* a manifest is JSON at ``manifests/ckpt_<step:012d>.json``; each table
  lists its chunks, each chunk its ``sections`` as ``name -> [offset,
  nbytes]`` in its payload;
* a quantized chunk holds ``indices`` (uint32 global rows, incremental
  chunks only; a full chunk covers ``row_range``), ``scale`` and ``zero``
  (float16 a row), ``codes`` (the codes as a little-endian bit stream,
  code ``p`` at bit ``bits * p``), then ``aux:<name>`` (a row's optimizer
  state, raw);
* ``hash32`` is an xxhash-style sum over the codes section read as
  little-endian uint32 words; ``crc32`` is zlib's over the whole payload;
* the quantizer is the paper's greedy range search (§4.2.3): per row,
  step = (max - min) / bins, shrink either end by a step, keep the better
  of the two, remember the best range of ``int(ratio * bins)`` steps;
  candidates are scored by ``scale² · Σ (r - round(clip(r, 0, L)))²``
  with ``r = (x - lo) · (1 / scale)``; codes ``round((clip(x) - lo) / scale)``.
"""

from __future__ import annotations

import json
import zlib
from typing import Callable, Dict, Iterable, List

import numpy as np
import torch

PRIME1 = 0x9E3779B1
PRIME2 = 0x85EBCA77
PRIME3 = 0xC2B2AE3D
PRIME5 = 0x165667B1
_MASK = 0xFFFFFFFF


def manifest_key(step: int) -> str:
    return f"manifests/ckpt_{step:012d}.json"


def load_manifest(get: Callable[[str], bytes], step: int) -> dict:
    return json.loads(get(manifest_key(step)).decode())


def section(payload: bytes, chunk: dict, name: str) -> bytes:
    off, n = chunk["sections"][name]
    return payload[off:off + n]


def chunk_rows(chunk: dict, payload: bytes) -> np.ndarray:
    """The global rows a chunk holds, in its order."""
    if "indices" in chunk["sections"]:
        return np.frombuffer(section(payload, chunk, "indices"), dtype="<u4").astype(np.int64)
    lo, hi = chunk["row_range"]
    return np.arange(lo, hi, dtype=np.int64)


def unpack(buf: bytes, bits: int, count: int, device) -> torch.Tensor:
    """Codes (count,) int64 from a little-endian bit stream."""
    raw = torch.frombuffer(bytearray(buf), dtype=torch.uint8).to(device).to(torch.int64)
    stream = ((raw[:, None] >> torch.arange(8, device=device)) & 1).reshape(-1)
    stream = stream[:count * bits].reshape(count, bits)
    return (stream << torch.arange(bits, device=device)).sum(dim=1)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK


def hash32(payload: bytes, device) -> int:
    """The 32-bit content hash of a section (zero-padded to whole words)."""
    pad = (-len(payload)) % 4
    data = bytearray(payload + b"\x00" * pad)
    if not data:
        w = torch.zeros(0, dtype=torch.int64, device=device)
    else:
        w = torch.frombuffer(data, dtype=torch.int32).to(device).to(torch.int64) & _MASK
    i = torch.arange(w.numel(), dtype=torch.int64, device=device)
    t = (w + _mul32(i, PRIME2)) & _MASK
    t = t ^ (t >> 15)
    t = _mul32(t, PRIME1)
    t = t ^ (t >> 13)
    t = _mul32(t, PRIME3)
    acc = int(t.sum().item()) & _MASK
    h = (acc + w.numel() * PRIME5) & _MASK
    h ^= h >> 16
    h = (h * PRIME1) & _MASK
    h ^= h >> 13
    h = (h * PRIME3) & _MASK
    h ^= h >> 16
    return h


def quantize(x: torch.Tensor, bits: int, num_bins: int, ratio: float):
    """Row-wise adaptive quantization of ``x`` (rows, dim) f32 →
    (codes int64, scale f32 (rows,), zero f32 (rows,))."""
    x = x.to(torch.float32)
    n_steps = int(ratio * num_bins)
    levels = torch.tensor(float((1 << bits) - 1), device=x.device)
    inv_levels = torch.tensor(np.float32(1.0) / np.float32((1 << bits) - 1), device=x.device)
    inv_bins = torch.tensor(np.float32(1.0) / np.float32(num_bins), device=x.device)
    zero_t = torch.zeros_like(levels)

    def err(lo, hi):
        s = torch.where(hi - lo > 0, (hi - lo) * inv_levels, torch.ones_like(lo))
        r = (x - lo) * torch.reciprocal(s)
        d = r - torch.round(torch.clamp(r, zero_t, levels))
        return torch.square(s) * torch.sum(torch.square(d), dim=1, keepdim=True)

    lo0 = torch.amin(x, dim=-1, keepdim=True)
    hi0 = torch.amax(x, dim=-1, keepdim=True)
    best_lo, best_hi = lo0, hi0
    if n_steps:
        step = (hi0 - lo0) * inv_bins
        best_err = err(lo0, hi0)
        cur_lo, cur_hi = lo0, hi0
        for _ in range(n_steps):
            e_lo, e_hi = err(cur_lo + step, cur_hi), err(cur_lo, cur_hi - step)
            take_lo = e_lo <= e_hi
            new_lo = torch.where(take_lo, cur_lo + step, cur_lo)
            new_hi = torch.where(take_lo, cur_hi, cur_hi - step)
            cur = torch.where(take_lo, e_lo, e_hi)
            better = cur < best_err
            best_lo = torch.where(better, new_lo, best_lo)
            best_hi = torch.where(better, new_hi, best_hi)
            best_err = torch.where(better, cur, best_err)
            cur_lo, cur_hi = new_lo, new_hi
    rng = best_hi - best_lo
    scale = torch.where(rng > 0, rng * inv_levels, torch.ones_like(rng))
    q = torch.round((torch.clamp(x, best_lo, best_hi) - best_lo) / scale)
    codes = torch.clamp(q, zero_t, levels).to(torch.int64)
    return codes, scale[:, 0], best_lo[:, 0]


def dequantize(codes: torch.Tensor, scale16: torch.Tensor, zero16: torch.Tensor) -> torch.Tensor:
    """``codes * scale + zero`` with the stored float16 scale and zero."""
    return codes.to(torch.float32) * scale16.to(torch.float32)[:, None] + zero16.to(torch.float32)[:, None]


def stored_rows(get: Callable[[str], bytes], man: dict) -> Dict[str, np.ndarray]:
    """Each table's stored rows, in chunk order (an incremental save's)."""
    out = {}
    for name, t in man["tables"].items():
        rows = [chunk_rows(c, get(c["key"])) for c in t["chunks"]]
        out[name] = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    return out


def full_rows_wrong(man: dict) -> int:
    """Rows a full save leaves out or stores twice: its chunks' row ranges
    have to tile every table."""
    wrong = 0
    for t in man["tables"].values():
        cur = 0
        for lo, hi in sorted(tuple(c["row_range"]) for c in t["chunks"]):
            wrong += max(lo - cur, 0) + max(min(hi, cur) - lo, 0)
            cur = max(cur, hi)
        wrong += abs(t["rows"] - cur)
    return wrong


def selection_wrong(stored: Dict[str, np.ndarray], expected: Dict[str, np.ndarray]) -> int:
    """Rows an increment stores that it should not, rows it should and
    does not, and rows it stores twice."""
    wrong = 0
    for name, want in expected.items():
        got = stored.get(name, np.zeros(0, np.int64))
        wrong += int(np.setxor1d(got, want).size) + int(got.size - np.unique(got).size)
    return wrong


def check_save(get: Callable[[str], bytes], step: int, snap, sample: Iterable[int],
               device) -> Dict[str, float]:
    """Judge the save of ``step`` against the snapshot it was made from.

    * ``hash_bad``: chunks whose crc32 or hash32 is not their payload's;
    * ``raw_wrong``: optimizer-state values of the checked chunks and
      dense values that differ from the snapshot's;
    * ``code_mismatch``: share of the checked chunks' values whose decoded
      value differs from the plain quantizer's of the snapshot's rows
      (``sample``: indices into the manifest's quantized chunks).
    """
    man = load_manifest(get, step)
    hash_bad = raw_wrong = 0
    mismatched = values = 0
    quantized: List[tuple] = []
    for name, t in sorted(man["tables"].items()):
        for c in t["chunks"]:
            payload = get(c["key"])
            if len(payload) != c["nbytes"] or (zlib.crc32(payload) & _MASK) != c["crc32"]:
                hash_bad += 1
            primary = "codes" if "codes" in c["sections"] else "values"
            if c.get("hash32") is not None and hash32(section(payload, c, primary), device) != c["hash32"]:
                hash_bad += 1
            if t["bits"] is not None:
                quantized.append((name, t, c))
    q = man["quant"]
    for i in sorted(set(sample)):
        if i >= len(quantized):
            continue
        name, t, c = quantized[i]
        payload = get(c["key"])
        idx = chunk_rows(c, payload)
        n, dim = idx.size, t["dim"]
        codes = unpack(section(payload, c, "codes"), t["bits"], n * dim, device).reshape(n, dim)
        scale16 = torch.frombuffer(bytearray(section(payload, c, "scale")), dtype=torch.float16).to(device)
        zero16 = torch.frombuffer(bytearray(section(payload, c, "zero")), dtype=torch.float16).to(device)
        x = torch.from_numpy(np.ascontiguousarray(snap.tables[name][idx])).to(device)
        r_codes, r_scale, r_zero = quantize(x, q["bits"], q["num_bins"], q["ratio"])
        got_v = dequantize(codes, scale16, zero16)
        want_v = dequantize(r_codes, r_scale.to(torch.float16), r_zero.to(torch.float16))
        mismatched += int((got_v != want_v).sum().item())
        values += n * dim
        for aux, dtype in t["row_state"].items():
            stored_aux = np.frombuffer(section(payload, c, f"aux:{aux}"), dtype=dtype)
            raw_wrong += int((stored_aux != snap.row_state[name][aux][idx]).sum())
    for key, d in man["dense"].items():
        blob = np.frombuffer(get(d["key"]), dtype=d["dtype"]).reshape(d["shape"])
        ref = snap.dense.get(key)
        raw_wrong += blob.size if ref is None or ref.shape != blob.shape else int((blob != ref).sum())
    return dict(hash_bad=float(hash_bad), raw_wrong=float(raw_wrong),
                code_mismatch=mismatched / max(values, 1))


def n_quantized_chunks(get: Callable[[str], bytes], step: int) -> int:
    man = load_manifest(get, step)
    return sum(len(t["chunks"]) for t in man["tables"].values() if t["bits"] is not None)
