"""Checkpoint quantization ops: the CUDA kernels and their plain PyTorch
twins.

* ``quant_pack`` returns the packed little-endian word stream (plus per-row
  scale/zero) where the input lives: for a CUDA tensor through the
  hand-written kernel (``csrc/quant_pack.cu``), for a CPU tensor through the
  plain version. The packed words — ``bits/8`` bytes per code — are the only
  thing that has to cross to the host.
* ``quant_codes`` runs the same quantizer but skips the pack, so the host
  ``pack_bits`` fallback path consumes identical codes and the fused and
  fallback chunk payloads stay byte-identical.

Both support ``method`` "adaptive" (greedy search, §4.2.3) and
"uniform_asym" (§4.2.1, the search degenerated to zero steps). The search
scores a candidate range by its r-space error
``scale² · Σ (r - round(clip(r)))²`` with ``r = (x - lo) · (1/scale)``, as
the reference does (``src/repro/kernels/adaptive_quant/ops.py``).

* ``adaptive_quant`` is the older unpacked op (uint8 codes plus per-row
  scale/zero), the public entry point the reference exports from
  ``repro.kernels``: the hand-written kernel (``csrc/adaptive_quant.cu``)
  for a CUDA tensor, ``core.quantize.adaptive_quantize`` (its plain
  version, the textbook dequantize round-trip error) for a CPU tensor.

Every op dispatches on where its input lives: a CUDA tensor goes through
the kernel, a CPU tensor through the plain version.
"""

from __future__ import annotations

import dataclasses

import torch

from ...core import packing
from ...core.quantize import Quantized, adaptive_quantize, recip32
from ..build import LaunchCounter, check, library, stream_of

LAUNCHES = LaunchCounter()                 # quant_pack kernel launches
ADAPTIVE_QUANT_LAUNCHES = LaunchCounter()  # adaptive_quant kernel launches

# Row widths the kernels take: up to 1,024 a row lies in one lane group's
# registers (at most 32 values a lane); past that, the wide route spreads a
# row over a block of 256 threads, at most 32 values a thread.
MAX_DIM = 8192


@dataclasses.dataclass
class PackedQuant:
    """Device-packed quantization result.

    ``words``  uint32 (ceil(count*bits/32),) — the little-endian bit stream
               (``core.packing.words_to_payload`` turns it into the exact
               ``pack_bits`` byte payload)
    ``scale``  f32 (rows,)
    ``zero``   f32 (rows,)
    ``count``  number of valid codes (= rows * dim)
    """

    words: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    count: int


def _resolve_steps(method: str, bits: int, num_bins, ratio):
    """→ (num_bins, n_steps); n_steps == 0 means plain uniform asym."""
    if method == "uniform_asym":
        return 1, 0
    if method != "adaptive":
        raise ValueError(f"unsupported fused-quant method {method!r}")
    if num_bins is None:
        num_bins = 45 if bits >= 4 else 25
    if ratio is None:
        ratio = 0.5 if bits <= 2 else 0.2
    return num_bins, int(ratio * num_bins)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _err_pair(x, lo1, hi1, lo2, hi2, levels, inv_levels):
    """Both greedy candidates' errors, (rows, 1) each — the reference's
    ``_err_pair`` term for term."""
    one = torch.ones_like(lo1)
    s1 = torch.where(hi1 - lo1 > 0, (hi1 - lo1) * inv_levels, one)
    s2 = torch.where(hi2 - lo2 > 0, (hi2 - lo2) * inv_levels, one)
    r1 = (x - lo1) * torch.reciprocal(s1)
    r2 = (x - lo2) * torch.reciprocal(s2)
    zero = torch.zeros_like(levels)
    d1 = r1 - torch.round(torch.clamp(r1, zero, levels))
    d2 = r2 - torch.round(torch.clamp(r2, zero, levels))
    e1 = torch.sum(torch.square(d1), dim=1, keepdim=True)
    e2 = torch.sum(torch.square(d2), dim=1, keepdim=True)
    return torch.square(s1) * e1, torch.square(s2) * e2


def _quant_torch(x: torch.Tensor, bits: int, num_bins: int, n_steps: int):
    """The quantizer both plain paths share: r-space greedy search (or
    none), then the exact affine code emission. → (codes uint8 (rows, dim),
    scale (rows,), zero (rows,))."""
    x = x.to(torch.float32)
    levels = torch.tensor(float((1 << bits) - 1), device=x.device)
    inv_levels = recip32((1 << bits) - 1, x)
    x_min0 = torch.amin(x, dim=-1, keepdim=True)
    x_max0 = torch.amax(x, dim=-1, keepdim=True)
    best_min, best_max = x_min0, x_max0
    if n_steps:
        step = (x_max0 - x_min0) * recip32(num_bins, x)
        best_err, _ = _err_pair(x, x_min0, x_max0, x_min0, x_max0, levels,
                                inv_levels)
        cur_min, cur_max = x_min0, x_max0
        for _ in range(n_steps):
            err_lo, err_hi = _err_pair(x, cur_min + step, cur_max,
                                       cur_min, cur_max - step, levels,
                                       inv_levels)
            take_lo = err_lo <= err_hi
            new_min = torch.where(take_lo, cur_min + step, cur_min)
            new_max = torch.where(take_lo, cur_max, cur_max - step)
            cur_err = torch.where(take_lo, err_lo, err_hi)
            improve = cur_err < best_err
            best_min = torch.where(improve, new_min, best_min)
            best_max = torch.where(improve, new_max, best_max)
            best_err = torch.where(improve, cur_err, best_err)
            cur_min, cur_max = new_min, new_max
    rng = best_max - best_min
    scale = torch.where(rng > 0, rng * inv_levels, torch.ones_like(rng))
    q = torch.round((torch.clamp(x, best_min, best_max) - best_min) / scale)
    codes = torch.clamp(q, torch.zeros_like(levels), levels).to(torch.uint8)
    return codes, scale[:, 0], best_min[:, 0]


def _pack_torch(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Flat uint8 codes → the little-endian uint32 word stream (code ``p``
    at stream bit ``bits*p``), ``ceil(count*bits/32)`` words, tail bits
    zero. Works in int64: PyTorch has no uint32 shifts."""
    count = codes.numel()
    flat = codes.reshape(-1).to(torch.int64)
    pad = (-count) % 32
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    g = flat.reshape(-1, 32)
    cols = [g.new_zeros(g.shape[0]) for _ in range(bits)]
    for j in range(32):
        bitpos = bits * j
        wi, sh = bitpos >> 5, bitpos & 31
        cols[wi] = cols[wi] | ((g[:, j] << sh) & 0xFFFFFFFF)
        if sh + bits > 32:
            cols[wi + 1] = cols[wi + 1] | (g[:, j] >> (32 - sh))
    words = torch.stack(cols, dim=1).reshape(-1)
    return words[:(count * bits + 31) // 32].to(torch.uint32)


def quant_pack_torch(x: torch.Tensor, *, bits: int, num_bins: int,
                     n_steps: int) -> PackedQuant:
    """The plain PyTorch version of the kernel, on ``x``'s device."""
    rows, dim = x.shape
    if rows * dim == 0:
        z = x.new_zeros((rows,), dtype=torch.float32)
        return PackedQuant(x.new_zeros((0,), dtype=torch.uint32), z, z, bits, 0)
    codes, scale, zero = _quant_torch(x, bits, num_bins, n_steps)
    return PackedQuant(_pack_torch(codes, bits), scale, zero, bits, rows * dim)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


def _check_rows(x: torch.Tensor, bits: int, what: str):
    """The arguments both row-wise kernels take: f32 (rows, dim),
    contiguous, on a CUDA device, dim <= MAX_DIM (8,192; the wide route
    past 1,024), 1 <= bits <= 8, rows < 2^31. → (rows, dim)."""
    if not x.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 2-D tensor")
    rows, dim = x.shape
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"dim {dim} outside [1, {MAX_DIM}]: the kernels hold a "
                         f"row in registers, at most 32 values a thread")
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows do not fit the kernel's int rows")
    return rows, dim


def quant_pack_cuda(x: torch.Tensor, *, bits: int, num_bins: int,
                    n_steps: int) -> PackedQuant:
    """The hand-written Hopper kernel. ``x`` f32 (rows, dim), contiguous,
    on a CUDA device, dim <= 8,192 (rows wider than 1,024 take the wide
    route, a block a row), 1 <= bits <= 8."""
    rows, dim = _check_rows(x, bits, "quant_pack_cuda")
    count = rows * dim
    nwords = (count * bits + 31) // 32
    words = torch.empty(nwords, dtype=torch.uint32, device=x.device)
    scale = torch.empty(rows, dtype=torch.float32, device=x.device)
    zero = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        lib = library()
        with torch.cuda.device(x.device):
            err = lib.quant_pack_launch(
                x.data_ptr(), words.data_ptr(), scale.data_ptr(),
                zero.data_ptr(), rows, dim, bits, num_bins, n_steps, nwords,
                stream_of(x))
            check(err, "quant_pack_launch")
            LAUNCHES.add()
    return PackedQuant(words, scale, zero, bits, count)


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------


def quant_pack(x: torch.Tensor, *, bits: int, method: str = "adaptive",
               num_bins=None, ratio=None) -> PackedQuant:
    """Fused quantize + bit-pack: (rows, dim) f32 → packed uint32 words +
    per-row scale/zero, entirely on ``x``'s device."""
    num_bins, n_steps = _resolve_steps(method, bits, num_bins, ratio)
    if x.is_cuda:
        return quant_pack_cuda(x, bits=bits, num_bins=num_bins,
                               n_steps=n_steps)
    return quant_pack_torch(x, bits=bits, num_bins=num_bins, n_steps=n_steps)


def quant_codes(x: torch.Tensor, *, bits: int, method: str = "adaptive",
                num_bins=None, ratio=None) -> Quantized:
    """The fused-path quantizer WITHOUT the pack — for the host
    ``pack_bits`` fallback and as the unpacked decode oracle. Codes equal
    :func:`quant_pack`'s: the kernel path runs the kernel and unpacks its
    words, the plain path shares ``_quant_torch``."""
    rows, dim = x.shape
    num_bins, n_steps = _resolve_steps(method, bits, num_bins, ratio)
    if not x.is_cuda:
        codes, scale, zero = _quant_torch(x, bits, num_bins, n_steps)
        return Quantized(codes, scale, zero, bits=bits)
    pq = quant_pack_cuda(x, bits=bits, num_bins=num_bins, n_steps=n_steps)
    codes = packing.unpack_bits(
        packing.words_to_payload(pq.words.cpu().numpy(), pq.count, bits),
        bits, pq.count).reshape(rows, dim)
    return Quantized(torch.from_numpy(codes).to(x.device), pq.scale,
                     pq.zero, bits=bits)


# ---------------------------------------------------------------------------
# The unpacked op
# ---------------------------------------------------------------------------


def adaptive_quant_cuda(x: torch.Tensor, *, bits: int, num_bins: int,
                        ratio: float) -> Quantized:
    """The hand-written Hopper kernel of the unpacked op. ``x`` f32
    (rows, dim), contiguous, on a CUDA device, dim <= 8,192 (the wide route
    past 1,024), 1 <= bits <= 8."""
    rows, dim = _check_rows(x, bits, "adaptive_quant_cuda")
    if num_bins < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}")
    codes = torch.empty((rows, dim), dtype=torch.uint8, device=x.device)
    scale = torch.empty(rows, dtype=torch.float32, device=x.device)
    zero = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        lib = library()
        with torch.cuda.device(x.device):
            err = lib.adaptive_quant_launch(
                x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                zero.data_ptr(), rows, dim, bits, num_bins,
                int(ratio * num_bins), stream_of(x))
            check(err, "adaptive_quant_launch")
            ADAPTIVE_QUANT_LAUNCHES.add()
    return Quantized(codes, scale, zero, bits=bits)


def adaptive_quant(x: torch.Tensor, bits: int = 4, num_bins: int = 45,
                   ratio: float = 0.2) -> Quantized:
    """Row-wise adaptive asymmetric quantization (paper §4.2.3), unpacked:
    (rows, dim) → uint8 codes (rows, dim), scale and zero (rows,), where
    ``x`` lives: the kernel for a CUDA tensor, the plain version
    (``core.quantize.adaptive_quantize``) for a CPU tensor."""
    if x.is_cuda:
        return adaptive_quant_cuda(x, bits=bits, num_bins=num_bins, ratio=ratio)
    return adaptive_quantize(x, bits, num_bins, ratio)
