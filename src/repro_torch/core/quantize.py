"""Checkpoint quantization (Check-N-Run §4.2), in PyTorch.

All quantizers operate row-wise on a 2-D tensor ``x`` of shape
``(rows, dim)``: each embedding vector is quantized independently, matching
the paper's "granularity of an entire embedding vector".

Ported here: uniform symmetric / asymmetric (``uniform_quantize``, §4.2.1)
and adaptive asymmetric with the greedy range search
(``adaptive_quantize``, §4.2.3), plus ``dequantize``. The k-means variants
(§4.2.2) of the reference (``src/repro/core/quantize.py``) wait for a later
slice.

Division by a constant: the reference divides by Python numbers
(``rng / levels``, ``(max - min) / num_bins``) inside ``jax.jit``, and XLA
rewrites each such divide into a multiply by the constant's f32 reciprocal.
The port multiplies by that reciprocal explicitly (:func:`recip32`), so the
scales round as the reference's do on every device. Divisions by a tensor
stay true IEEE divides.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration for checkpoint quantization.

    Paper defaults (§4.2.3): adaptive asymmetric for <=4 bits with
    bins=25/ratio=0.5 (2b), bins=25/ratio=0.2 (3b), bins=45/ratio=0.2 (4b);
    naive asymmetric for 8 bits.
    """

    bits: int = 4
    method: str = "adaptive"  # uniform_sym | uniform_asym | adaptive
    num_bins: Optional[int] = None
    ratio: Optional[float] = None

    def resolve(self) -> "QuantConfig":
        if self.method != "adaptive":
            return self
        bins = self.num_bins
        ratio = self.ratio
        if bins is None:
            bins = 45 if self.bits >= 4 else 25
        if ratio is None:
            ratio = 0.5 if self.bits <= 2 else 0.2
        return dataclasses.replace(self, num_bins=bins, ratio=ratio)


PAPER_DEFAULTS = {
    2: QuantConfig(bits=2, method="adaptive", num_bins=25, ratio=0.5),
    3: QuantConfig(bits=3, method="adaptive", num_bins=25, ratio=0.2),
    4: QuantConfig(bits=4, method="adaptive", num_bins=45, ratio=0.2),
    8: QuantConfig(bits=8, method="uniform_asym"),
}


@dataclasses.dataclass
class Quantized:
    """Row-quantized tensor: integer codes + per-row affine params.

    ``codes``  uint8 (rows, dim)   — unpacked integer codes in [0, 2^bits-1]
    ``scale``  f32   (rows,)
    ``zero``   f32   (rows,)       — zero_point (= chosen x_min)
    """

    codes: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int = 8


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def recip32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``f32(1) / f32(value)``, correctly rounded, on ``like``'s device: the
    constant XLA multiplies by where the reference writes ``/ value``."""
    return torch.tensor(np.float32(1.0) / np.float32(value),
                        dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Uniform quantization (§4.2.1)
# ---------------------------------------------------------------------------


def _affine_quantize(x, x_min, x_max, bits):
    """Map x (rows, dim) to integer codes given per-row [x_min, x_max]."""
    levels = _const((1 << bits) - 1, x)
    rng = x_max - x_min
    scale = torch.where(rng > 0, rng * recip32((1 << bits) - 1, x),
                        torch.ones_like(rng))
    zero = x_min
    q = torch.round((torch.clamp(x, x_min[:, None], x_max[:, None])
                     - zero[:, None]) / scale[:, None])
    q = torch.clamp(q, torch.zeros_like(levels), levels)
    return q.to(torch.uint8), scale, zero


def _affine_error(x, x_min, x_max, bits):
    """Per-row squared-l2 reconstruction error for a candidate range."""
    levels = _const((1 << bits) - 1, x)
    rng = x_max - x_min
    scale = torch.where(rng > 0, rng * recip32((1 << bits) - 1, x),
                        torch.ones_like(rng))
    xc = torch.clamp(x, x_min[:, None], x_max[:, None])
    q = torch.round((xc - x_min[:, None]) / scale[:, None])
    q = torch.clamp(q, torch.zeros_like(levels), levels)
    deq = q * scale[:, None] + x_min[:, None]
    return torch.sum(torch.square(x - deq), dim=-1)


def uniform_quantize(x: torch.Tensor, bits: int,
                     symmetric: bool = False) -> Quantized:
    x = torch.as_tensor(x).to(torch.float32)
    if symmetric:
        amax = torch.amax(torch.abs(x), dim=-1)
        x_min, x_max = -amax, amax
    else:
        x_min = torch.amin(x, dim=-1)
        x_max = torch.amax(x, dim=-1)
    codes, scale, zero = _affine_quantize(x, x_min, x_max, bits)
    return Quantized(codes, scale, zero, bits=bits)


def dequantize(q: Quantized) -> torch.Tensor:
    """``codes * scale + zero`` per row, rounded ONCE to f32.

    The reference's XLA CPU build compiles this multiply-add into a fused
    multiply-add, which rounds once. Here the product is formed in f64,
    where it is exact (an 8-bit code times a 24-bit significand), and the
    sum is rounded to odd in f64 before the final rounding to f32 — which
    yields the correctly rounded f32 of the exact ``codes*scale + zero``,
    i.e. the fused result bit for bit (round-to-odd at >= 26 bits makes the
    double rounding innocuous)."""
    p = q.codes.to(torch.float64) * q.scale.to(torch.float64)[:, None]
    z = q.zero.to(torch.float64)[:, None].expand_as(p)
    s = p + z
    # TwoSum: err is the exact rounding error of s = p + z
    bz = s - p
    err = (p - (s - bz)) + (z - bz)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


# ---------------------------------------------------------------------------
# Adaptive asymmetric quantization (§4.2.3)
# ---------------------------------------------------------------------------


def adaptive_quantize(
    x: torch.Tensor,
    bits: int,
    num_bins: int = 25,
    ratio: float = 0.5,
) -> Quantized:
    """Greedy per-row range search (paper §4.2.3).

    step = (max-min)/num_bins. Each iteration evaluates shrinking either the
    lower or the upper bound by one step, keeps the better, and remembers the
    best (min,max) seen. Iterates until ``ratio`` of the original range has
    been covered, i.e. ``floor(ratio * num_bins)`` steps.
    """
    x = torch.as_tensor(x).to(torch.float32)
    x_min0 = torch.amin(x, dim=-1)
    x_max0 = torch.amax(x, dim=-1)
    step = (x_max0 - x_min0) * recip32(num_bins, x)

    n_steps = int(ratio * num_bins)

    err0 = _affine_error(x, x_min0, x_max0, bits)
    cur_min, cur_max = x_min0, x_max0
    best_min, best_max, best_err = x_min0, x_max0, err0
    for _ in range(n_steps):
        err_lo = _affine_error(x, cur_min + step, cur_max, bits)
        err_hi = _affine_error(x, cur_min, cur_max - step, bits)
        take_lo = err_lo <= err_hi
        new_min = torch.where(take_lo, cur_min + step, cur_min)
        new_max = torch.where(take_lo, cur_max, cur_max - step)
        cur_err = torch.where(take_lo, err_lo, err_hi)
        improve = cur_err < best_err
        best_min = torch.where(improve, new_min, best_min)
        best_max = torch.where(improve, new_max, best_max)
        best_err = torch.where(improve, cur_err, best_err)
        cur_min, cur_max = new_min, new_max
    codes, scale, zero = _affine_quantize(x, best_min, best_max, bits)
    return Quantized(codes, scale, zero, bits=bits)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def quantize(x: torch.Tensor, cfg: QuantConfig) -> Quantized:
    cfg = cfg.resolve()
    if cfg.method == "uniform_sym":
        return uniform_quantize(x, cfg.bits, symmetric=True)
    if cfg.method == "uniform_asym":
        return uniform_quantize(x, cfg.bits, symmetric=False)
    if cfg.method == "adaptive":
        return adaptive_quantize(x, cfg.bits, cfg.num_bins, cfg.ratio)
    raise ValueError(f"unknown quantization method {cfg.method!r}")
