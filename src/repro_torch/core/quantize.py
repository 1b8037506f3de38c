"""Checkpoint quantization (Check-N-Run §4.2), in PyTorch.

All quantizers operate row-wise on a 2-D tensor ``x`` of shape
``(rows, dim)``: each embedding vector is quantized independently, matching
the paper's "granularity of an entire embedding vector".

The reference's quantizers (``src/repro/core/quantize.py``): uniform
symmetric / asymmetric (``uniform_quantize``, §4.2.1), adaptive asymmetric
with the greedy range search (``adaptive_quantize``, §4.2.3), the k-means
variants (§4.2.2: per vector, per contiguous row block, and the 2-tier
clustered one, with ``kmeans_dequantize``), plus ``dequantize`` and the
paper's error metric ``mean_l2_loss``. The k-means variants are off the
store path: ``quantize`` dispatches only the uniform and adaptive methods,
as the reference's does.

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


@dataclasses.dataclass
class KmeansQuantized:
    """codes uint8 (rows, dim); codebook f32 (rows_or_blocks, 2^bits)."""

    codes: torch.Tensor
    codebook: torch.Tensor
    block_ids: Optional[torch.Tensor] = None  # (rows,) for block variants
    bits: int = 4


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


def _fma32(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """``codes * scale + zero`` (scale and zero broadcast against codes),
    rounded ONCE to f32: the product is formed in f64, where it is exact
    (an 8-bit code times a 24-bit significand), and the sum is rounded to
    odd in f64 before the final rounding to f32 — which yields the
    correctly rounded f32 of the exact sum (round-to-odd at >= 26 bits
    makes the double rounding innocuous)."""
    p = codes.to(torch.float64) * scale.to(torch.float64)
    z = zero.to(torch.float64).expand_as(p)
    s = p + z
    # TwoSum: err is the exact rounding error of s = p + z
    bz = s - p
    err = (p - (s - bz)) + (z - bz)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def dequantize(q: Quantized) -> torch.Tensor:
    """``codes * scale + zero`` per row, rounded ONCE to f32: the
    reference's XLA CPU build compiles this multiply-add into a fused
    multiply-add, which rounds once, and ``_fma32`` gives that result bit
    for bit. Where a row has more values than its codes have levels
    (2^bits), each row's 2^bits results are computed once and the codes
    look them up: the same numbers, at a 2^bits / dim share of the f64
    arithmetic (the restore path's decode is bound by this function)."""
    codes, scale, zero = q.codes, q.scale, q.zero
    n_levels = 1 << q.bits
    if codes.dim() == 2 and n_levels < codes.shape[1]:
        levels = torch.arange(n_levels, dtype=torch.float32, device=codes.device)
        table = _fma32(levels[None, :], scale[:, None], zero[:, None])
        return torch.gather(table, 1, codes.to(torch.int64))
    return _fma32(codes, scale[:, None], zero[:, None])


def mean_l2_loss(x: torch.Tensor, deq: torch.Tensor) -> torch.Tensor:
    """Paper metric: (1/m) * sum_i ||X_i - Q_i||_2  (mean of row l2 norms)."""
    return torch.mean(torch.linalg.vector_norm(x.to(torch.float32) - deq, dim=-1))


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
# K-means quantization (§4.2.2)
# ---------------------------------------------------------------------------
#
# The reference runs these under ``jax.jit`` and ``vmap``; here each batch of
# independent problems (rows, or row blocks) runs as one set of tensor ops.
# Segment sums are ``index_add_`` into f64, rounded to f32 once: on a card
# the adds are atomics in no fixed order, and an f32 sum of the ~32k values
# a centroid of a row block gathers moves by ~1e-5 with the order (an f64
# sum by ~1e-12), so the card's centroids match the CPU's to the last f32
# bit but where a sum lands on a rounding boundary. The reference sums in
# f32, in index order.


def _quantile_init(values: torch.Tensor, k: int) -> torch.Tensor:
    """``jnp.quantile(values, (arange(k) + 0.5) / k)`` along the last axis,
    with its linear interpolation, for each leading index: a sort, then
    the two neighbours of position ``q * (n - 1)`` (computed in f32, as
    JAX computes it) weighted by the position's fraction. ``torch.quantile``
    is not used: it refuses inputs of more than 2^24 elements."""
    n = values.shape[-1]
    srt = torch.sort(values, dim=-1).values
    qs = (torch.arange(k, dtype=torch.float32, device=values.device) + 0.5) / k
    n_f = torch.tensor(n, dtype=torch.float32, device=values.device)
    pos = qs * (n_f - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    low = torch.clamp(low, torch.zeros_like(n_f), n_f - 1).to(torch.int64)
    high = torch.clamp(high, torch.zeros_like(n_f), n_f - 1).to(torch.int64)
    return srt[..., low] * low_w + srt[..., high] * high_w


def _segment_mean(values: torch.Tensor, seg: torch.Tensor,
                  prev: torch.Tensor) -> torch.Tensor:
    """Lloyd's update: the mean of the ``values`` (rows of them, if 2-D)
    that ``seg`` assigns to each of ``prev``'s rows, summed in f64 and
    rounded to f32 once; a row no value is assigned to keeps ``prev``'s
    (an empty cluster keeps its centroid)."""
    n = prev.shape[0]
    sums = torch.zeros(prev.shape, dtype=torch.float64, device=values.device)
    sums = sums.index_add_(0, seg, values.to(torch.float64)).to(torch.float32)
    cnts = torch.zeros((n,), dtype=torch.float64, device=values.device).index_add_(
        0, seg, torch.ones(seg.shape, dtype=torch.float64, device=values.device))
    cnts = cnts.to(torch.float32).view((n,) + (1,) * (prev.dim() - 1))
    return torch.where(cnts > 0, sums / torch.clamp(cnts, min=1.0), prev)


def _kmeans_1d(values: torch.Tensor, k: int, iters: int):
    """Lloyd's algorithm on each row of ``values`` (G, n), a flat value set
    per row. Returns (codes uint8 (G, n), centroids f32 (G, k)).

    Deterministic quantile init (avoids the paper's noted 4-bit cluster-init
    randomness regression); a value goes to its nearest centroid, the lower
    index on a tie, as ``argmin`` picks."""
    g = values.shape[0]
    cent = _quantile_init(values, k)

    def assign(cent):
        return torch.argmin(torch.abs(values[:, :, None] - cent[:, None, :]), dim=-1)

    for _ in range(iters):
        seg = (assign(cent) + k * torch.arange(g, device=values.device)[:, None]).reshape(-1)
        cent = _segment_mean(values.reshape(-1), seg, cent.reshape(-1)).view(g, k)
    return assign(cent).to(torch.uint8), cent.to(torch.float32)


def kmeans_quantize(x: torch.Tensor, bits: int, iters: int = 15) -> KmeansQuantized:
    """Per-vector k-means (one codebook per embedding row)."""
    x = torch.as_tensor(x).to(torch.float32)
    codes, books = _kmeans_1d(x, 1 << bits, iters)
    return KmeansQuantized(codes, books, bits=bits)


def kmeans_block_quantize(x: torch.Tensor, bits: int, n_blocks: int,
                          iters: int = 15) -> KmeansQuantized:
    """K-means over ``n_blocks`` contiguous row blocks (shared codebook/block)."""
    x = torch.as_tensor(x).to(torch.float32)
    rows, dim = x.shape
    assert rows % n_blocks == 0, "rows must divide n_blocks for the benchmark"
    xb = x.reshape(n_blocks, (rows // n_blocks) * dim)
    codes, books = _kmeans_1d(xb, 1 << bits, iters)
    block_ids = torch.repeat_interleave(
        torch.arange(n_blocks, dtype=torch.int32, device=x.device), rows // n_blocks)
    return KmeansQuantized(codes.reshape(rows, dim), books, block_ids, bits=bits)


def _linspace_index(stop: int, num: int, device) -> torch.Tensor:
    """``jnp.linspace(0, stop, num).astype(int32)`` as the reference's jit
    computes it in f32: ``stop * (i * (1 / (num - 1)))`` (XLA multiplies by
    the divisor's reciprocal), the endpoint exact, truncated toward 0."""
    if num == 1:
        return torch.zeros((1,), dtype=torch.int64, device=device)
    f32 = torch.float32
    step = torch.arange(num - 1, dtype=f32, device=device) * recip32(
        num - 1, torch.empty(0, device=device))
    out = torch.cat([torch.tensor(float(stop), dtype=f32, device=device) * step,
                     torch.tensor([float(stop)], dtype=f32, device=device)])
    return out.to(torch.int32).to(torch.int64)


def kmeans_clustered_quantize(x: torch.Tensor, bits: int, n_blocks: int,
                              iters: int = 15,
                              cluster_iters: int = 5) -> KmeansQuantized:
    """2-tier k-means (§4.2.2): cluster rows into blocks of *similar* vectors
    first, then run element k-means per block."""
    x = torch.as_tensor(x).to(torch.float32)
    rows, dim = x.shape
    k = 1 << bits

    # Tier 1: cluster the rows themselves (vector k-means, quantile-seeded on
    # the row norm ordering for determinism).
    norms = torch.sqrt(torch.sum(x * x, dim=-1))
    order = torch.argsort(norms, stable=True)
    cent = x[order[_linspace_index(rows - 1, n_blocks, x.device)]]

    def t1_assign(cent):
        d = torch.sum(torch.square(x[:, None, :] - cent[None, :, :]), dim=-1)
        return torch.argmin(d, dim=-1)

    for _ in range(cluster_iters):
        cent = _segment_mean(x, t1_assign(cent), cent)
    block_ids = t1_assign(cent).to(torch.int32)

    # Tier 2: per-block element k-means. Blocks are ragged; a masked Lloyd
    # update per block runs over the full element set.
    flat = x.reshape(-1)
    elem_block = torch.repeat_interleave(block_ids.to(torch.int64), dim)
    books = _quantile_init(flat, k)[None, :].repeat(n_blocks, 1)

    def t2_assign(books):
        return torch.argmin(torch.abs(flat[:, None] - books[elem_block]), dim=-1)

    for _ in range(iters):
        books = _segment_mean(flat, elem_block * k + t2_assign(books),
                              books.reshape(-1)).view(n_blocks, k)
    codes = t2_assign(books).to(torch.uint8)
    return KmeansQuantized(codes.reshape(rows, dim), books, block_ids, bits=bits)


def kmeans_dequantize(q: KmeansQuantized) -> torch.Tensor:
    books = q.codebook if q.block_ids is None else q.codebook[q.block_ids.to(torch.int64)]
    return torch.gather(books, -1, q.codes.to(torch.int64))


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
