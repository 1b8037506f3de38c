"""The port's unpacked ``adaptive_quant`` op (on the CPU: its plain version,
``core.quantize.adaptive_quantize``) against the reference's op through the
Pallas kernel in interpret mode and against its jnp oracle, on the same
numpy inputs.

Bars are the reference's own (``tests/test_kernels.py:28-33``): scale and
zero at rtol 1e-5 / atol 1e-7, and fewer than 2e-3 of codes differing (the
error sums round in another order, which can flip a greedy decision at a
near-tie).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import dequantize as ref_dequantize
from repro.core.quantize import mean_l2_loss as ref_mean_l2_loss
from repro.kernels.adaptive_quant import adaptive_quant as ref_adaptive_quant
from repro.kernels.adaptive_quant.ref import adaptive_quant_ref
from repro_torch.core.quantize import dequantize, mean_l2_loss, uniform_quantize
from repro_torch.kernels import adaptive_quant
from repro_torch.kernels.adaptive_quant import ADAPTIVE_QUANT_LAUNCHES, adaptive_quant_cuda
from repro_torch.kernels.adaptive_quant.ties import tie_rows, tie_share


def _rows(rows, dim, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, dim)) * rng.gamma(1.0, 1.0, (rows, 1))).astype(np.float32)


def _close(got, scale, zero, codes):
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(scale), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.zero.numpy(), np.asarray(zero), rtol=1e-5, atol=1e-7)
    assert np.mean(got.codes.numpy() != np.asarray(codes)) < 2e-3


@pytest.mark.parametrize("rows,dim", [(256, 64), (512, 10), (256, 128), (512, 200)])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_matches_reference_kernel_and_oracle(rows, dim, bits):
    x = _rows(rows, dim, seed=rows + dim + bits)
    got = adaptive_quant(torch.from_numpy(x), bits=bits, num_bins=25, ratio=0.5)
    assert got.codes.dtype == torch.uint8 and got.codes.shape == (rows, dim)
    assert got.bits == bits
    ref = ref_adaptive_quant(jnp.asarray(x), bits=bits, num_bins=25, ratio=0.5,
                             impl="interpret")
    _close(got, ref.scale, ref.zero, ref.codes)
    codes, scale, zero = adaptive_quant_ref(jnp.asarray(x), bits=bits, num_bins=25,
                                            ratio=0.5)
    _close(got, scale, zero, codes)


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_adaptive_beats_uniform_l2(bits):
    """The search must beat naive asymmetric (paper Fig. 6), as the
    reference's ``test_adaptive_quant_improves_l2`` holds its kernel, and
    by the same L2 figure the reference computes."""
    x = _rows(256, 64, seed=bits)
    t = torch.from_numpy(x)
    l_ad = float(mean_l2_loss(t, dequantize(adaptive_quant(t, bits=bits, num_bins=25,
                                                           ratio=0.5))))
    l_naive = float(mean_l2_loss(t, dequantize(uniform_quantize(t, bits))))
    assert l_ad < l_naive
    ref = ref_adaptive_quant(jnp.asarray(x), bits=bits, num_bins=25, ratio=0.5,
                             impl="interpret")
    assert l_ad == pytest.approx(float(ref_mean_l2_loss(jnp.asarray(x),
                                                        ref_dequantize(ref))), rel=1e-3)


def test_cpu_tensors_never_reach_the_kernel():
    x = torch.zeros((4, 8))
    before = ADAPTIVE_QUANT_LAUNCHES.count
    adaptive_quant(x, bits=4)
    assert ADAPTIVE_QUANT_LAUNCHES.count == before
    with pytest.raises(ValueError, match="CUDA"):
        adaptive_quant_cuda(x, bits=4, num_bins=45, ratio=0.2)


# ---------------------------------------------------------------------------
# The kernel's quotient rule (csrc/adaptive_quant.cu), in numpy f32
# ---------------------------------------------------------------------------

CU = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/adaptive_quant.cu"
F32 = np.float32
MAGIC = F32(12582912.0)  # 1.5 * 2^23


def _window_unit():
    """The window per unit of levels + 1, as the kernel's source states it."""
    m = re.search(r"constexpr float kWindowUnit = ([0-9.eE+-]+)f;", CU.read_text())
    assert m, "adaptive_quant.cu no longer states kWindowUnit"
    return F32(float(m.group(1)))


def _plain_codes(a, s, levels):
    """The plain version's codes: clamp(rint(fl(a / s)), 0, levels), with
    fmaxf/fminf's NaN rule (a NaN quotient gives 0)."""
    with np.errstate(all="ignore"):
        return np.fmin(np.fmax(np.rint(a / s), F32(0)), F32(levels))


def _kernel_codes(a, s, levels, unit):
    """The kernel's rule: t = a * fl(1/s) rounded by two adds; the true
    divide, rint and clamp where |t - rint(t)| < 0.5 - window fails, with
    the threshold 0 where fl(1/s) is subnormal or 0. → (codes, divided)."""
    window = F32(levels + 1) * unit
    with np.errstate(all="ignore"):
        inv = F32(1) / s
        t = a * inv
        r = (t + MAGIC) - MAGIC
        half_w = np.where(inv >= np.finfo(np.float32).tiny, F32(0.5) - window, F32(0))
        near = ~(np.abs(t - r) < half_w)
    return np.where(near, _plain_codes(a, s, levels), r), near


def _ulp_steps(v, n):
    """v and its n f32 neighbours either side."""
    out, up, down = [v], v, v
    for _ in range(n):
        up, down = np.nextafter(up, F32(np.inf)), np.nextafter(down, F32(-np.inf))
        out += [up, down]
    return np.concatenate(out)


def _quotient_cases(levels, rng):
    """(a, s) pairs as the kernel meets them: s = fl(range * fl(1/levels))
    (1 where the range is not positive) and a = fl(clip(x) - lo), over
    ranges from subnormal to near the f32 maximum; random a, a whose
    quotient is an exact half-integer k + 1/2 (built in f64, then searched
    among its ulp neighbours), and four ulps either side of those."""
    il = F32(1) / F32(levels)
    exps = rng.integers(-149, 128, 40_000)
    lo = (rng.normal(size=exps.size) * np.exp2(np.minimum(exps, 120))).astype(F32)
    with np.errstate(all="ignore"):
        hi = (lo.astype(np.float64) + rng.uniform(0.5, 2, exps.size) * np.exp2(exps))
    hi = np.clip(hi, -3.4e38, 3.4e38).astype(F32)
    keep = np.isfinite(hi - lo) & (hi > lo)
    lo, hi = lo[keep], hi[keep]
    rng_ = hi - lo
    s = np.where(rng_ > 0, rng_ * il, F32(1)).astype(F32)
    # random values in [lo, hi], and a few beyond it, clipped as the kernel clips
    x = (lo + (rng_.astype(np.float64) * rng.uniform(-0.05, 1.05, lo.size))).astype(F32)
    a_rand = np.minimum(np.maximum(x, lo), hi) - lo
    # exact halves of every level, and their neighbours
    k = rng.integers(0, levels, lo.size)
    a_half = ((k + 0.5) * s.astype(np.float64)).astype(F32)
    a_half = np.minimum(a_half, rng_)
    a_near = _ulp_steps(a_half, 4)
    s_near = np.tile(s, 9)
    return (np.concatenate([a_rand, a_near]), np.concatenate([s, s_near]),
            np.concatenate([np.zeros(a_rand.size, bool), np.ones(a_near.size, bool)]))


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 8])
def test_kernel_quotient_rule_matches_the_divide(bits):
    """The kernel's window rule gives rint(a / s)'s code at every random
    value, exact half, ulp neighbour and subnormal or huge scale; without
    the window (threshold 0.5) over a thousand of the same cases disagree,
    so they reach what the window is for; and under 1e-3 of random
    quotients at normal scales take the divide."""
    levels = (1 << bits) - 1
    rng = np.random.default_rng(bits)
    a, s, adversarial = _quotient_cases(levels, rng)
    assert a.dtype == s.dtype == np.float32
    assert (s[s > 0] < np.finfo(np.float32).tiny).any()  # subnormal scales
    if levels <= 3:  # scales whose reciprocal is subnormal (range / levels >= 2^126)
        assert (s > 2.0 ** 126).any()
    unit = _window_unit()
    want = _plain_codes(a, s, levels)
    got, divided = _kernel_codes(a, s, levels, unit)
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, (f"{bad.size} codes differ, e.g. a={a[bad[:3]]} "
                           f"s={s[bad[:3]]}: {got[bad[:3]]} vs {want[bad[:3]]}")
    no_window, _ = _kernel_codes(a, s, levels, F32(0))
    if bits > 1:  # (at one bit no case here needs the window)
        assert (no_window != want).sum() > 1000
    normal = ~adversarial & (s >= np.finfo(np.float32).tiny) & (s < 2.0 ** 126)
    assert divided[normal].mean() < 1e-3
    # every exact half-integer quotient takes the divide
    with np.errstate(all="ignore"):
        q = a / s
    halves = adversarial & (q == np.floor(q) + F32(0.5)) & (q < levels)
    assert halves.sum() > 1000 and divided[halves].all()


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_tie_rows_put_values_at_ties(bits):
    """The card checks' adversarial rows: at least 2% of values at a tie of
    the plain version's chosen range (a half-integer quotient or one ulp
    from it), the rows' minima and maxima where they were."""
    x = torch.from_numpy(_rows(512, 64, seed=bits))
    y = tie_rows(x, bits)
    assert tie_share(x, bits) < 1e-3 < 0.02 < tie_share(y, bits)
    assert torch.equal(y.amin(dim=1), x.amin(dim=1))
    assert torch.equal(y.amax(dim=1), x.amax(dim=1))
    ref = ref_adaptive_quant(jnp.asarray(y.numpy()), bits=bits, num_bins=25, ratio=0.5,
                             impl="interpret")
    _close(adaptive_quant(y, bits=bits, num_bins=25, ratio=0.5), ref.scale, ref.zero,
           ref.codes)
