"""The port's unpacked ``adaptive_quant`` op (on the CPU: its plain version,
``core.quantize.adaptive_quantize``) against the reference's op through the
Pallas kernel in interpret mode and against its jnp oracle, on the same
numpy inputs.

Bars are the reference's own (``tests/test_kernels.py:28-33``): scale and
zero at rtol 1e-5 / atol 1e-7, and fewer than 2e-3 of codes differing (the
error sums round in another order, which can flip a greedy decision at a
near-tie).
"""

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
