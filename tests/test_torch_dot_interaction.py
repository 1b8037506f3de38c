"""The port's ``dot_interaction`` op against the reference's Pallas kernel.

The same numpy features (seeded) go through
``repro.kernels.dot_interaction`` in interpret mode (the Pallas kernel run
on the CPU, as ``tests/test_kernels.py`` runs it) and through the port's
op on CPU tensors, which runs the plain version. Shapes are
``tests/test_kernels.py``'s sweep. Tolerance rtol = atol = 1e-4 (that
test's bar): the dots are summed in another order. bf16 features are
compared with the reference's f32 oracle of the same (bf16-valued)
numbers, at 1e-4 too: both accumulate the exact bf16 products in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dot_interaction import dot_interaction as ref_dot_interaction
from repro.kernels.dot_interaction.ref import dot_interaction_ref
from repro_torch.kernels.dot_interaction import (
    LAUNCHES,
    dot_interaction,
    dot_interaction_cuda,
    dot_interaction_np,
)
from repro_torch.models import dlrm

SHAPES = [(64, 27, 64), (128, 40, 10), (32, 8, 16), (256, 14, 128)]


def _feats(B, F, D, seed):
    return np.random.default_rng(seed).normal(size=(B, F, D)).astype(np.float32)


@pytest.mark.parametrize("B,F,D", SHAPES)
def test_plain_version_matches_the_pallas_kernel(B, F, D):
    x = _feats(B, F, D, seed=B + F)
    want = np.asarray(ref_dot_interaction(jnp.asarray(x), impl="interpret"))
    before = LAUNCHES.count
    got = dot_interaction(torch.from_numpy(x))
    assert LAUNCHES.count == before  # a CPU tensor never reaches the kernel
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, F * (F - 1) // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), dot_interaction_np(x),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,F,D", SHAPES)
def test_bf16_features_accumulate_in_f32(B, F, D):
    xb = torch.from_numpy(_feats(B, F, D, seed=B * F)).to(torch.bfloat16)
    x32 = xb.float().numpy()
    got = dot_interaction(xb)
    assert got.dtype == torch.float32
    want = np.asarray(dot_interaction_ref(jnp.asarray(x32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_train_path_interaction_is_the_same_function():
    """``models.dlrm.dot_interaction`` (autograd's path in training) and
    the op give the same dots in f32."""
    x = torch.from_numpy(_feats(16, 27, 8, seed=1))
    np.testing.assert_allclose(dlrm.dot_interaction(x).numpy(),
                               dot_interaction(x).numpy(), rtol=1e-6, atol=1e-5)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        dot_interaction_cuda(torch.zeros((2, 3, 4)))
