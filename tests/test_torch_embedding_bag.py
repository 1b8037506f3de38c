"""The port's ``embedding_bag`` op against the reference's Pallas kernel.

The same numpy inputs (seeded) go through ``repro.kernels.embedding_bag``
in interpret mode (the Pallas kernel run on the CPU, as
``tests/test_kernels.py`` runs it) and through the port's op on CPU
tensors, which runs the plain version. Shapes are ``tests/test_kernels.py``'s
embedding-bag sweep. Tolerance rtol = atol = 1e-5 (that test's bar): the
bag sums are taken in another order. At H = 1 a bag sum is the row
itself, so there the two agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag as ref_embedding_bag
from repro_torch.kernels.embedding_bag import (
    LAUNCHES,
    embedding_bag,
    embedding_bag_cuda,
    embedding_bag_np,
    embedding_bag_torch,
)
from repro_torch.models.embedding import lookup_fields

SHAPES = [(1000, 64, 32, 4), (512, 10, 16, 1), (2048, 200, 8, 7), (100, 128, 64, 2)]


def _inputs(V, D, B, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(V, D)).astype(np.float32),
            rng.integers(0, V, size=(B, H)).astype(np.int32))


@pytest.mark.parametrize("V,D,B,H", SHAPES)
def test_plain_version_matches_the_pallas_kernel(V, D, B, H):
    table, ids = _inputs(V, D, B, H, seed=V + H)
    want = np.asarray(ref_embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                        impl="interpret"))
    before = LAUNCHES.count
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids))
    assert LAUNCHES.count == before  # a CPU tensor never reaches the kernel
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), embedding_bag_np(table, ids),
                               rtol=1e-5, atol=1e-5)
    if H == 1:
        np.testing.assert_array_equal(got.numpy(), want)


def test_a_fields_column_of_the_id_tensor():
    """``lookup_fields`` hands each field's (B, H) column of the (B, F, H)
    ids to the op as it lies (not contiguous)."""
    rng = np.random.default_rng(3)
    tabs = {f"emb_{f}": rng.normal(size=(50 + f, 8)).astype(np.float32)
            for f in range(3)}
    ids = np.stack([rng.integers(0, 50, size=(6, 2)) for _ in range(3)],
                   axis=1).astype(np.int32)                     # (6, 3, 2)
    got = lookup_fields({k: torch.from_numpy(v) for k, v in tabs.items()},
                        torch.from_numpy(ids))
    want = np.stack([embedding_bag_np(tabs[f"emb_{f}"], ids[:, f, :])
                     for f in range(3)], axis=1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  torch.from_numpy(want).to(torch.bfloat16)
                                  .float().numpy())


def test_cuda_wrapper_refuses_cpu_tensors():
    table, ids = _inputs(10, 4, 3, 2, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_cuda(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(
        embedding_bag_torch(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
        embedding_bag_np(table, ids))
