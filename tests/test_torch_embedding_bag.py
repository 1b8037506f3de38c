"""The port's ``embedding_bag`` op against the reference's Pallas kernel.

The same numpy inputs (seeded) go through ``repro.kernels.embedding_bag``
in interpret mode (the Pallas kernel run on the CPU, as
``tests/test_kernels.py`` runs it) and through the port's op on CPU
tensors, which runs the plain version. Shapes are ``tests/test_kernels.py``'s
embedding-bag sweep. Tolerance rtol = atol = 1e-5 (that test's bar): the
bag sums are taken in another order. At H = 1 a bag sum is the row
itself, so there the two agree exactly.

The multi-field op (all fields in one call, bf16 out) goes against the
reference's ``repro.models.embedding.lookup_fields`` on the same numpy
tables and ids: bit-equal at H = 1 (each bag is a row, rounded once to
bf16), within one bf16 ulp at H > 1 (f32 sums in another order may round
to the neighbouring bf16 value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag as ref_embedding_bag
from repro.models.embedding import lookup_fields as ref_lookup_fields
from repro_torch.kernels.embedding_bag import (
    LAUNCHES,
    MAX_FIELDS,
    embedding_bag,
    embedding_bag_cuda,
    embedding_bag_fields,
    embedding_bag_fields_cuda,
    embedding_bag_fields_torch,
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


# (B, F, H, D, vocabs): dlrm-rm2's 26 fields at a small vocabulary, one
# field, 40 fields, H > 1, D not a multiple of 4, unequal vocabularies
FIELDS_SHAPES = [(16, 26, 1, 64, [300] * 26), (9, 1, 1, 8, [40]),
                 (6, 40, 3, 16, [10 + f for f in range(40)]),
                 (11, 5, 4, 10, [5, 90, 31, 2, 64]), (4, 3, 7, 200, [30, 11, 96])]


def _fields_inputs(B, F, H, D, vocabs, seed):
    rng = np.random.default_rng(seed)
    tables = [rng.normal(size=(v, D)).astype(np.float32) for v in vocabs]
    ids = np.stack([rng.integers(0, v, size=(B, H)) for v in vocabs],
                   axis=1).astype(np.int32)
    return tables, ids


def _bf16_ulps(got, want):
    """|got - want| in units of want's bf16 ulp (2^(e-8) for want = m 2^e,
    m in [0.5, 1))."""
    _, e = np.frexp(want)
    return np.abs(got - want) / np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("B,F,H,D,vocabs", FIELDS_SHAPES)
def test_fields_plain_version_matches_the_reference_lookup(B, F, H, D, vocabs):
    tables, ids = _fields_inputs(B, F, H, D, vocabs, seed=B + F + H)
    want = ref_lookup_fields({f"emb_{f}": jnp.asarray(t) for f, t in enumerate(tables)},
                             jnp.asarray(ids))
    want = np.asarray(want.astype(jnp.float32))
    before = LAUNCHES.count
    got = embedding_bag_fields([torch.from_numpy(t) for t in tables],
                               torch.from_numpy(ids))
    assert LAUNCHES.count == before  # a CPU tensor never reaches the kernel
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, F, D)
    got = got.float().numpy()
    if H == 1:
        np.testing.assert_array_equal(got, want)
    else:
        assert _bf16_ulps(got, want).max() <= 1.0
    via_model = lookup_fields({f"emb_{f}": torch.from_numpy(t) for f, t in enumerate(tables)},
                              torch.from_numpy(ids))
    np.testing.assert_array_equal(via_model.float().numpy(), got)
    assert LAUNCHES.count == before


def test_lookup_fields_makes_one_call_of_the_op_it_is_given():
    """``lookup_fields`` calls its multi-field op once with every field's
    table, in order, and the ids as they lie; the plain version passed in
    gives the default lookup on CPU tensors, bit for bit."""
    tables, ids = _fields_inputs(7, 26, 2, 16, [50] * 26, seed=4)
    named = {f"emb_{f}": torch.from_numpy(t) for f, t in enumerate(tables)}
    it = torch.from_numpy(ids)
    calls = []

    def recording(tabs, i):
        calls.append((tabs, i))
        return embedding_bag_fields_torch(tabs, i)

    got = lookup_fields(named, it, bag=recording)
    assert len(calls) == 1 and calls[0][1] is it
    assert [t is named[f"emb_{f}"] for f, t in enumerate(calls[0][0])] == [True] * 26
    assert torch.equal(got, lookup_fields(named, it))
    assert torch.equal(got, lookup_fields(named, it, bag=embedding_bag_fields_torch))


@pytest.mark.parametrize("tables_on,ids_on", [("meta", "cpu"), ("cpu", "meta")])
def test_tensors_off_the_cpu_never_take_the_plain_version(tables_on, ids_on):
    """The plain version runs only when every tensor lies on the CPU: with
    the tables or the ids elsewhere (here on the meta device, as a card
    is not at hand) both ops go to the kernel's wrapper, which refuses
    them, and nothing is launched."""
    tables, ids = _fields_inputs(3, 2, 1, 4, [10, 10], seed=0)
    tt = [torch.from_numpy(t).to(tables_on) for t in tables]
    it = torch.from_numpy(ids).to(ids_on)
    before = LAUNCHES.count
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_fields(tt, it)
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag(tt[0], it[:, 0, :])
    assert LAUNCHES.count == before


def test_fields_cuda_wrapper_refuses_what_the_kernel_cannot_take():
    tables, ids = _fields_inputs(3, 2, 1, 4, [10, 10], seed=0)
    tt, it = [torch.from_numpy(t) for t in tables], torch.from_numpy(ids)
    with pytest.raises(ValueError, match="CUDA"):  # CPU tensors
        embedding_bag_fields_cuda(tt, it)
    with pytest.raises(ValueError, match="CUDA"):  # mixed devices
        embedding_bag_fields_cuda([tt[0], torch.empty((10, 4), device="meta")],
                                  it.to("meta"))
    with pytest.raises(ValueError, match=f"1 to {MAX_FIELDS}"):
        embedding_bag_fields_cuda([tt[0]] * (MAX_FIELDS + 1),
                                  torch.zeros((3, MAX_FIELDS + 1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match=f"1 to {MAX_FIELDS}"):
        embedding_bag_fields_cuda([], torch.zeros((3, 0, 1), dtype=torch.int32))
