"""Card-only tests of the port's CUDA kernels (marker ``gpu``): each kernel
against its plain PyTorch version on the same CUDA tensors. Without a card
they skip. This file imports no JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances as in ``tests/test_torch_quant_pack.py``: uniform_asym words
identical; adaptive scale/zero at rtol 1e-5 / atol 1e-7 with at most 2e-3
of codes differing (the error sums are taken in another order). The hash is
exact. ``embedding_bag`` is bit-equal at H = 1 (a bag of one row is that
row) and within rtol/atol 1e-5 at H > 1 (the plain version may sum in
another order); ``dot_interaction`` within rtol/atol 1e-4 (the f32 dots
are summed in another order), as ``tests/test_kernels.py`` holds the
Pallas kernels.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import packing

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows(rows, dim, device, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, dim)) * rng.gamma(1.0, 1.0, (rows, 1)))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def _codes(pq):
    w = pq.words.cpu().numpy()
    return packing.unpack_bits(packing.words_to_payload(w, pq.count, pq.bits),
                               pq.bits, pq.count)


@pytest.mark.parametrize("rows,dim", [(1, 10), (1000, 64), (333, 200), (70, 1024)])
@pytest.mark.parametrize("method,bits", [("uniform_asym", b) for b in range(1, 9)]
                         + [("adaptive", b) for b in (2, 3, 4)])
def test_quant_pack_kernel_matches_plain(cuda, rows, dim, method, bits):
    from repro_torch.kernels.adaptive_quant import ops

    x = _rows(rows, dim, cuda, seed=rows + bits)
    nb, ns = ops._resolve_steps(method, bits, None, None)
    before = ops.LAUNCHES.count
    k = ops.quant_pack(x, bits=bits, method=method)
    assert ops.LAUNCHES.count == before + 1
    p = ops.quant_pack_torch(x, bits=bits, num_bins=nb, n_steps=ns)
    assert k.words.shape == p.words.shape and k.count == p.count
    if method == "uniform_asym":
        np.testing.assert_array_equal(k.words.cpu().numpy(), p.words.cpu().numpy())
    else:
        np.testing.assert_allclose(k.scale.cpu().numpy(), p.scale.cpu().numpy(),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(k.zero.cpu().numpy(), p.zero.cpu().numpy(),
                                   rtol=1e-5, atol=1e-7)
        assert (_codes(k) != _codes(p)).mean() <= 2e-3


@pytest.mark.parametrize("n", [0, 1, 1023, 1025, 524_288, 1_048_579])
def test_chunk_hash_kernel_matches_plain_and_oracle(cuda, n):
    from repro_torch.kernels.chunk_hash import ops
    from repro_torch.kernels.chunk_hash.ref import hash_words_np

    w = np.random.default_rng(n).integers(0, 2**32, size=n, dtype=np.uint32)
    w[:3] = [2**32 - 1, 2**32 - 2, 2**31][:n]
    t = torch.from_numpy(w).to(cuda)
    want = hash_words_np(w)
    assert ops.chunk_hash32_device(t) == want
    assert ops.hash_words_torch(t, n) == want
    if n > 1:
        assert ops.chunk_hash32_device(t, count=n - 1) == hash_words_np(w[:n - 1])


def test_wrappers_check_their_arguments(cuda):
    from repro_torch.kernels.adaptive_quant.ops import quant_pack_cuda
    from repro_torch.kernels.chunk_hash.ops import hash_words_cuda

    with pytest.raises(TypeError):
        quant_pack_cuda(torch.zeros((4, 8), dtype=torch.float64, device=cuda),
                        bits=4, num_bins=45, n_steps=9)
    with pytest.raises(ValueError):
        quant_pack_cuda(torch.zeros((8, 4), device=cuda).t(), bits=4,
                        num_bins=45, n_steps=9)
    with pytest.raises(ValueError):
        quant_pack_cuda(torch.zeros((4, 2048), device=cuda), bits=4,
                        num_bins=45, n_steps=9)
    with pytest.raises(ValueError):
        hash_words_cuda(torch.zeros(8, dtype=torch.int32, device=cuda), 9)


def test_cuda_tensors_never_take_the_plain_path(cuda):
    from repro_torch.kernels.adaptive_quant.ops import quant_pack
    from repro_torch.kernels.chunk_hash.ops import chunk_hash32_device

    with pytest.raises(ValueError, match="CUDA tensors go through the kernel"):
        quant_pack(torch.zeros((4, 8), device=cuda), bits=4, impl="torch")
    with pytest.raises(ValueError, match="CUDA tensors go through the kernel"):
        chunk_hash32_device(torch.zeros(8, dtype=torch.int32, device=cuda),
                            impl="torch")


EB_SHAPES = [(1 << 20, 64, 512, 1), (1000, 64, 32, 4), (512, 10, 16, 1),
             (2048, 200, 8, 7), (100, 128, 64, 2)]


@pytest.mark.parametrize("V,D,B,H", EB_SHAPES)
def test_embedding_bag_kernel_matches_plain(cuda, V, D, B, H):
    from repro_torch.kernels.embedding_bag import ops

    rng = np.random.default_rng(V + H)
    table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, V, size=(B, H)).astype(np.int32)).to(cuda)
    before = ops.LAUNCHES.count
    got = ops.embedding_bag(table, ids)
    assert ops.LAUNCHES.count == before + 1
    want = ops.embedding_bag_torch(table, ids)
    if H == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_embedding_bag_offsets_past_2_to_the_31(cuda):
    """A table of more than 2**31 values (8.6 GB): ids in its last rows
    have element offsets that an int would wrap."""
    from repro_torch.kernels.embedding_bag import ops

    V, D = 33_554_944, 64
    assert V * D > 2 ** 31
    table = torch.empty((V, D), dtype=torch.float32, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    lo = V - 4096
    table[lo:] = torch.randn((V - lo, D), generator=gen, device=cuda)
    table[:4096] = torch.randn((4096, D), generator=gen, device=cuda)
    ids = torch.randint(lo, V, (256, 1), generator=gen, device=cuda,
                        dtype=torch.int64).to(torch.int32)
    ids[:8, 0] = torch.arange(8, device=cuda, dtype=torch.int32)  # and the first rows
    got = ops.embedding_bag_cuda(table, ids)
    assert torch.equal(got, ops.embedding_bag_torch(table, ids))
    assert torch.equal(got[8:], table[ids[8:, 0].long()])
    del table
    torch.cuda.empty_cache()


def test_embedding_bag_takes_a_fields_column_as_it_lies(cuda):
    from repro_torch.kernels.embedding_bag import ops

    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(300, 16)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, 300, size=(40, 26, 3)).astype(np.int32)).to(cuda)
    for f in (0, 25):
        col = ids[:, f, :]
        assert not col.is_contiguous()
        torch.testing.assert_close(ops.embedding_bag_cuda(table, col),
                                   ops.embedding_bag_torch(table, col),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,F,D", [(64, 27, 64), (128, 40, 10), (32, 8, 16),
                                   (256, 14, 128), (512, 27, 64), (3, 2, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dot_interaction_kernel_matches_plain(cuda, B, F, D, dtype):
    from repro_torch.kernels.dot_interaction import ops

    x = torch.from_numpy(np.random.default_rng(B + F).normal(size=(B, F, D))
                         .astype(np.float32)).to(cuda).to(dtype)
    before = ops.LAUNCHES.count
    got = ops.dot_interaction(x)
    assert ops.LAUNCHES.count == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, F * (F - 1) // 2)
    torch.testing.assert_close(got, ops.dot_interaction_torch(x),
                               rtol=1e-4, atol=1e-4)


def test_new_wrappers_check_their_arguments(cuda):
    from repro_torch.kernels.dot_interaction.ops import dot_interaction_cuda
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_cuda

    table = torch.zeros((10, 4), device=cuda)
    with pytest.raises(TypeError):
        embedding_bag_cuda(table, torch.zeros((2, 1), dtype=torch.int64, device=cuda))
    with pytest.raises(TypeError):
        embedding_bag_cuda(table.double(), torch.zeros((2, 1), dtype=torch.int32,
                                                       device=cuda))
    with pytest.raises(ValueError):
        embedding_bag_cuda(table, torch.zeros((2, 0), dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        dot_interaction_cuda(torch.zeros((2, 3, 4), dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError):
        dot_interaction_cuda(torch.zeros((2, 3, 4), device=cuda).transpose(1, 2))
    with pytest.raises(ValueError):
        dot_interaction_cuda(torch.zeros((2, 1, 4), device=cuda))


def test_serving_forward_launches_each_kernel_per_batch(cuda):
    """The serve cell on the card: 26 ``embedding_bag`` launches (one per
    field) and one ``dot_interaction`` launch per batch, and the forward
    through the plain versions within 1e-2 on a probability: the model is
    bf16, and f32 dots that differ in their last bits may round to
    neighbouring bf16 values before the top MLP."""
    from repro_torch.configs import get_cell
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.kernels.dot_interaction import ops as di
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.models import dlrm
    from repro_torch.train.loop import batch_to_device

    bundle = get_cell("dlrm-rm2", "serve_p99", reduced=True, device=cuda)
    params = bundle.make_state().params
    eb.LAUNCHES.reset()
    di.LAUNCHES.reset()
    for i in range(3):
        probs = bundle.step_fn(params, batch_to_device(batch_for_cell(bundle, i), cuda))
    assert (eb.LAUNCHES.count, di.LAUNCHES.count) == (3 * 26, 3)
    plain = dlrm.serve(params, batch_to_device(batch_for_cell(bundle, 2), cuda),
                       bundle.cfg, bag=eb.embedding_bag_torch,
                       interact=di.dot_interaction_torch)
    assert probs.is_cuda and torch.isfinite(probs).all()
    torch.testing.assert_close(probs, plain, rtol=0, atol=1e-2)
