"""Card-only tests of the port's CUDA kernels (marker ``gpu``): each kernel
against its plain PyTorch version on the same CUDA tensors. Without a card
they skip. This file imports no JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances as in ``tests/test_torch_quant_pack.py``: uniform_asym words
identical; adaptive scale/zero at rtol 1e-5 / atol 1e-7 with at most 2e-3
of codes differing (the error sums are taken in another order). The hash is
exact.
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
