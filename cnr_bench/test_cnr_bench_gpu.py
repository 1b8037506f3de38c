"""On the card (marker ``gpu``; skips without one): the program's
``quant_pack`` agrees with the plain quantizer value for value at the
cells' chunk shape, and its 3-bit route, the control of the encode, does
not. Run on the card: PYTHONPATH=src python -m pytest -q -m gpu cnr_bench/test_cnr_bench_gpu.py"""

import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("name", ["dlrm-rm2", "xdeepfm"])
def test_quant_pack_is_the_plain_quantizer_and_three_bits_is_not(card, name):
    from cnr_bench import bench
    from cnr_bench.control import encode_mismatch

    cfg, traffic = bench.load_config(name), bench.load_traffic("train_ckpt")
    assert encode_mismatch(cfg, traffic, 2**40 + 9, 4, card, n_chunks=2) == 0.0
    assert encode_mismatch(cfg, traffic, 2**40 + 9, 3, card, n_chunks=2) > 0.5
