"""The port's plain quantizers and fused quant_pack against the reference.

The same numpy inputs go through ``repro`` (jitted jnp, and the Pallas
kernel in interpret mode) and ``repro_torch`` (plain PyTorch, on the CPU).

Tolerances: uniform_asym words must be identical. For adaptive, scale and
zero must agree to rtol 1e-5 / atol 1e-7 and at most 2e-3 of codes may
differ — the reference's own bounds for Pallas against its oracle
(``tests/test_kernels.py``), because the greedy search's error sums are
taken in another order, and a tie can flip a decision. (On the CPU the port
in fact matches bit for bit.) ``dequantize`` must be bit-equal: the
reference's XLA CPU build fuses its multiply-add into one FMA, and the port
reproduces that single rounding.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import packing as ref_packing
from repro.kernels.adaptive_quant import quant_codes as ref_codes
from repro.kernels.adaptive_quant import quant_pack as ref_pack
from repro_torch.core import packing
from repro_torch.kernels.adaptive_quant import quant_codes, quant_pack

# the modules, not the ``quantize`` functions their packages re-export
ref_q = importlib.import_module("repro.core.quantize")
port_q = importlib.import_module("repro_torch.core.quantize")


def _rows(rows, dim, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, dim)) *
            rng.gamma(1.0, 1.0, (rows, 1))).astype(np.float32)


def _payload(pq):
    return packing.words_to_payload(pq.words.numpy(), pq.count, pq.bits)


def _assert_adaptive_close(ref_scale, ref_zero, ref_c, scale, zero, codes):
    np.testing.assert_allclose(scale, ref_scale, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(zero, ref_zero, rtol=1e-5, atol=1e-7)
    assert (np.asarray(codes) != np.asarray(ref_c)).mean() <= 2e-3


@pytest.mark.parametrize("bits", range(1, 9))
def test_uniform_asym_words_identical(bits):
    """Dims 10/64/128/200 × rows 1/33/257/1000: the port's packed stream is
    the reference's codes packed by the reference's host packer, byte for
    byte, with identical scale and zero."""
    for dim in (10, 64, 128, 200):
        x = _rows(1000, dim, seed=dim + bits)
        ref = ref_codes(jnp.asarray(x), bits=bits, method="uniform_asym",
                        impl="jnp")
        codes = np.asarray(ref.codes)
        for rows in (1, 33, 257, 1000):
            pq = quant_pack(torch.from_numpy(x[:rows]), bits=bits,
                            method="uniform_asym")
            assert _payload(pq) == ref_packing.pack_bits(codes[:rows], bits), (dim, rows)
            np.testing.assert_array_equal(pq.scale.numpy(), np.asarray(ref.scale)[:rows])
            np.testing.assert_array_equal(pq.zero.numpy(), np.asarray(ref.zero)[:rows])


@pytest.mark.parametrize("method,bits", [("uniform_asym", b) for b in range(1, 9)]
                         + [("adaptive", b) for b in (2, 3, 4)])
def test_words_match_reference_quant_pack(method, bits):
    x = _rows(1000, 64, seed=bits)
    ref = ref_pack(jnp.asarray(x), bits=bits, method=method, impl="jnp")
    pq = quant_pack(torch.from_numpy(x), bits=bits, method=method)
    assert pq.count == ref.count
    if method == "uniform_asym":
        np.testing.assert_array_equal(pq.words.numpy(), np.asarray(ref.words))
    else:
        ref_c = ref_packing.unpack_bits(_payload_np(ref), bits, ref.count)
        got_c = packing.unpack_bits(_payload(pq), bits, pq.count)
        _assert_adaptive_close(np.asarray(ref.scale), np.asarray(ref.zero),
                               ref_c, pq.scale.numpy(), pq.zero.numpy(), got_c)


def _payload_np(ref):
    return ref_packing.words_to_payload(np.asarray(ref.words), ref.count, ref.bits)


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("rows,dim", [(1000, 64), (333, 200), (70, 10)])
def test_adaptive_matches_reference(bits, rows, dim):
    x = _rows(rows, dim, seed=rows + bits)
    ref = ref_codes(jnp.asarray(x), bits=bits, method="adaptive", impl="jnp")
    q = quant_codes(torch.from_numpy(x), bits=bits, method="adaptive")
    _assert_adaptive_close(np.asarray(ref.scale), np.asarray(ref.zero),
                           np.asarray(ref.codes), q.scale.numpy(),
                           q.zero.numpy(), q.codes.numpy())


@pytest.mark.parametrize("method,bits", [("uniform_asym", 1), ("uniform_asym", 4),
                                         ("uniform_asym", 8), ("adaptive", 3),
                                         ("adaptive", 4)])
def test_matches_interpret_mode_pallas_kernel(method, bits):
    x = _rows(70, 40, seed=bits)  # ragged against the kernel's 32-row blocks
    ref = ref_pack(jnp.asarray(x), bits=bits, method=method, impl="interpret")
    pq = quant_pack(torch.from_numpy(x), bits=bits, method=method)
    if method == "uniform_asym":
        np.testing.assert_array_equal(pq.words.numpy(), np.asarray(ref.words))
    else:
        _assert_adaptive_close(
            np.asarray(ref.scale), np.asarray(ref.zero),
            ref_packing.unpack_bits(_payload_np(ref), bits, ref.count),
            pq.scale.numpy(), pq.zero.numpy(),
            packing.unpack_bits(_payload(pq), bits, pq.count))


@pytest.mark.parametrize("method", ["uniform_asym", "adaptive"])
def test_quant_codes_are_quant_pack_codes(method):
    x = torch.from_numpy(_rows(257, 24))
    pq = quant_pack(x, bits=3, method=method)
    q = quant_codes(x, bits=3, method=method)
    assert _payload(pq) == packing.pack_bits(q.codes.numpy(), 3)
    assert torch.equal(pq.scale, q.scale) and torch.equal(pq.zero, q.zero)


def test_empty_input():
    pq = quant_pack(torch.zeros((0, 64)), bits=4)
    assert pq.count == 0 and pq.words.numel() == 0 and pq.scale.numel() == 0


@pytest.mark.parametrize("method,bits", [("uniform_sym", 4), ("uniform_asym", 8),
                                         ("uniform_asym", 3), ("adaptive", 2),
                                         ("adaptive", 4)])
def test_core_quantize_matches_reference(method, bits):
    x = _rows(500, 48, seed=bits)
    ref = ref_q.quantize(jnp.asarray(x), ref_q.QuantConfig(bits=bits, method=method))
    got = port_q.quantize(torch.from_numpy(x),
                          port_q.QuantConfig(bits=bits, method=method))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(got.zero.numpy(), np.asarray(ref.zero))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_dequantize_bit_equal(bits):
    rng = np.random.default_rng(bits)
    rows, dim = 2000, 32
    codes = rng.integers(0, 1 << bits, (rows, dim)).astype(np.uint8)
    scale = (rng.random(rows) * 10.0 ** rng.integers(-6, 2, rows)).astype(np.float32)
    zero = (rng.normal(size=rows) * 10.0 ** rng.integers(-4, 3, rows)).astype(np.float32)
    scale[:3] = [1.0, 0.0, 3e-38]
    zero[:3] = [-0.0, 5.0, -1e-30]
    ref = np.asarray(ref_q.dequantize(ref_q.Quantized(
        jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(zero), bits=bits)))
    got = port_q.dequantize(port_q.Quantized(
        torch.from_numpy(codes), torch.from_numpy(scale), torch.from_numpy(zero),
        bits=bits)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("bits,dim", [(8, 300), (4, 10752), (1, 3)])
def test_dequantize_by_table_bit_equal(bits, dim):
    """Rows wider than their codes' 2^bits levels are dequantized by looking
    each row's 2^bits results up (the restore path's decode): bit-equal to
    the reference's fused multiply-add, edge scales and zeros included, as
    are rows no wider than that (computed value by value)."""
    rng = np.random.default_rng(dim)
    rows = 64
    codes = rng.integers(0, 1 << bits, (rows, dim)).astype(np.uint8)
    scale = (rng.random(rows) * 10.0 ** rng.integers(-6, 2, rows)).astype(np.float32)
    zero = (rng.normal(size=rows) * 10.0 ** rng.integers(-4, 3, rows)).astype(np.float32)
    scale[:3] = [1.0, 0.0, 3e-38]
    zero[:3] = [-0.0, 5.0, -1e-30]
    ref = np.asarray(ref_q.dequantize(ref_q.Quantized(
        jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(zero), bits=bits)))
    got = port_q.dequantize(port_q.Quantized(
        torch.from_numpy(codes), torch.from_numpy(scale), torch.from_numpy(zero),
        bits=bits)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


# Rows wider than 1,024 values (the kernels' wide route on a card, and past
# 8,192 the long route: dbrx's 10,752-wide experts, an odd 20,001): the
# plain path the CPU runs against the reference's quant_pack, its jnp path
# and, at 1,100, its Pallas kernel in interpret mode; and the unpacked
# adaptive_quant op against the reference's
@pytest.mark.parametrize("dim", [1100, 6144, 10752, 20001])
@pytest.mark.parametrize("method,bits", [("uniform_asym", b) for b in (2, 4, 8)]
                         + [("adaptive", b) for b in (2, 4, 8)])
def test_wide_rows_match_reference(dim, method, bits):
    x = _rows(9, dim, seed=dim + bits)
    impls = ("jnp", "interpret") if dim == 1100 and bits == 4 else ("jnp",)
    pq = quant_pack(torch.from_numpy(x), bits=bits, method=method)
    for impl in impls:
        ref = ref_pack(jnp.asarray(x), bits=bits, method=method, impl=impl)
        assert pq.count == ref.count
        if method == "uniform_asym":
            np.testing.assert_array_equal(pq.words.numpy(), np.asarray(ref.words))
        else:
            _assert_adaptive_close(
                np.asarray(ref.scale), np.asarray(ref.zero),
                ref_packing.unpack_bits(_payload_np(ref), bits, ref.count),
                pq.scale.numpy(), pq.zero.numpy(),
                packing.unpack_bits(_payload(pq), bits, pq.count))


@pytest.mark.parametrize("dim", [1100, 6144, 10752, 20001])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_wide_rows_adaptive_quant_matches_reference(dim, bits):
    from repro.kernels.adaptive_quant import adaptive_quant as ref_aq
    from repro_torch.kernels.adaptive_quant import adaptive_quant

    x = _rows(9, dim, seed=dim * bits)
    ref = ref_aq(jnp.asarray(x), bits=bits, num_bins=25, ratio=0.5, impl="ref")
    got = adaptive_quant(torch.from_numpy(x), bits=bits, num_bins=25, ratio=0.5)
    _assert_adaptive_close(np.asarray(ref.scale), np.asarray(ref.zero),
                           np.asarray(ref.codes), got.scale.numpy(), got.zero.numpy(),
                           got.codes.numpy())


# The 4-bit adaptive round trip's mean relative error on Gaussian rows
# grows with the row's width: the reference test's restore bar of 0.1
# (tests/test_train_restore.py, 64-wide tables) is one the reference's own
# quantizer misses at the LMs' tok_emb widths (896: qwen2-0.5b; 6,144:
# nemotron-4-15b). The chip smoke therefore holds those restores to the
# quantizer's round trip; this is the figure it stands on, in both packages.
@pytest.mark.parametrize("dim,want", [(64, 0.085), (896, 0.111), (6144, 0.125)])
def test_adaptive_4bit_round_trip_error_by_width(dim, want):
    x = np.random.default_rng(dim).normal(size=(256, dim)).astype(np.float32)

    def rel(codes, scale, zero):
        deq = (np.asarray(codes).astype(np.float32) * np.asarray(scale)[:, None]
               + np.asarray(zero)[:, None])
        return (np.abs(deq - x).mean(dtype=np.float64)
                / np.abs(x).mean(dtype=np.float64))

    ref = ref_codes(jnp.asarray(x), bits=4, method="adaptive", impl="jnp")
    got = quant_codes(torch.from_numpy(x), bits=4, method="adaptive")
    ref_rel = rel(ref.codes, ref.scale, ref.zero)
    assert abs(ref_rel - want) < 0.003
    assert (ref_rel < 0.1) == (dim == 64)
    assert rel(got.codes.numpy(), got.scale.numpy(), got.zero.numpy()) == \
        pytest.approx(ref_rel, rel=1e-3)
