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
Pallas kernels. ``flash_attention`` within 2e-3 in f32 (sums in another
order) and 3e-2 in bf16 (outputs rounded to bf16 may land on neighbouring
values), the reference's bars for its kernel; the unpacked
``adaptive_quant`` at the quantizers' bars above, and bit-equal at dim 64
on rows at rounding ties.
"""

import dataclasses
import importlib

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


# dims 64, 128 and 1024 are whole multiples of 32: their codes are packed
# in registers at 2, 4 and 8 bits (64), 2 and 4 (128) and 1 (1024), through
# shared memory otherwise; dims 10, 16, 96 and 200 leave lanes part-filled
# (shared memory)
@pytest.mark.parametrize("rows,dim", [(1, 10), (1000, 64), (333, 200), (70, 1024),
                                      (500, 16), (300, 96), (257, 128)])
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


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023, 524_287, 1_048_579])
def test_chunk_hash_on_misaligned_views(cuda, offset, n):
    """w[offset:] starts 4, 8 or 12 bytes past a 16-byte boundary: the
    kernel reads the head word by word and the rest as uint4s, and the
    index of each term is the word's position in the view."""
    from repro_torch.kernels.chunk_hash import ops
    from repro_torch.kernels.chunk_hash.ref import hash_words_np

    w = np.random.default_rng(n + offset).integers(0, 2**32, size=n + offset,
                                                   dtype=np.uint32)
    t = torch.from_numpy(w).to(cuda)[offset:]
    assert n == 0 or t.data_ptr() % 16 == 4 * offset
    assert ops.hash_words_cuda(t, n) == hash_words_np(w[offset:])
    assert ops.hash_value(ops.hash_words_async(t, n), n) == hash_words_np(w[offset:])


def test_chunk_hash_repeated_calls_on_one_buffer(cuda):
    """1,000 calls on one stream, the results read only after the last
    launch: each call zeroes and fills its own sum, so every result is the
    oracle's."""
    from repro_torch.kernels.chunk_hash import ops
    from repro_torch.kernels.chunk_hash.ref import hash_words_np

    w = np.random.default_rng(7).integers(0, 2**32, size=524_291, dtype=np.uint32)
    t = torch.from_numpy(w).to(cuda)
    counts = [524_288 - 13 * i for i in range(1000)]
    before = ops.LAUNCHES.count
    outs = [ops.hash_words_async(t, c) for c in counts]
    assert ops.LAUNCHES.count == before + 1000
    torch.cuda.synchronize()
    assert ([ops.hash_value(h, c) for h, c in zip(outs, counts)]
            == [hash_words_np(w[:c]) for c in counts])


def test_chunk_hash_from_two_threads_on_two_streams(cuda):
    """Two threads hash on two streams at once, as the save path's two
    encode workers may: each call's memset and blocks' adds go to its own
    sum, on its own stream."""
    import threading

    from repro_torch.kernels.chunk_hash import ops
    from repro_torch.kernels.chunk_hash.ref import hash_words_np

    rng = np.random.default_rng(3)
    data = [rng.integers(0, 2**32, size=n, dtype=np.uint32)
            for n in (524_288, 1_048_579)]
    want = [hash_words_np(w) for w in data]
    bufs = [torch.from_numpy(w).to(cuda) for w in data]
    torch.cuda.synchronize()
    got = [[], []]
    errors = []

    def work(i):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                outs = [ops.hash_words_async(bufs[i], bufs[i].shape[0])
                        for _ in range(200)]
                stream.synchronize()
                got[i] = [ops.hash_value(h, bufs[i].shape[0]) for h in outs]
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    assert got[0] == [want[0]] * 200 and got[1] == [want[1]] * 200


def test_wrappers_check_their_arguments(cuda):
    from repro_torch.kernels.adaptive_quant.ops import quant_pack_cuda
    from repro_torch.kernels.chunk_hash.ops import hash_words_cuda

    with pytest.raises(TypeError):
        quant_pack_cuda(torch.zeros((4, 8), dtype=torch.float64, device=cuda),
                        bits=4, num_bins=45, n_steps=9)
    with pytest.raises(ValueError):
        quant_pack_cuda(torch.zeros((8, 4), device=cuda).t(), bits=4,
                        num_bins=45, n_steps=9)
    with pytest.raises(ValueError):  # past the wide route's 8,192
        quant_pack_cuda(torch.zeros((4, 8193), device=cuda), bits=4,
                        num_bins=45, n_steps=9)
    with pytest.raises(ValueError):
        hash_words_cuda(torch.zeros(8, dtype=torch.int32, device=cuda), 9)
    with pytest.raises(ValueError):
        hash_words_cuda(torch.zeros(8, dtype=torch.int32, device=cuda)[::2], 4)


def test_cuda_tensors_never_take_the_plain_path(cuda):
    from repro_torch.kernels.adaptive_quant import ops as aq
    from repro_torch.kernels.chunk_hash import ops as ch

    before = aq.LAUNCHES.count
    aq.quant_pack(torch.zeros((4, 8), device=cuda), bits=4)
    aq.quant_codes(torch.zeros((4, 8), device=cuda), bits=4)
    assert aq.LAUNCHES.count == before + 2
    before = ch.LAUNCHES.count
    ch.chunk_hash32_device(torch.zeros(8, dtype=torch.int32, device=cuda))
    assert ch.LAUNCHES.count == before + 1


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


def _bf16_ulps(got, want):
    """|got - want| in units of want's bf16 ulp (2^(e-8) for want = m 2^e,
    m in [0.5, 1))."""
    _, e = torch.frexp(want.float())
    return (got.float() - want.float()).abs() / torch.ldexp(torch.ones_like(want.float()), e - 8)


def _fields_inputs(B, F, H, D, vocabs, device, seed):
    rng = np.random.default_rng(seed)
    tables = [torch.from_numpy(rng.normal(size=(v, D)).astype(np.float32)).to(device)
              for v in vocabs]
    ids = np.stack([rng.integers(0, v, size=(B, H)) for v in vocabs], axis=1)
    return tables, torch.from_numpy(ids.astype(np.int32)).to(device)


# (B, F, H, D, vocabs): dlrm-rm2's serve_p99 and retrieval (batch 1)
# shapes at a small vocabulary,
# F of 1 to 40, H > 1, D not a multiple of 4, unequal vocabularies
FIELDS_SHAPES = [(512, 26, 1, 64, [1000] * 26), (1, 26, 1, 64, [1000] * 26),
                 (300, 1, 1, 64, [70]),
                 (64, 40, 3, 16, [20 + 7 * f for f in range(40)]),
                 (33, 5, 4, 10, [5, 900, 31, 2, 64]), (17, 3, 7, 200, [300, 11, 4096]),
                 (128, 26, 2, 64, [2 ** 12 + f for f in range(26)]), (5, 64, 1, 4, [9] * 64)]


@pytest.mark.parametrize("B,F,H,D,vocabs", FIELDS_SHAPES)
def test_embedding_bag_fields_kernel_matches_plain(cuda, B, F, H, D, vocabs):
    """One launch for all fields: bit-equal to the plain version at H = 1
    (a bag of one row is that row, rounded once to bf16), within one bf16
    ulp at H > 1 (the plain version may sum in another order, and a last
    f32 bit may round to the neighbouring bf16 value)."""
    from repro_torch.kernels.embedding_bag import ops

    tables, ids = _fields_inputs(B, F, H, D, vocabs, cuda, seed=B + F + H + D)
    before = ops.LAUNCHES.count
    got = ops.embedding_bag_fields(tables, ids)
    assert ops.LAUNCHES.count == before + 1
    want = ops.embedding_bag_fields_torch(tables, ids)
    assert got.dtype == torch.bfloat16 and got.shape == (B, F, D)
    if H == 1:
        assert torch.equal(got, want)
    else:
        assert float(_bf16_ulps(got, want).max()) <= 1.0


def test_embedding_bag_fields_takes_strided_ids_and_nans_a_bad_id(cuda):
    """Ids as a strided view ((B, H, F) transposed to (B, F, H)); an id
    past its own table's rows (though inside another's) makes that bag NaN
    and leaves every other bag as the plain version has it."""
    from repro_torch.kernels.embedding_bag import ops

    tables, ids = _fields_inputs(40, 6, 3, 32, [50, 500, 7, 64, 300, 9], cuda, seed=9)
    ids = ids.transpose(1, 2).contiguous().transpose(1, 2)
    assert not ids.is_contiguous()
    want = ops.embedding_bag_fields_torch(tables, ids)
    assert float(_bf16_ulps(ops.embedding_bag_fields(tables, ids), want).max()) <= 1.0
    bad = ids.clone()
    bad[7, 2, 1] = 7  # field 2 has 7 rows
    bad[11, 0, 0] = -1
    got = ops.embedding_bag_fields(tables, bad)
    nan = torch.isnan(got).all(dim=-1)
    assert nan[7, 2] and nan[11, 0] and int(nan.sum()) == 2
    keep = ~nan
    assert float(_bf16_ulps(got[keep], want[keep]).max()) <= 1.0


def test_embedding_bag_fields_offsets_past_2_to_the_31(cuda):
    """One field's table holds more than 2**31 values (8.6 GB): ids in its
    last rows have element offsets that an int would wrap."""
    from repro_torch.kernels.embedding_bag import ops

    V, D = 33_554_944, 64
    big = torch.empty((V, D), dtype=torch.float32, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    lo = V - 4096
    big[lo:] = torch.randn((V - lo, D), generator=gen, device=cuda)
    small = torch.randn((100, D), generator=gen, device=cuda)
    ids = torch.stack([torch.randint(0, 100, (256,), generator=gen, device=cuda),
                       torch.randint(lo, V, (256,), generator=gen, device=cuda),
                       torch.randint(0, 100, (256,), generator=gen, device=cuda)],
                      dim=1)[:, :, None].to(torch.int32)
    got = ops.embedding_bag_fields_cuda([small, big, small], ids)
    assert torch.equal(got, ops.embedding_bag_fields_torch([small, big, small], ids))
    assert torch.equal(got[:, 1], big[ids[:, 1, 0].long()].to(torch.bfloat16))
    del big
    torch.cuda.empty_cache()


def test_embedding_bag_fields_wrapper_checks_its_arguments(cuda):
    from repro_torch.kernels.embedding_bag import ops

    t = torch.zeros((10, 4), device=cuda)
    ids = torch.zeros((2, 3, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="tables"):  # F of the ids != tables
        ops.embedding_bag_fields_cuda([t, t], ids)
    with pytest.raises(ValueError):  # mixed devices
        ops.embedding_bag_fields_cuda([t, t.cpu(), t], ids)
    with pytest.raises(ValueError):  # more fields than the kernel holds
        ops.embedding_bag_fields_cuda([t] * (ops.MAX_FIELDS + 1),
                                      torch.zeros((2, ops.MAX_FIELDS + 1, 1),
                                                  dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):  # tables of different widths
        ops.embedding_bag_fields_cuda([t, t, torch.zeros((10, 8), device=cuda)], ids)
    with pytest.raises(TypeError):
        ops.embedding_bag_fields_cuda([t] * 3, ids.long())
    before = ops.LAUNCHES.count
    with pytest.raises(ValueError):  # tables on the card, ids on the CPU
        ops.embedding_bag_fields([t] * 3, ids.cpu())
    with pytest.raises(ValueError):
        ops.embedding_bag(t, ids[:, 0, :].cpu())
    assert ops.LAUNCHES.count == before


# bf16 on the tensor cores: batches that are not a multiple of its 4-row
# units, F = 2, one to four 16-row m-tiles, D not a multiple of 16 or of 8
# (element-wise staging)
@pytest.mark.parametrize("B,F,D", [(64, 27, 64), (128, 40, 10), (32, 8, 16),
                                   (256, 14, 128), (512, 27, 64), (3, 2, 1),
                                   (513, 27, 64), (2, 2, 64), (5, 33, 64), (7, 33, 10),
                                   (130, 64, 128), (9, 17, 8)])
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


@pytest.mark.parametrize("B,F,D", [(513, 27, 64), (7, 33, 10), (1, 40, 16)])
def test_dot_interaction_bf16_reads_unaligned_features(cuda, B, F, D):
    """Features 2 bytes past a 16-byte boundary: the bf16 route stages
    them element by element, not by 16-byte copies."""
    from repro_torch.kernels.dot_interaction import ops

    x = torch.from_numpy(np.random.default_rng(B * F + D).normal(size=(B, F, D))
                         .astype(np.float32)).to(cuda).to(torch.bfloat16)
    off = torch.empty(B * F * D + 1, dtype=torch.bfloat16, device=cuda)[1:].view(B, F, D)
    off.copy_(x)
    torch.testing.assert_close(ops.dot_interaction_cuda(off), ops.dot_interaction_torch(x),
                               rtol=1e-4, atol=1e-4)


def test_dot_interaction_refuses_what_the_tensor_cores_do_not_take(cuda):
    from repro_torch.kernels.dot_interaction import ops

    before = ops.LAUNCHES.count
    for F, D in ((65, 8), (64, 1024)):
        with pytest.raises(ValueError, match="tensor-core route"):
            ops.dot_interaction_cuda(torch.zeros((2, F, D), dtype=torch.bfloat16, device=cuda))
    assert ops.LAUNCHES.count == before
    # the f32 route takes F = 65
    got = ops.dot_interaction_cuda(torch.ones((2, 65, 8), device=cuda))
    assert got.shape == (2, 65 * 64 // 2) and bool((got == 8).all())


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
    """The serve cell on the card: one ``embedding_bag`` launch (all 26
    fields) and one ``dot_interaction`` launch per batch, and the forward
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
    assert (eb.LAUNCHES.count, di.LAUNCHES.count) == (3, 3)
    plain = dlrm.serve(params, batch_to_device(batch_for_cell(bundle, 2), cuda),
                       bundle.cfg, bag=eb.embedding_bag_fields_torch,
                       interact=di.dot_interaction_torch)
    assert probs.is_cuda and torch.isfinite(probs).all()
    torch.testing.assert_close(probs, plain, rtol=0, atol=1e-2)


# (B, Sq, Sk, Hq, Hkv, D, causal): the reference's test shapes, bert4rec's
# serve and retrieval (batch 1: a grid of 2 blocks) shapes, and cases for the tensor-core tiling: S not a multiple of
# 16 (1, 17, 200, 257), D of 16 to 128 (100 pads to 112), 4 q heads on one
# kv head, causal with ragged S, Sq != Sk, and keys longer than one staged
# chunk of shared memory (D 32: 576 keys a chunk, D 64: 256, D 128: 128)
FLASH_SHAPES = [(2, 128, 128, 4, 2, 64, True), (1, 256, 256, 8, 8, 32, False),
                (2, 128, 128, 2, 1, 100, True), (1, 192, 192, 4, 4, 64, True),
                (2, 200, 200, 2, 2, 32, False), (3, 70, 70, 2, 2, 128, True),
                (512, 200, 200, 2, 2, 32, False), (1, 1, 1, 1, 1, 1, True),
                (3, 17, 17, 4, 1, 16, True), (2, 257, 257, 4, 1, 64, False),
                (4, 1, 200, 2, 2, 32, False), (2, 200, 17, 2, 1, 128, False),
                (2, 257, 130, 2, 2, 100, True), (1, 17, 257, 4, 1, 128, True),
                (2, 200, 200, 4, 1, 32, True), (1, 300, 700, 4, 2, 64, False),
                (2, 600, 600, 2, 1, 128, True), (1, 64, 1500, 2, 2, 32, False),
                (1, 200, 200, 2, 2, 32, False), (1, 200, 200, 2, 2, 32, True)]


def _flash_inputs(B, Sq, Sk, Hq, Hkv, D, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, s, h, D)).astype(np.float32))
            .to(device).to(dtype) for s, h in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv))]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Sk, Hq, Hkv, D, causal, dtype):
    from repro_torch.kernels.flash_attention import ops, ref

    q, k, v = _flash_inputs(B, Sq, Sk, Hq, Hkv, D, dtype, cuda, seed=B + Sq + Sk + D)
    route = ops.MMA_LAUNCHES if dtype == torch.bfloat16 else ops.SIMT_LAUNCHES
    before = route.count
    got = ops.flash_attention(q, k, v, causal=causal)
    assert route.count == before + 1
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got, ref.flash_attention_torch(q, k, v, causal=causal),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("D", [1, 16, 32, 48, 64, 100, 128])
@pytest.mark.parametrize("Sk", [1, 17, 200, 257, 1025])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_f32_route_shapes(cuda, D, Sk, causal):
    """The f32 route at every padded head width (32, 64, 96, 128) and key
    lengths that leave 8-key tails, stage k and v whole or in chunks
    (1025 keys exceed the budget at every D), with 4 q heads on one kv
    head, 45 q rows (a partial q tile) and q, k, v as strided views whose
    strides are not multiples of 4 floats (element-by-element staging)
    beside contiguous copies (16-byte copies): both within 2e-3 of the
    plain version, and equal to each other bit for bit."""
    from repro_torch.kernels.flash_attention import ops, ref

    rng = np.random.default_rng(D * 7 + Sk)
    B, Sq, Hq, Hkv = 2, 45, 4, 1
    q = torch.from_numpy(rng.normal(size=(B, Sq, Hq, D + 1)).astype(np.float32)).to(cuda)[..., 1:]
    k, v = (torch.from_numpy(rng.normal(size=(B, Sk, Hkv, D + 1)).astype(np.float32))
            .to(cuda)[..., :D] for _ in range(2))
    assert not ops._vec16(q) and not ops._vec16(k)
    before = ops.SIMT_LAUNCHES.count
    got = ops.flash_attention(q, k, v, causal=causal)
    dense = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal)
    assert ops.SIMT_LAUNCHES.count == before + 2
    want = ref.flash_attention_torch(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(dense, want, rtol=2e-3, atol=2e-3)
    assert torch.equal(got, dense)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_routes_by_dtype(cuda, dtype):
    """A bf16 call adds one launch to the tensor-core route and none to the
    f32 route; an f32 call the reverse."""
    from repro_torch.kernels.flash_attention import ops

    q, k, v = _flash_inputs(2, 40, 40, 2, 1, 32, dtype, cuda, seed=5)
    mma, simt = ops.MMA_LAUNCHES.count, ops.SIMT_LAUNCHES.count
    ops.flash_attention(q, k, v, causal=True)
    bf = dtype == torch.bfloat16
    assert (ops.MMA_LAUNCHES.count - mma, ops.SIMT_LAUNCHES.count - simt) == (
        (1, 0) if bf else (0, 1))


@pytest.mark.parametrize("what", ["stride", "pointer"])
def test_flash_attention_misaligned_bf16_views(cuda, what):
    """bf16 views whose strides or base pointer are not multiples of 8
    elements: the tensor-core kernel loads them element by element and
    computes them as the plain version does (or would refuse them with a
    ValueError; it takes them)."""
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device=cuda).manual_seed(11)
    if what == "stride":  # a row of 33 with the first column cut: stride 33
        q, k, v = (torch.randn((2, 200, 2, 33), generator=gen, device=cuda)
                   .to(torch.bfloat16)[..., 1:] for _ in range(3))
    else:  # whole rows, the base pointer one element past 16-byte alignment
        q, k, v = (torch.randn(2 * 200 * 2 * 32 + 1, generator=gen, device=cuda)
                   .to(torch.bfloat16)[1:].view(2, 200, 2, 32) for _ in range(3))
    assert not ops._vec16(q)
    before = ops.MMA_LAUNCHES.count
    try:
        got = ops.flash_attention(q, k, v, causal=False)
    except ValueError:
        return
    assert ops.MMA_LAUNCHES.count == before + 1
    torch.testing.assert_close(got, ref.flash_attention_torch(q, k, v, causal=False),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_wide_range_v(cuda, causal):
    """v values far apart in scale (1e5 and 1e-20 among unit normals): the
    tensor-core kernel's bf16 products of p (split into its top half and
    remainder) with v equal the plain version's f32 attention."""
    from repro_torch.kernels.flash_attention import ops, ref

    q, k, v = _flash_inputs(4, 200, 200, 2, 1, 32, torch.bfloat16, cuda, seed=9)
    v[0, 7, 0, 3] = 1e5
    v[2, 100, 0, 0] = 1e-20
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, ref.flash_attention_torch(q, k, v, causal=causal),
                               rtol=3e-2, atol=3e-2)


def test_flash_attention_takes_strided_views(cuda):
    """q, k, v as column slices of one fused projection: the kernel reads
    them through their strides, and equals its result on copies."""
    from repro_torch.kernels.flash_attention import ops

    qkv = torch.randn((4, 200, 3, 2, 32), device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    before = ops.MMA_LAUNCHES.count
    got = ops.flash_attention(q, k, v, causal=False)
    assert ops.MMA_LAUNCHES.count == before + 1
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=False)
    assert torch.equal(got, want)


def test_flash_attention_past_2_31_elements(cuda):
    """170,000 x 200 x 2 x 32 bf16 holds 2.18e9 elements a tensor, so the
    last batch rows' offsets pass 2^31; they must equal the plain version
    on those rows alone."""
    from repro_torch.kernels.flash_attention import ops, ref

    B = 170_000
    q, k, v = (torch.empty((B, 200, 2, 32), dtype=torch.bfloat16, device=cuda)
               .normal_() for _ in range(3))
    before = ops.MMA_LAUNCHES.count
    got = ops.flash_attention(q, k, v, causal=False)[-64:]
    assert ops.MMA_LAUNCHES.count == before + 1
    want = ref.flash_attention_torch(q[-64:], k[-64:], v[-64:], causal=False)
    torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)


def test_flash_attention_checks_its_arguments(cuda):
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda

    x = torch.zeros((1, 8, 2, 32), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_cuda(x.half(), x.half(), x.half())
    with pytest.raises(TypeError):
        flash_attention_cuda(x, x.bfloat16(), x)
    with pytest.raises(ValueError):
        flash_attention_cuda(torch.zeros((1, 8, 2, 160), device=cuda),
                             torch.zeros((1, 8, 2, 160), device=cuda),
                             torch.zeros((1, 8, 2, 160), device=cuda))
    with pytest.raises(ValueError):
        flash_attention_cuda(torch.zeros((1, 8, 3, 32), device=cuda), x, x)
    with pytest.raises(ValueError):
        flash_attention_cuda(x.transpose(2, 3).contiguous().transpose(2, 3), x, x)


@pytest.mark.parametrize("rows,dim", [(256, 64), (512, 10), (256, 128),
                                      (512, 200), (1, 1024), (4099, 64)])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_adaptive_quant_kernel_matches_plain(cuda, rows, dim, bits):
    from repro_torch.core.quantize import adaptive_quantize
    from repro_torch.kernels.adaptive_quant import ops

    x = _rows(rows, dim, cuda, seed=rows + dim + bits)
    before = ops.ADAPTIVE_QUANT_LAUNCHES.count
    got = ops.adaptive_quant(x, bits=bits, num_bins=25, ratio=0.5)
    assert ops.ADAPTIVE_QUANT_LAUNCHES.count == before + 1
    want = adaptive_quantize(x, bits, 25, 0.5)
    assert got.codes.dtype == torch.uint8 and got.codes.shape == (rows, dim)
    np.testing.assert_allclose(got.scale.cpu().numpy(), want.scale.cpu().numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.zero.cpu().numpy(), want.zero.cpu().numpy(),
                               rtol=1e-5, atol=1e-7)
    assert (got.codes != want.codes).float().mean().item() <= 2e-3


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_adaptive_quant_at_rounding_ties_is_bit_equal(cuda, bits):
    """Rows whose quotients sit on half-integers and one ulp either side
    (``ties.tie_rows``), where the kernel's window sends values to the
    divide: codes, scale and zero equal the plain version's bit for bit at
    dim 64 (where the kernel's error sums and PyTorch's row sum on the card
    add in the same order)."""
    from repro_torch.core.quantize import adaptive_quantize
    from repro_torch.kernels.adaptive_quant import ops
    from repro_torch.kernels.adaptive_quant.ties import tie_rows, tie_share

    x = tie_rows(_rows(4096, 64, cuda, seed=bits), bits)
    assert tie_share(x, bits) > 0.02
    got = ops.adaptive_quant(x, bits=bits, num_bins=25, ratio=0.5)
    want = adaptive_quantize(x, bits, 25, 0.5)
    assert torch.equal(got.scale, want.scale)
    assert torch.equal(got.zero, want.zero)
    assert torch.equal(got.codes, want.codes)


def test_adaptive_quant_past_2_31_elements(cuda):
    """A 33,554,944 x 64 table holds 2.1e9 values: its last rows' offsets
    pass 2^31 and must quantize as the plain version quantizes them alone."""
    from repro_torch.core.quantize import adaptive_quantize
    from repro_torch.kernels.adaptive_quant import ops

    x = torch.empty((33_554_944, 64), device=cuda).normal_()
    got = ops.adaptive_quant(x, bits=4, num_bins=45, ratio=0.2)
    want = adaptive_quantize(x[-65536:], 4, 45, 0.2)
    torch.testing.assert_close(got.scale[-65536:], want.scale, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(got.zero[-65536:], want.zero, rtol=1e-5, atol=1e-7)
    assert (got.codes[-65536:] != want.codes).float().mean().item() <= 2e-3


def test_bert4rec_serving_launches_flash_twice_per_forward(cuda):
    """The bert4rec serve cell on the card: one ``flash_attention`` launch
    per block per forward slice, all on the tensor-core route (bf16), and the scores through the plain version
    within 2e-2: the model is bf16, and attention outputs one bf16 step
    apart move a score by far less than a wrong mask or head would."""
    from repro_torch.configs import get_cell
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import bert4rec
    from repro_torch.train.loop import batch_to_device

    p99 = get_cell("bert4rec", "serve_p99", reduced=True, device=cuda)
    bulk = get_cell("bert4rec", "serve_bulk", reduced=True, device=cuda)
    params = p99.make_state().params
    fa.MMA_LAUNCHES.reset()
    fa.SIMT_LAUNCHES.reset()
    for i in range(3):
        scores = p99.step_fn(params, batch_to_device(batch_for_cell(p99, i), cuda))
    assert fa.MMA_LAUNCHES.count == 3 * 2
    b = batch_to_device(batch_for_cell(bulk, 0), cuda)
    bulk.step_fn(params, b)
    slices = -(-b["items"].shape[0] // bulk.cfg.serve_slice_rows)
    assert slices > 1 and fa.MMA_LAUNCHES.count == 3 * 2 + 2 * slices
    assert fa.SIMT_LAUNCHES.count == 0
    plain = bert4rec.serve(params, batch_to_device(batch_for_cell(p99, 2), cuda),
                           p99.cfg, attention=fa.flash_attention_torch)
    assert scores.shape == (16, 100) and torch.isfinite(scores).all()
    torch.testing.assert_close(scores, plain, rtol=0, atol=2e-2)


@pytest.mark.parametrize("arch", ["dlrm-rm2", "bert4rec"])
def test_retrieval_on_the_card_matches_the_plain_ops(cuda, arch):
    """The retrieval cell (one user, batch 1, against 512 candidates): for
    dlrm-rm2 one ``embedding_bag`` launch and no ``dot_interaction`` launch
    a request, within the bf16 serve bar of the plain lookup (1e-3); for
    bert4rec two tensor-core ``flash_attention`` launches a request, within
    2e-2 of the plain attention, and its first 100 scores within 1e-4 of
    ``serve`` on the same sequence and candidates (only the last
    product's order differs)."""
    from repro_torch.configs import get_cell
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.kernels.dot_interaction import ops as di
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import bert4rec, dlrm
    from repro_torch.train.loop import batch_to_device

    bundle = get_cell(arch, "retrieval_cand", reduced=True, device=cuda)
    params = get_cell(arch, "train_batch", reduced=True, device=cuda).make_state().params
    counters = (eb.LAUNCHES, di.LAUNCHES, fa.MMA_LAUNCHES, fa.SIMT_LAUNCHES)
    for c in counters:
        c.reset()
    for i in range(3):
        b = batch_to_device(batch_for_cell(bundle, i), cuda)
        got = bundle.step_fn(params, b)
    assert got.shape == (512,) and got.dtype == torch.float32 and torch.isfinite(got).all()
    counts = tuple(c.count for c in counters)
    if arch == "dlrm-rm2":
        assert counts == (3, 0, 0, 0)
        want = dlrm.serve_retrieval(params, b, bundle.cfg, bag=eb.embedding_bag_fields_torch)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    else:
        assert counts == (0, 0, 6, 0)
        want = bert4rec.serve_retrieval(params, b, bundle.cfg,
                                        attention=fa.flash_attention_torch)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-2)
        sub = dict(items=b["items"], candidate_ids=b["candidate_ids"][None, :100])
        torch.testing.assert_close(got[:100], bert4rec.serve(params, sub, bundle.cfg)[0],
                                   rtol=0, atol=1e-4)


def test_multiprocess_save_on_the_card_reports_its_launches(cuda, tmp_path):
    """Host processes on the card (``multiprocess=True``, ``device="cuda"``):
    each makes its own CUDA context and quantizes and hashes its chunks
    with the kernels in that process; the launches the processes report
    add up to the chunks written, and the store restores to the in-process
    save's state."""
    from repro_torch.core import (CheckNRunManager, CheckpointConfig, LocalFSStore,
                                  Snapshot)
    from repro_torch.core import manifest as mf
    from repro_torch.core.quantize import QuantConfig

    rng = np.random.default_rng(0)
    tables = {f"emb_{i}": rng.normal(size=(3000 + 7 * i, 64)).astype(np.float32)
              for i in range(3)}
    snap = Snapshot(step=1, tables=tables,
                    row_state={n: {"acc": np.abs(rng.normal(size=t.shape[0]))
                                   .astype(np.float32)} for n, t in tables.items()},
                    touched={n: np.ones(t.shape[0], bool) for n, t in tables.items()},
                    dense={"w": rng.normal(size=(16, 16)).astype(np.float32)}, extra={})
    cfg = CheckpointConfig(policy="full_only", quant=QuantConfig(bits=4, method="adaptive"),
                           async_write=False, chunk_rows=512, num_hosts=2, device="cuda",
                           multiprocess=True, spill_dir=str(tmp_path),
                           write_deadline_s=300.0)
    mgr = CheckNRunManager(LocalFSStore(str(tmp_path / "mp")), cfg)
    res = mgr.save(snap).result()
    man = mf.load(mgr.store, 1)
    chunks = sum(len(t.chunks) for t in man.tables.values())
    hosts = res.pipeline_stats["per_host"]
    assert all(h["cuda_initialized"] for h in hosts)
    assert sum(h["launches"]["quant_pack"] for h in hosts) == chunks
    assert sum(h["launches"]["chunk_hash"] for h in hosts) == chunks
    inproc = CheckNRunManager(LocalFSStore(str(tmp_path / "ip")),
                              dataclasses.replace(cfg, multiprocess=False))
    inproc.save(snap).result()
    a, b = mgr.restore(), inproc.restore()
    for n in tables:
        np.testing.assert_array_equal(a.tables[n], b.tables[n])
    mgr.close()
    inproc.close()


# xDeepFM's saves: chunks of its dim-10 emb_* and dim-1 lin_* tables, at the
# save's full chunk of 65,536 rows and a ragged tail
@pytest.mark.parametrize("rows,dim", [(65536, 10), (65536, 1), (1000, 10), (333, 1),
                                      (1, 1)])
@pytest.mark.parametrize("method,bits", [("uniform_asym", b) for b in range(1, 9)]
                         + [("adaptive", b) for b in (2, 3, 4)])
def test_quant_pack_at_dims_10_and_1(cuda, rows, dim, method, bits):
    """The masked (part-filled lanes) route at xDeepFM's table widths:
    uniform words byte-identical to the plain version, adaptive within
    the bars; a dim-1 row has no range, so its scale is 1 and its code 0."""
    from repro_torch.kernels.adaptive_quant import ops

    x = _rows(rows, dim, cuda, seed=rows + dim + bits)
    nb, ns = ops._resolve_steps(method, bits, None, None)
    k = ops.quant_pack_cuda(x, bits=bits, num_bins=nb, n_steps=ns)
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
    if dim == 1:
        assert bool((k.scale == 1).all()) and not _codes(k).any()
        assert torch.equal(k.zero, x[:, 0])


@pytest.mark.parametrize("D", [10, 1])
@pytest.mark.parametrize("B", [1, 512, 4096])
def test_embedding_bag_fields_at_xdeepfm_shapes(cuda, D, B):
    """xDeepFM's lookup: 39 fields in one launch at D = 10 and D = 1 (the
    scalar route), over its real vocabularies (10,000,384 rows at the
    largest); bit-equal to the plain version (H = 1)."""
    from repro_torch.configs.xdeepfm import XDEEPFM_VOCABS
    from repro_torch.kernels.embedding_bag import ops

    gen = torch.Generator(device=cuda).manual_seed(D + B)
    tables = [torch.randn((v, D), generator=gen, device=cuda) for v in XDEEPFM_VOCABS]
    ids = torch.stack([torch.randint(0, v, (B, 1), generator=gen, device=cuda)
                       for v in XDEEPFM_VOCABS], dim=1).to(torch.int32)
    ids[0, :, 0] = torch.tensor([v - 1 for v in XDEEPFM_VOCABS], device=cuda)  # last rows
    before = ops.LAUNCHES.count
    got = ops.embedding_bag_fields(tables, ids)
    assert ops.LAUNCHES.count == before + 1
    assert got.shape == (B, 39, D) and torch.equal(got, ops.embedding_bag_fields_torch(
        tables, ids))


def test_xdeepfm_serving_launches_twice_per_forward(cuda):
    """A reduced xDeepFM serve batch and a retrieval request on the card:
    the serve forward is two ``embedding_bag`` launches (emb_* and lin_*),
    its probabilities bit-equal to the plain lookups' (H = 1 lookups are
    the rows themselves); a retrieval request four (the user's two, the
    candidates' two)."""
    from repro_torch.configs import get_cell
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.models import xdeepfm
    from repro_torch.train.loop import batch_to_device

    params = get_cell("xdeepfm", "train_batch", reduced=True, device=cuda).make_state().params
    p99 = get_cell("xdeepfm", "serve_p99", reduced=True, device=cuda)
    b = batch_to_device(batch_for_cell(p99, 0), cuda)
    eb.LAUNCHES.reset()
    got = p99.step_fn(params, b)
    assert eb.LAUNCHES.count == 2
    assert torch.equal(got, xdeepfm.serve(params, b, p99.cfg,
                                          bag=eb.embedding_bag_fields_torch))
    r = get_cell("xdeepfm", "retrieval_cand", reduced=True, device=cuda)
    rb = batch_to_device(batch_for_cell(r, 0), cuda)
    eb.LAUNCHES.reset()
    got = r.step_fn(params, rb)
    assert eb.LAUNCHES.count == 4 and got.shape == (512,)
    assert torch.equal(got, xdeepfm.serve_retrieval(params, rb, r.cfg,
                                                    bag=eb.embedding_bag_fields_torch))


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("method", ["per_vector", "blocks", "clustered"])
def test_kmeans_on_the_card_matches_the_cpu(cuda, method, bits):
    """The k-means quantizers on the card against the same code on the
    CPU: codebooks within rtol 1e-5 / atol 1e-6 (the card's segment sums
    are f64 atomics, added in no fixed order and rounded to f32 once, so
    they may still differ from the CPU's in a last bit), codes equal but at
    ties (the two nearest centroids within 1e-6), at most 2e-3 of them."""
    q = importlib.import_module("repro_torch.core.quantize")

    fn = {"per_vector": lambda x: q.kmeans_quantize(x, bits),
          "blocks": lambda x: q.kmeans_block_quantize(x, bits, n_blocks=8),
          "clustered": lambda x: q.kmeans_clustered_quantize(x, bits, n_blocks=8)}[method]
    x = _rows(4096, 64, cuda, seed=bits)
    got, want = fn(x), fn(x.cpu())
    books = want.codebook.numpy()
    np.testing.assert_allclose(got.codebook.cpu().numpy(), books, rtol=1e-5, atol=1e-6)
    if want.block_ids is not None:
        assert torch.equal(got.block_ids.cpu(), want.block_ids)
        books = books[want.block_ids.numpy()]
    differ = got.codes.cpu().numpy() != want.codes.numpy()
    assert differ.mean() <= 2e-3
    if differ.any():
        d = np.sort(np.abs(x.cpu().numpy()[..., None] - books[:, None, :]), -1)
        assert np.all((d[..., 1] - d[..., 0])[differ] <= 1e-6)


# The wide route (rows past 1,024 values, a block a row): widths that are
# not a multiple of 32 (1,100, 1,025: rows share their first and last words),
# the LMs' tok_emb widths (2,048, 2,560, 6,144) and the route's limit
WIDE_DIMS = [1025, 1100, 2048, 2560, 6144, 8192]


@pytest.mark.parametrize("dim", WIDE_DIMS)
@pytest.mark.parametrize("method,bits", [("uniform_asym", b) for b in (1, 2, 3, 4, 8)]
                         + [("adaptive", b) for b in (2, 4, 8)])
def test_quant_pack_wide_rows_match_plain(cuda, dim, method, bits):
    from repro_torch.kernels.adaptive_quant import ops

    rows = 67
    x = _rows(rows, dim, cuda, seed=dim + bits)
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


@pytest.mark.parametrize("dim", WIDE_DIMS)
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_adaptive_quant_wide_rows_match_plain(cuda, dim, bits):
    from repro_torch.core.quantize import adaptive_quantize
    from repro_torch.kernels.adaptive_quant import ops

    x = _rows(67, dim, cuda, seed=dim * bits)
    before = ops.ADAPTIVE_QUANT_LAUNCHES.count
    got = ops.adaptive_quant(x, bits=bits, num_bins=25, ratio=0.5)
    assert ops.ADAPTIVE_QUANT_LAUNCHES.count == before + 1
    want = adaptive_quantize(x, bits, 25, 0.5)
    np.testing.assert_allclose(got.scale.cpu().numpy(), want.scale.cpu().numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.zero.cpu().numpy(), want.zero.cpu().numpy(),
                               rtol=1e-5, atol=1e-7)
    assert (got.codes != want.codes).float().mean().item() <= 2e-3


def test_wide_route_refuses_past_its_limit(cuda):
    from repro_torch.kernels.adaptive_quant import ops

    x = torch.zeros((2, ops.MAX_DIM + 1), device=cuda)
    with pytest.raises(ValueError, match="8192"):
        ops.quant_pack(x, bits=4)
    with pytest.raises(ValueError, match="8192"):
        ops.adaptive_quant(x, bits=4)
